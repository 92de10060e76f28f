"""Seeded fault registry for the chaos harness.

Counterpart of ``repro.resilience.faults``.  Faults are small objects
registered under a string kind with ``@register_fault`` and made with
``make_fault(kind, ...)``; a ``FaultPlan`` bundles several of them with
a seed and is the hooks object the resumable runner calls:

* ``on_chunk_end(start, end, state, total)``: may return a changed state
  (a NaN/Inf payload) or raise ``SimulatedKill`` (a process kill).
* ``on_write_attempt(step, attempt)``: may raise ``OSError`` (a transient
  write failure, absorbed by the snapshot's retries and backoff).
* ``on_saved(step, ckpt_dir)``: may damage what just landed on disk
  (truncate, overwrite with garbage or delete the newest checkpoint).

Each fault fires once per plan lifetime (``fired``), so a killed and
resumed run replays the lost chunk clean.  ``plan.reset()`` re-arms a
plan, and every firing is appended to ``plan.events`` for the chaos
report.  The garbage bytes come from a per-plan
``np.random.default_rng(seed)``: the same plan does the same damage, in
this package and in the JAX package.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np

from repro_torch.checkpoint.checkpoint import (_flatten_with_paths,
                                               _step_path, _unflatten)
from repro_torch.resilience.runner import SimulatedKill
from repro_torch.resilience.snapshot import snapshot_meta_path

__all__ = ["Fault", "FaultPlan", "available_faults", "make_fault",
           "register_fault"]

_FAULTS: dict[str, type] = {}


def register_fault(kind: str) -> Callable[[type], type]:
    """Class decorator: register a Fault implementation under ``kind``."""

    def deco(cls: type) -> type:
        existing = _FAULTS.get(kind)
        if existing is not None and existing is not cls:
            raise ValueError(f"fault {kind!r} already registered "
                             f"({existing.__name__})")
        _FAULTS[kind] = cls
        cls.kind = kind
        return cls

    return deco


def available_faults() -> tuple[str, ...]:
    return tuple(sorted(_FAULTS))


def make_fault(kind: str, **kwargs) -> "Fault":
    try:
        cls = _FAULTS[kind]
    except KeyError:
        raise ValueError(f"unknown fault {kind!r}; choose from "
                         f"{available_faults()}") from None
    return cls(**kwargs)


class Fault:
    """Base fault: a schedule (``step``), one-shot arming, no-op hooks."""

    kind: str | None = None

    def __init__(self, step: int = 0):
        self.step = int(step)
        self.fired = False

    def reset(self) -> None:
        self.fired = False

    # the hooks (the plan passes itself, for logging and its rng)
    def on_chunk_end(self, plan, start, end, state, total):
        return None

    def on_write_attempt(self, plan, step, attempt):
        return None

    def on_saved(self, plan, step, ckpt_dir):
        return None


class FaultPlan:
    """An ordered bundle of faults and a seed: the runner's hooks."""

    def __init__(self, faults=(), seed: int = 0):
        self.faults = list(faults)
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.events: list[dict[str, Any]] = []

    def reset(self) -> None:
        """Re-arm every fault and clear the event log (rng re-seeded)."""
        self.rng = np.random.default_rng(self.seed)
        self.events.clear()
        for f in self.faults:
            f.reset()

    def log(self, kind: str, **info) -> None:
        self.events.append({"kind": kind, **info})

    def count(self, kind: str) -> int:
        return sum(1 for e in self.events if e["kind"] == kind)

    # -- the runner's hooks --------------------------------------------------
    def on_chunk_end(self, start, end, state, total):
        for f in self.faults:
            mutated = f.on_chunk_end(self, start, end, state, total)
            if mutated is not None:
                state = mutated
        return state

    def on_write_attempt(self, step, attempt):
        for f in self.faults:
            f.on_write_attempt(self, step, attempt)

    def on_saved(self, step, ckpt_dir):
        for f in self.faults:
            f.on_saved(self, step, ckpt_dir)


@register_fault("kill")
class KillFault(Fault):
    """Kill the process once step ``step`` has been reached: raised at
    the first chunk boundary past it, before that boundary's snapshot
    lands, so the whole chunk is lost."""

    def on_chunk_end(self, plan, start, end, state, total):
        if not self.fired and self.step <= end:
            self.fired = True
            plan.log("kill", at=end, scheduled=self.step)
            raise SimulatedKill(end)
        return None


@register_fault("nan-payload")
class NanPayloadFault(Fault):
    """Poison the outer iterate with NaN/Inf once ``step`` is reached, as
    a corrupted wire payload that slipped past the guards would: the
    first ``count`` entries of the field's first leaf (dict keys sorted,
    as the JAX package orders them), written on a host copy.  The runner
    loads the poisoned state into its stepper and its finiteness check
    catches it before the snapshot."""

    def __init__(self, step: int = 0, value: float = float("nan"),
                 field: str = "x", count: int = 3):
        super().__init__(step)
        self.value = float(value)
        self.field = field
        self.count = int(count)

    def on_chunk_end(self, plan, start, end, state, total):
        if self.fired or self.step > end:
            return None
        self.fired = True
        tree = getattr(state, self.field)
        leaves = _flatten_with_paths(tree)[1]
        poisoned = leaves[0].detach().cpu().clone()
        poisoned.view(-1)[:min(self.count, poisoned.numel())] = self.value
        leaves[0] = poisoned.to(leaves[0].device)
        plan.log("nan-payload", at=end, field=self.field, value=self.value)
        return state._replace(**{self.field: _unflatten(tree, leaves)})


@register_fault("corrupt-checkpoint")
class CorruptCheckpointFault(Fault):
    """Damage the checkpoint that just landed: ``mode='truncate'`` keeps
    the first third of the file (a mid-write kill without the atomic
    replace); ``mode='garbage'`` overwrites 64 bytes in the middle
    (bit-rot, caught by the per-leaf CRC32).  Resume falls back to the
    previous snapshot."""

    def __init__(self, step: int = 0, mode: str = "garbage"):
        super().__init__(step)
        if mode not in ("garbage", "truncate"):
            raise ValueError(f"unknown corruption mode {mode!r}")
        self.mode = mode

    def on_saved(self, plan, step, ckpt_dir):
        if self.fired or step < self.step:
            return
        self.fired = True
        path = _step_path(ckpt_dir, step)
        size = path.stat().st_size
        with open(path, "r+b") as fh:
            if self.mode == "truncate":
                fh.truncate(max(1, size // 3))
            else:
                fh.seek(size // 2)
                fh.write(plan.rng.bytes(min(64, max(1, size // 4))))
        plan.log("corrupt-checkpoint", at=step, mode=self.mode)


@register_fault("stale-checkpoint")
class StaleCheckpointFault(Fault):
    """Delete the checkpoint that just landed (archive and sidecar): the
    directory ends at an older snapshot, as if the newest save never
    happened, and resume replays the gap."""

    def on_saved(self, plan, step, ckpt_dir):
        if self.fired or step < self.step:
            return
        self.fired = True
        _step_path(ckpt_dir, step).unlink(missing_ok=True)
        snapshot_meta_path(ckpt_dir, step).unlink(missing_ok=True)
        plan.log("stale-checkpoint", at=step)


@register_fault("write-failure")
class WriteFailureFault(Fault):
    """A transient filesystem failure: the first ``count`` snapshot write
    attempts at or after ``step`` raise ``OSError``.  Below the snapshot's
    retry budget the run sees only the backoff sleeps; the firings are
    logged for the chaos report."""

    def __init__(self, step: int = 0, count: int = 2):
        super().__init__(step)
        self.count = int(count)
        self.remaining = int(count)

    def reset(self) -> None:
        super().reset()
        self.remaining = self.count

    def on_write_attempt(self, plan, step, attempt):
        if step >= self.step and self.remaining > 0:
            self.remaining -= 1
            self.fired = True
            plan.log("write-failure", at=step, attempt=attempt)
            raise OSError("injected transient write failure")
