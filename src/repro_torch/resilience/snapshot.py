"""Bitwise solver snapshots: the complete solver state, on disk.

Counterpart of ``repro.resilience.snapshot``.  A snapshot is everything
a resumed run needs to reproduce the uninterrupted trajectory bit for
bit:

* the solver state: iterates ``x``/``y``, tracked gradients ``u``/``v``,
  ``p_prev``, the SVR anchors ``x_prev``/``y_prev``, the wire state
  ``ef = {stream: {e, ref}}``, the guard counters and the step counter
  ``t`` (a Python int in the port, saved as a 0-dim int64).  The step
  counter is also the position of the topology stream and of the attack
  schedule: both are numpy draws over (seed, t), so they need no record.
* the state of the stochastic solvers' host generator (``rng``: the
  ``Sampler``'s ``torch.Generator``), which the reference keeps in its
  state's key.  ``resume`` restores it after ``init`` has taken its first
  draw.
* the partial metric column of a traced run (``padded``), so the
  stitched trace equals the unchunked ``run_traced`` trace bit for bit.
* a sidecar JSON with the run geometry (total steps, record cadence) and
  a fingerprint of the ``SolverConfig``, so resuming against another
  config fails loudly.

Saves go through ``repro_torch.checkpoint`` (atomic replace, per-leaf
CRC32) and retry transient write failures with exponential backoff.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import tempfile
import time
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import (CorruptCheckpointError, restore_pytree,
                                    save_step)
from repro_torch.checkpoint.checkpoint import (_all_steps, _flatten_with_paths,
                                               _host_array, _step_path)

__all__ = ["Resumed", "config_fingerprint", "resume", "snapshot",
           "snapshot_meta_path", "tree_fingerprint", "write_json_atomic"]

META_FORMAT = 1


def config_fingerprint(config) -> str:
    """Stable hex fingerprint of everything that shapes the trajectory:
    ``static_key()`` (algorithm, network, backend, hypergradient, wire,
    Byzantine layer, guard) and ``batch_values()`` (seed, alpha, beta)."""
    key = repr((type(config).__name__, config.static_key(),
                config.batch_values()))
    return hashlib.sha256(key.encode()).hexdigest()[:16]


def snapshot_meta_path(ckpt_dir, step: int) -> pathlib.Path:
    return pathlib.Path(ckpt_dir) / f"step_{step:08d}.json"


def tree_fingerprint(tree) -> str:
    """Content hash of a tree's leaves (dtype, shape and bytes, dict keys
    sorted), which pins a sweep's cached groups to the data and initial
    points they were computed on."""
    h = hashlib.sha256()
    for leaf in _flatten_with_paths(tree)[1]:
        arr = _host_array(leaf)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:16]


def write_json_atomic(path: pathlib.Path, obj: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(obj, fh)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _generator(solver) -> torch.Generator | None:
    """The stochastic solver's host generator (``None`` without one)."""
    return getattr(getattr(solver, "_sampler", None), "generator", None)


def snapshot(solver, state, step: int, ckpt_dir, *, padded=None,
             total_steps: int | None = None, record_every: int = 0,
             retries: int = 3, backoff: float = 0.02,
             on_write_attempt=None) -> pathlib.Path:
    """Persist the solver state (and partial trace) at global ``step``.

    The generator's state is read here, so a caller snapshots at the step
    its draws have reached.  Retries ``OSError`` with exponential backoff
    (``backoff * 2**k`` seconds), the chaos harness's ``write-failure``
    included (``on_write_attempt(step, attempt)``); a write that still
    fails after the last attempt raises.
    """
    payload: dict[str, Any] = {"state": state}
    if padded is not None:
        payload["padded"] = np.asarray(padded)
    gen = _generator(solver)
    if gen is not None:
        payload["rng"] = gen.get_state()
    meta = {
        "format": META_FORMAT,
        "algo": solver.config.algo,
        "config_fp": config_fingerprint(solver.config),
        "step": int(step),
        "total_steps": None if total_steps is None else int(total_steps),
        "record_every": int(record_every),
        "has_padded": padded is not None,
        "padded_dtype": (None if padded is None
                         else str(np.asarray(padded).dtype)),
        "has_rng": gen is not None,
    }
    last_exc: OSError | None = None
    for attempt in range(retries + 1):
        try:
            if on_write_attempt is not None:
                on_write_attempt(int(step), attempt)
            save_step(ckpt_dir, int(step), payload)
            write_json_atomic(snapshot_meta_path(ckpt_dir, int(step)), meta)
            return _step_path(ckpt_dir, int(step))
        except OSError as exc:
            last_exc = exc
            if attempt < retries:
                time.sleep(backoff * (2 ** attempt))
    raise last_exc


@dataclasses.dataclass
class Resumed:
    """What ``resume`` hands back: a freshly built solver positioned at
    the snapshot (its generator restored)."""

    solver: Any
    state: Any
    step: int                      # global step the state sits at
    padded: np.ndarray | None      # partial metric column (traced runs)
    total_steps: int | None        # run geometry recorded at save time
    record_every: int
    meta: dict


def _read_meta(ckpt_dir, step: int) -> dict | None:
    try:
        with open(snapshot_meta_path(ckpt_dir, step)) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def resume(config, ckpt_dir, *, problem=None, hg_cfg=None, x0=None,
           y0=None, data=None, num_agents: int = 5,
           n_per_agent: int = 600, max_step: int | None = None,
           strict: bool = True,
           device: torch.device | str | None = None) -> Resumed | None:
    """Rebuild the solver for ``config`` and restore its newest valid
    snapshot from ``ckpt_dir`` (``None`` when no snapshot restores).

    Walks the steps newest first and skips anything broken (a missing or
    unparseable sidecar, a truncated archive, a CRC failure).  A snapshot
    whose config fingerprint differs from ``config``'s raises under
    ``strict`` and is skipped otherwise.  The problem instance defaults
    to the Section-6 setup as ``solve`` makes it (``setup_for``); a
    resume must be given the original run's problem and data.
    """
    from repro_torch.solvers.api import make_solver, setup_for

    steps = _all_steps(ckpt_dir)
    if max_step is not None:
        steps = [s for s in steps if s <= max_step]
    if not steps:
        return None

    problem, x0, y0, data = setup_for(config, problem, x0, y0, data,
                                      num_agents=num_agents,
                                      n_per_agent=n_per_agent, device=device)
    solver = make_solver(config)
    template = solver.init(problem, hg_cfg, x0, y0, data)
    gen = _generator(solver)
    fp = config_fingerprint(config)

    for step in reversed(steps):
        meta = _read_meta(ckpt_dir, step)
        if meta is None:
            continue
        if meta.get("config_fp") != fp:
            if strict:
                raise ValueError(
                    f"snapshot at step {step} in {ckpt_dir} belongs to a "
                    f"different config (fingerprint "
                    f"{meta.get('config_fp')!r} != {fp!r}); refusing to "
                    f"resume a different experiment (strict=False skips)")
            continue
        like: dict[str, Any] = {"state": template}
        if meta.get("has_padded"):
            like["padded"] = np.full(
                (int(meta["total_steps"]),), np.nan,
                np.dtype(meta["padded_dtype"]))
        if gen is not None:
            like["rng"] = gen.get_state()
        try:
            payload = restore_pytree(_step_path(ckpt_dir, step), like)
        except (CorruptCheckpointError, OSError):
            continue
        if gen is not None:
            gen.set_state(payload["rng"])
        return Resumed(solver=solver, state=payload["state"],
                       step=int(meta["step"]),
                       padded=payload.get("padded"),
                       total_steps=meta.get("total_steps"),
                       record_every=int(meta.get("record_every", 0)),
                       meta=meta)
    return None
