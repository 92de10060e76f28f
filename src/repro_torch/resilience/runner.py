"""The resumable runner: checkpoint-chunked runs, bitwise-equal traces.

Counterpart of ``repro.resilience.runner``.  The reference cuts one
jitted scan into chunks; the port cuts a run of steps.  ``run_resumable``
keeps one stepper for the whole run (``SolverBase.stepper_for``: a
``GraphStepper`` replaying CUDA graphs with ``scan=True`` on the card,
else the eager loop), advances it one chunk at a time between global
multiples of ``checkpoint_every``, and snapshots the complete state
after each chunk.  The metric is recorded before every global multiple
of ``record_every`` whatever the chunking, into a (total,) column laid
out as the reference's, so a chunked run and an unchunked one, or a run
killed and resumed and one never interrupted, give the same trace bit
for bit.

Draws.  A stepper draws a stochastic solver's minibatches for the steps
it advances, from the solver's host generator; advancing one chunk at a
time leaves the generator at the boundary's step when the snapshot reads
it, and a step's draws do not depend on how many are drawn at once.

Order at a boundary (the reference's): the state is read from the
stepper (on the card a copy of the graphs' static buffers, between
replays), the fault hooks run (``on_chunk_end`` may return a changed
state, which is loaded back into the stepper, or raise
``SimulatedKill``), then the finiteness check, then the guard-trip
check, then the snapshot (``on_write_attempt`` around each write
attempt), then ``on_saved``.  A poisoned or freshly tripped chunk never
lands in the checkpoint directory.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.resilience.snapshot import Resumed, resume, snapshot

__all__ = ["GuardTripFault", "NonFiniteStateError", "SimulatedKill",
           "resume_run", "run_resumable"]


class SimulatedKill(RuntimeError):
    """The chaos harness's process kill: raised at a chunk boundary
    before the snapshot lands, so everything since the previous
    checkpoint is lost, as a SIGKILL loses it."""

    def __init__(self, step: int):
        super().__init__(f"simulated process kill at step {step}")
        self.step = step


class NonFiniteStateError(RuntimeError):
    """The state went NaN/Inf during a chunk.  Raised before the
    snapshot, so the checkpoint directory holds finite states only."""

    def __init__(self, step: int):
        super().__init__(f"non-finite solver state at step {step}")
        self.step = step


class GuardTripFault(RuntimeError):
    """The divergence guard tripped during this chunk: a resumable fault,
    so checkpoint rollback and guard rollback share one recovery path
    (``chaos_run`` retries the chunk a bounded number of times, then
    accepts the guard's in-step containment)."""

    def __init__(self, step: int, trips: int):
        super().__init__(f"divergence guard tripped {trips}x in the chunk "
                         f"ending at step {step}")
        self.step = step
        self.trips = trips


def _state_is_finite(state) -> bool:
    """Every floating leaf finite (one host read)."""
    checks = [torch.isfinite(leaf).all() for leaf in pytree.tree_leaves(state)
              if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]
    return bool(torch.stack(checks).all()) if checks else True


def _guard_trips(state) -> int | None:
    """The guard's trip counter, read on the host (``None`` without a
    guard)."""
    guard = getattr(state, "guard", None)
    if guard is None:
        return None
    return int(guard["tripped"])


def _host(value) -> np.ndarray:
    return torch.as_tensor(value).detach().cpu().numpy()


def run_resumable(solver, state, data, num_steps: int,
                  record_every: int = 0, metric_fn=None, *,
                  checkpoint_every: int, ckpt_dir,
                  start_step: int | None = None, padded=None,
                  hooks=None, raise_on_guard_trip: bool = False,
                  guard_ignore_below: int = -1, retries: int = 3,
                  backoff: float = 0.02, scan: bool = True):
    """Advance ``num_steps`` from ``state``, snapshotting every
    ``checkpoint_every`` steps into ``ckpt_dir``.

    ``start_step`` is the global step the incoming state sits at (by
    default ``state.t``); chunk boundaries land on global multiples of
    ``checkpoint_every``, so a resumed run keeps the original run's
    boundaries.  ``padded`` is the full-length metric column assembled
    across resumes (``resume`` restores it); ``None`` starts a NaN one.
    ``scan`` picks the stepper as ``run_recorded`` does: CUDA graph
    replays on the card, the eager loop with ``scan=False`` or on the CPU.

    Returns ``(state, trace, padded)`` with ``trace`` laid out as
    ``run_traced``'s (the metric before steps ``0, record_every, ...``,
    then after the last step) as a numpy array, empty without a
    ``metric_fn``.  It equals the unchunked ``run_traced`` trace bit for
    bit when this runner produced the whole column from step 0, across
    kills and resumes.
    """
    if ckpt_dir is None:
        raise ValueError("checkpointed runs need ckpt_dir")
    if checkpoint_every <= 0:
        raise ValueError("checkpoint_every must be positive")
    if solver._step_fn is None:
        raise RuntimeError("call init()/build() before run_resumable()")

    start = int(state.t if start_step is None else start_step)
    total = start + int(num_steps)
    record_mod = int(record_every) if record_every else total
    stepper = solver.stepper_for(state, data, scan=scan)
    stepper.prepare(num_steps)
    record = None if metric_fn is None else stepper.record(metric_fn)
    if record is not None and padded is not None:
        padded = np.array(padded)
        if padded.shape != (total,):
            raise ValueError(f"padded column has shape {padded.shape}, run "
                             f"geometry needs ({total},)")

    def record_at(pos: int) -> None:
        nonlocal padded
        value = _host(record())
        if padded is None:
            padded = np.full((total,), np.nan, value.dtype)
        padded[pos] = value

    def column() -> np.ndarray:
        """The metric column (a resumed run with no record step yet
        evaluates the metric once for its dtype)."""
        nonlocal padded
        if padded is None:
            padded = np.full((total,), np.nan, _host(record()).dtype)
        return padded

    on_write = getattr(hooks, "on_write_attempt", None)
    trips_at_ckpt = _guard_trips(state)
    cur = start
    while cur < total:
        end = min(total, (cur // checkpoint_every + 1) * checkpoint_every)
        pos = cur
        while pos < end:
            if record is not None and pos % record_mod == 0:
                record_at(pos)
            nxt = min(end, (pos // record_mod + 1) * record_mod)
            stepper.advance(nxt - pos)
            pos = nxt
        state = stepper.state()
        if hooks is not None:
            mutated = hooks.on_chunk_end(cur, end, state, total)
            if mutated is not None and mutated is not state:
                state = mutated
                stepper.load(state)
        cur = end
        # validate BEFORE snapshotting: a poisoned or freshly tripped
        # chunk must never land in the checkpoint directory
        if not _state_is_finite(state):
            raise NonFiniteStateError(cur)
        trips = _guard_trips(state)
        if raise_on_guard_trip and trips is not None \
                and trips > trips_at_ckpt and cur > guard_ignore_below:
            raise GuardTripFault(cur, trips - trips_at_ckpt)
        snapshot(solver, state, cur, ckpt_dir,
                 padded=None if record is None else column(),
                 total_steps=total, record_every=record_every,
                 retries=retries, backoff=backoff, on_write_attempt=on_write)
        trips_at_ckpt = trips
        if hooks is not None:
            hooks.on_saved(cur, ckpt_dir)

    if record is None:
        return state, np.zeros((0,), np.float32), padded
    final = _host(record())
    padded = column()
    trace = np.concatenate([padded[::record_mod],
                            final.reshape(1).astype(padded.dtype)])
    return state, trace, padded


def resume_run(config, ckpt_dir, num_steps: int | None = None,
               record_every: int | None = None, metric_fn=None, *,
               checkpoint_every: int, problem=None, hg_cfg=None,
               x0=None, y0=None, data=None, num_agents: int = 5,
               n_per_agent: int = 600, hooks=None,
               raise_on_guard_trip: bool = False,
               guard_ignore_below: int = -1, max_step: int | None = None,
               retries: int = 3, backoff: float = 0.02, scan: bool = True,
               device: torch.device | str | None = None):
    """Finish (or start) a checkpointed run of ``config``.

    Restores the newest valid snapshot in ``ckpt_dir`` (``resume``: past
    corrupt, truncated or deleted files) in a freshly built solver and
    drives ``run_resumable`` to the run's recorded ``total_steps``; or
    from step 0 when nothing restores, where ``num_steps`` (the run's
    total length) is required.  ``num_steps`` and ``record_every``, when
    given, override the snapshot's geometry.  The problem instance is
    ``setup_for``'s (the Section-6 instance on ``device`` by default).

    Returns ``(solver, state, trace)``; ``trace`` is laid out as
    ``run_traced``'s and equals the uninterrupted run's bit for bit.
    """
    from repro_torch.solvers.api import make_solver, setup_for

    problem, x0, y0, data = setup_for(config, problem, x0, y0, data,
                                      num_agents=num_agents,
                                      n_per_agent=n_per_agent, device=device)
    rs: Resumed | None = resume(config, ckpt_dir, problem=problem,
                                hg_cfg=hg_cfg, x0=x0, y0=y0, data=data,
                                max_step=max_step, device=device)
    if rs is None:
        if num_steps is None:
            raise ValueError("empty/unrestorable checkpoint dir and no "
                             "num_steps: nothing to resume, nothing to "
                             "start")
        solver = make_solver(config)
        state = solver.init(problem, hg_cfg, x0, y0, data)
        start, padded = 0, None
        total = int(num_steps)
        rec = int(record_every or 0)
    else:
        solver, state, start, padded = (rs.solver, rs.state, rs.step,
                                        rs.padded)
        total = int(num_steps if num_steps is not None else rs.total_steps)
        rec = int(record_every if record_every is not None
                  else rs.record_every)

    state, trace, _ = run_resumable(
        solver, state, data, total - start, rec, metric_fn,
        checkpoint_every=checkpoint_every, ckpt_dir=ckpt_dir,
        start_step=start, padded=padded, hooks=hooks,
        raise_on_guard_trip=raise_on_guard_trip,
        guard_ignore_below=guard_ignore_below, retries=retries,
        backoff=backoff, scan=scan)
    return solver, state, trace
