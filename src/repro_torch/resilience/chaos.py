"""``chaos_run``: survive a seeded fault plan with no intervention.

Counterpart of ``repro.resilience.chaos``.  The harness loops
``resume_run`` under a ``FaultPlan`` until the run reaches its final
step, treating every injected failure as an operations event:

* ``SimulatedKill``: the process died; build the solver anew from the
  config (a fresh process: new graphs on the card) and resume from the
  newest valid snapshot.
* ``NonFiniteStateError``: a poisoned chunk was caught before its
  snapshot landed; resume from the last clean boundary and replay.
* ``GuardTripFault``: the divergence guard fired inside a chunk; roll
  back to the previous checkpoint and retry, at most
  ``max_guard_retries`` times a boundary.  A persistent adversary trips
  again on the deterministic replay, and then the guard's in-step
  containment is accepted and the run moves on.

Every restart goes through ``resume`` (the newest valid snapshot,
corrupt and deleted files skipped), so the loop also absorbs the on-disk
faults.  The final trace equals the uninterrupted ``run_traced`` trace
bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import latest_step
from repro_torch.resilience.faults import FaultPlan
from repro_torch.resilience.runner import (GuardTripFault, NonFiniteStateError,
                                           SimulatedKill, resume_run)

__all__ = ["ChaosReport", "chaos_run"]


@dataclasses.dataclass
class ChaosReport:
    """What a chaos campaign produced."""

    completed: bool                 # reached the final step
    restarts: int                   # recovery cycles (any fault kind)
    kills: int                      # SimulatedKill firings survived
    nonfinite_faults: int           # poisoned chunks caught and replayed
    guard_rollbacks: int            # GuardTripFault checkpoint rollbacks
    guard_accepted: int             # boundaries where the in-step
                                    # containment was accepted
    write_retries: int              # injected OSErrors absorbed by backoff
    wasted_steps: int               # replayed work across all restarts
    wall_time_s: float
    trace: np.ndarray | None        # run_traced-layout metric trace
    final_metric: float | None
    tripped_steps: int              # guard counters of the final state
    last_good_step: int
    state: Any = None
    events: list = dataclasses.field(default_factory=list)


def chaos_run(config, plan: FaultPlan, num_steps: int,
              record_every: int = 0, *, checkpoint_every: int, ckpt_dir,
              metric_fn=None, problem=None, hg_cfg=None, x0=None,
              y0=None, data=None, num_agents: int = 5,
              n_per_agent: int = 600, max_restarts: int = 20,
              max_guard_retries: int = 2, retries: int = 3,
              backoff: float = 0.02, scan: bool = True,
              device: torch.device | str | None = None) -> ChaosReport:
    """Drive ``config`` through ``num_steps`` while ``plan`` injects
    faults; recover until the run completes (or ``max_restarts``).

    Defaults follow ``solve``: no problem given runs the Section-6
    instance on ``device`` (the card by default), and ``record_every >
    0`` without a ``metric_fn`` records the eq.-11 metric.  Each restart
    builds the solver anew from the config and resumes from the newest
    snapshot that restores.  ``scan`` picks the stepper (CUDA graphs on
    the card, or the eager loop).
    """
    from repro_torch.solvers.api import setup_for

    problem, x0, y0, data = setup_for(config, problem, x0, y0, data,
                                      num_agents=num_agents,
                                      n_per_agent=n_per_agent, device=device)
    device = data.inner_x.device
    if metric_fn is None and record_every:
        from repro_torch.core.metrics import convergence_metric_fn
        metric_fn = convergence_metric_fn(
            problem, hg_cfg if hg_cfg is not None else config.hypergrad,
            data)

    guard_active = config.guard.active
    guard_retries: dict[int, int] = {}
    ignore_below = -1
    restarts = kills = nonfinite = rollbacks = accepted = wasted = 0
    completed = False
    solver = state = trace = None
    t0 = time.perf_counter()

    while True:
        start = latest_step(ckpt_dir) or 0
        try:
            solver, state, trace = resume_run(
                config, ckpt_dir, num_steps, record_every, metric_fn,
                checkpoint_every=checkpoint_every, problem=problem,
                hg_cfg=hg_cfg, x0=x0, y0=y0, data=data, hooks=plan,
                raise_on_guard_trip=guard_active,
                guard_ignore_below=ignore_below, retries=retries,
                backoff=backoff, scan=scan, device=device)
            completed = True
            break
        except SimulatedKill as exc:
            kills += 1
            wasted += exc.step - start
            plan.log("recover", after="kill", lost=exc.step - start)
        except NonFiniteStateError as exc:
            nonfinite += 1
            wasted += exc.step - start
            plan.log("recover", after="non-finite", lost=exc.step - start)
        except GuardTripFault as exc:
            rollbacks += 1
            wasted += exc.step - start
            n_tries = guard_retries.get(exc.step, 0) + 1
            guard_retries[exc.step] = n_tries
            if n_tries >= max_guard_retries:
                # the deterministic replay trips a persistent adversary
                # again: accept the guard's containment and move on
                accepted += 1
                ignore_below = exc.step
            plan.log("recover", after="guard-trip", boundary=exc.step,
                     attempt=n_tries, accepted=n_tries >= max_guard_retries)
        restarts += 1
        if restarts > max_restarts:
            break

    wall = time.perf_counter() - t0
    guard = getattr(state, "guard", None) if state is not None else None
    final = None
    if trace is not None and np.size(trace):
        final = float(np.asarray(trace)[-1])
    return ChaosReport(
        completed=completed, restarts=restarts, kills=kills,
        nonfinite_faults=nonfinite, guard_rollbacks=rollbacks,
        guard_accepted=accepted, write_retries=plan.count("write-failure"),
        wasted_steps=int(wasted), wall_time_s=wall,
        trace=None if trace is None else np.asarray(trace),
        final_metric=final,
        tripped_steps=0 if guard is None else int(guard["tripped"]),
        last_good_step=-1 if guard is None else int(guard["last_good"]),
        state=state, events=list(plan.events))
