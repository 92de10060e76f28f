"""Divergence guards: trip-wires and rollback on every step.

Counterpart of ``repro.byzantine.guards``.  The guard wraps a solver's
step ``step(state, data, draws)``.  Detection and rollback are
``torch.where`` on the device: no host read, so a guarded step is
captured in one CUDA graph like any other, and a guarded run with
nothing tripped is the unguarded trajectory plus two integer counters.

The counters ride the state's trailing ``guard`` field (``None`` when
the guard is off, so unguarded states keep their structure): a dict
``{"last_good", "tripped"}`` of 0-dim int32 tensors, keys sorted as the
JAX package's pytrees order them.

The trap: ``last_good`` is set from the step counter, which is a host
int in the port.  A graph would bake the value it saw at capture into
every replay, so the step reads a 0-dim int32 device ``counter`` instead,
which the stepper fills with the incoming t before each eager step and
each replay (``SolverBase.load_step``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = ["guard_param_step", "init_guard"]

# state fields the rollback must NOT rewind: the step counter keeps
# advancing (and with it the host sampler, as the reference's key does),
# and the guard counters are updated separately
_NEVER_ROLLED = ("t", "guard")


def init_guard(cfg, device: torch.device | str = "cpu") -> dict | None:
    """The guard counters of a fresh state on ``device``, both 0, or
    ``None`` when the config is inactive."""
    if cfg is None or not cfg.active:
        return None
    zero = lambda: torch.zeros((), dtype=torch.int32, device=device)
    return {"last_good": zero(), "tripped": zero()}


def _tripped(cfg, state) -> torch.Tensor:
    """0-dim bool: does the candidate state trip any wire?"""
    checks = []
    if cfg.nan:
        for leaf in pytree.tree_leaves((state.x, state.y)):
            checks.append(~torch.all(torch.isfinite(leaf)))
    if cfg.max_norm > 0.0:
        sq = sum(torch.sum(torch.square(leaf.to(torch.float32)))
                 for leaf in pytree.tree_leaves(state.x))
        checks.append(sq > float(np.float32(cfg.max_norm) ** 2))
    bad = checks[0]
    for check in checks[1:]:
        bad = bad | check
    return bad


def guard_param_step(step, cfg, counter: torch.Tensor):
    """Wrap ``step(state, data, draws, *params)`` with the guard (a
    parameterised step takes ``alpha`` and ``beta`` after the draws).

    A tripped step rolls every field but ``t`` and ``guard`` back to the
    incoming state (the last good one, by induction), the wire state
    ``ef`` included; ``tripped`` counts the trips and ``last_good`` holds
    the step counter of the last accepted state.  ``counter`` is the
    0-dim int32 device tensor the caller fills with the incoming state's
    t before each step; a sweep group's experiments share one, as they
    share t, and each rolls back by its own ``torch.where``.
    """

    def guarded(state, data, draws=None, *params):
        new = step(state, data, draws, *params)
        if getattr(new, "guard", None) is None:
            raise ValueError(
                "GuardConfig is active but the solver state carries no "
                "guard counters; initialize with guard=init_guard(cfg) "
                "(the registry solvers do this from SolverConfig.guard)")
        bad = _tripped(cfg, new)
        rolled = {
            field: pytree.tree_map(
                lambda old, cand: None if cand is None
                else torch.where(bad, old, cand),
                getattr(state, field), getattr(new, field))
            for field in new._fields if field not in _NEVER_ROLLED
        }
        guard = {"last_good": torch.where(bad, new.guard["last_good"],
                                          counter + 1),
                 "tripped": new.guard["tripped"] + bad.to(torch.int32)}
        return new._replace(guard=guard, **rolled)

    return guarded
