"""The Section-6 baselines: GT-DSGD and D-SGD.

Counterpart of ``repro.core.baselines``.

* GT-DSGD: INTERACT's consensus and tracking skeleton on plain
  minibatch estimates (no variance reduction, no refresh).
* D-SGD: no tracking; each agent descends its own minibatch
  hypergradient after one consensus mix, so it communicates once a step
  (the x stream only; its wire state has no u).

Both take each step's random draws as a ``Draws`` tuple (see
``repro_torch.core.svr_interact``).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch
from torch.func import vmap
from torch.utils import _pytree as pytree

from repro_torch.consensus.compress import CompressionConfig, init_ef
from repro_torch.consensus.engine import (ConsensusEngine,
                                          consensus_descent_and_track)
from repro_torch.core.bilevel import AgentData, BilevelProblem
from repro_torch.core.svr_interact import (Draws, broadcast_agents,
                                           minibatch_grads)
from repro_torch.hypergrad import HypergradConfig

__all__ = ["DsgdState", "GtDsgdState", "dsgd_step", "gt_dsgd_step",
           "init_dsgd_state", "init_gt_dsgd_state"]


class GtDsgdState(NamedTuple):
    x: object
    y: object
    u: object
    v: object
    p_prev: object
    t: int
    ef: object = None  # wire state {"x", "u"} (compressed wire with EF)
    guard: object = None  # guard counters {"last_good", "tripped"}


def init_gt_dsgd_state(problem: BilevelProblem, hg_cfg: HypergradConfig,
                       x0, y0, data: AgentData, draws: Draws,
                       compression: CompressionConfig | None = None,
                       guard: dict | None = None) -> GtDsgdState:
    """u_0 = p_0 and v_0 on the minibatch of ``draws``; ``compression``
    adds the x and u wire state (``init_ef``), ``guard`` the guard's
    counters."""
    m = data.inner_x.shape[0]
    x, y = broadcast_agents(x0, m), broadcast_agents(y0, m)
    p, v = vmap(partial(minibatch_grads, problem, hg_cfg))(x, y, data, draws)
    return GtDsgdState(x=x, y=y, u=p, v=v,
                       p_prev=pytree.tree_map(torch.clone, p), t=0,
                       ef=init_ef(compression, x=x, u=p), guard=guard)


def gt_dsgd_step(problem: BilevelProblem, hg_cfg: HypergradConfig,
                 engine: ConsensusEngine, alpha: float, beta: float,
                 state: GtDsgdState, data: AgentData,
                 draws: Draws) -> GtDsgdState:
    """One GT-DSGD iteration over all agents."""

    def grads_fn(x_new, y_new):
        p, v = vmap(partial(minibatch_grads, problem, hg_cfg))(
            x_new, y_new, data, draws)
        return p, v, None

    x_new, y_new, u_new, v_new, p_new, ef_new, _ = (
        consensus_descent_and_track(
            engine, state.x, state.y, state.u, state.v, state.p_prev,
            alpha, beta, grads_fn, t=state.t, ef=state.ef))
    return GtDsgdState(x=x_new, y=y_new, u=u_new, v=v_new, p_prev=p_new,
                       t=state.t + 1, ef=ef_new, guard=state.guard)


class DsgdState(NamedTuple):
    x: object
    y: object
    t: int
    ef: object = None  # wire state {"x"} (compressed wire with EF)
    guard: object = None  # guard counters {"last_good", "tripped"}


def init_dsgd_state(x0, y0, m: int,
                    compression: CompressionConfig | None = None,
                    guard: dict | None = None) -> DsgdState:
    x = broadcast_agents(x0, m)
    return DsgdState(x=x, y=broadcast_agents(y0, m), t=0,
                     ef=init_ef(compression, x=x), guard=guard)


def dsgd_step(problem: BilevelProblem, hg_cfg: HypergradConfig,
              engine: ConsensusEngine, alpha: float, beta: float,
              state: DsgdState, data: AgentData, draws: Draws) -> DsgdState:
    """One D-SGD iteration: x <- mix(x) - alpha p, y <- y - beta v, with
    (p, v) at the current iterate on the minibatch of ``draws``.

    The single mix always goes through ``engine.mix_ef`` (bitwise
    ``mix`` without wire options), so the wire, the round's topology
    matrix and an attached ledger see D-SGD's x stream too.
    """
    p, v = vmap(partial(minibatch_grads, problem, hg_cfg))(
        state.x, state.y, data, draws)
    ef_x = None if state.ef is None else state.ef["x"]
    x_mixed, ef_x = engine.mix_ef(state.x, ef_x, state.t)
    x_new = pytree.tree_map(lambda mx, g: mx - alpha * g, x_mixed, p)
    y_new = pytree.tree_map(lambda y, g: y - beta * g, state.y, v)
    return DsgdState(x=x_new, y=y_new, t=state.t + 1,
                     ef=None if state.ef is None else {"x": ef_x},
                     guard=state.guard)
