"""The Section-6 baselines: GT-DSGD and D-SGD.

Counterpart of ``repro.core.baselines`` on the full-precision consensus
path (the compressed wire is a later slice).

* GT-DSGD: INTERACT's consensus and tracking skeleton on plain
  minibatch estimates (no variance reduction, no refresh).
* D-SGD: no tracking; each agent descends its own minibatch
  hypergradient after one consensus mix, so it communicates once a step.

Both take each step's random draws as a ``Draws`` tuple (see
``repro_torch.core.svr_interact``).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch
from torch.func import vmap
from torch.utils import _pytree as pytree

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


def init_gt_dsgd_state(problem: BilevelProblem, hg_cfg: HypergradConfig,
                       x0, y0, data: AgentData, draws: Draws) -> GtDsgdState:
    """u_0 = p_0 and v_0 on the minibatch of ``draws``."""
    m = data.inner_x.shape[0]
    x, y = broadcast_agents(x0, m), broadcast_agents(y0, m)
    p, v = vmap(partial(minibatch_grads, problem, hg_cfg))(x, y, data, draws)
    return GtDsgdState(x=x, y=y, u=p, v=v,
                       p_prev=pytree.tree_map(torch.clone, p), t=0)


def gt_dsgd_step(problem: BilevelProblem, hg_cfg: HypergradConfig,
                 engine: ConsensusEngine, alpha: float, beta: float,
                 state: GtDsgdState, data: AgentData,
                 draws: Draws) -> GtDsgdState:
    """One GT-DSGD iteration over all agents."""

    def grads_fn(x_new, y_new):
        p, v = vmap(partial(minibatch_grads, problem, hg_cfg))(
            x_new, y_new, data, draws)
        return p, v, None

    x_new, y_new, u_new, v_new, p_new, _ = consensus_descent_and_track(
        engine, state.x, state.y, state.u, state.v, state.p_prev,
        alpha, beta, grads_fn)
    return GtDsgdState(x=x_new, y=y_new, u=u_new, v=v_new, p_prev=p_new,
                       t=state.t + 1)


class DsgdState(NamedTuple):
    x: object
    y: object
    t: int


def init_dsgd_state(x0, y0, m: int) -> DsgdState:
    return DsgdState(x=broadcast_agents(x0, m), y=broadcast_agents(y0, m),
                     t=0)


def dsgd_step(problem: BilevelProblem, hg_cfg: HypergradConfig,
              engine: ConsensusEngine, alpha: float, beta: float,
              state: DsgdState, data: AgentData, draws: Draws) -> DsgdState:
    """One D-SGD iteration: x <- mix(x) - alpha p, y <- y - beta v, with
    (p, v) at the current iterate on the minibatch of ``draws``."""
    p, v = vmap(partial(minibatch_grads, problem, hg_cfg))(
        state.x, state.y, data, draws)
    x_mixed = engine.mix(state.x)
    x_new = pytree.tree_map(lambda mx, g: mx - alpha * g, x_mixed, p)
    y_new = pytree.tree_map(lambda y, g: y - beta * g, state.y, v)
    return DsgdState(x=x_new, y=y_new, t=state.t + 1)
