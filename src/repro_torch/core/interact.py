"""The INTERACT algorithm (Algorithm 1).

Counterpart of ``repro.core.interact``.  Per iteration each agent:

  Step 1 (consensus + descent):   x_i <- sum_j M_ij x_j - alpha u_i   (6)
                                  y_i <- y_i - beta v_i               (7)
  Step 2 (full local gradients):  p_i = grad_bar f_i(x_i, y_i)        (8)
                                  v_i = grad_y g_i(x_i, y_i)          (9)
  Step 3 (gradient tracking):     u_i <- sum_j M_ij u_j + p_i - p_i^- (10)

State leaves carry a leading agent dimension m; the per-agent gradients
run under ``torch.func.vmap``.  Steps 1 and 3 go through a
``ConsensusEngine`` via ``consensus_descent_and_track``.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch
from torch.func import grad, vmap
from torch.utils import _pytree as pytree

from repro_torch.consensus.compress import CompressionConfig, init_ef
from repro_torch.consensus.engine import (ConsensusEngine,
                                          consensus_descent_and_track)
from repro_torch.core.bilevel import AgentData, BilevelProblem
from repro_torch.hypergrad import HypergradConfig, hypergradient

__all__ = ["InteractState", "init_state", "interact_step",
           "theorem1_step_sizes"]


class InteractState(NamedTuple):
    x: object        # outer params, leaves (m, ...)
    y: object        # inner params, leaves (m, ...)
    u: object        # tracked global gradient estimate, like x
    v: object        # inner gradient, like y
    p_prev: object   # previous local hypergradient, like x
    t: int           # iteration counter
    ef: object = None  # wire state {"x", "u"} (compressed wire with EF)
    guard: object = None  # guard counters {"last_good", "tripped"}


def _per_agent_batch(data: AgentData):
    return (data.inner_x, data.inner_y), (data.outer_x, data.outer_y)


def _agent_gradients(problem: BilevelProblem, hg_cfg: HypergradConfig,
                     x, y, inner_batch, outer_batch):
    """(p_i, v_i) for a single agent (no leading agent dim here)."""
    p = hypergradient(problem.outer, problem.inner, x, y, hg_cfg,
                      f_args=(outer_batch,), g_args=(inner_batch,),
                      inner_hess_yy=problem.inner_hess_yy)
    v = grad(problem.inner, argnums=1)(x, y, inner_batch)
    return p, v


def _all_agent_gradients(problem, hg_cfg, x, y, data: AgentData):
    inner_b, outer_b = _per_agent_batch(data)
    return vmap(partial(_agent_gradients, problem, hg_cfg))(
        x, y, inner_b, outer_b)


def init_state(problem: BilevelProblem, hg_cfg: HypergradConfig,
               x0, y0, data: AgentData,
               compression: CompressionConfig | None = None,
               guard: dict | None = None) -> InteractState:
    """Algorithm-1 initialisation: u_0 = grad_bar f(x_0, y_0), v_0 = grad_y g.

    ``x0``/``y0`` are single-agent pytrees; every agent starts from the
    same point, so they are broadcast along the agent axis (as copies).
    ``compression`` adds the zero wire state of the x and u streams when
    it uses error feedback (``init_ef``); otherwise ``ef`` is ``None``.
    ``guard`` is the divergence guard's counters
    (``repro_torch.byzantine.init_guard``), ``None`` without a guard.
    """
    m = data.inner_x.shape[0]
    bcast = lambda tree: pytree.tree_map(
        lambda leaf: leaf.expand((m,) + tuple(leaf.shape)).clone(), tree)
    x, y = bcast(x0), bcast(y0)
    p, v = _all_agent_gradients(problem, hg_cfg, x, y, data)
    p_prev = pytree.tree_map(torch.clone, p)
    return InteractState(x=x, y=y, u=p, v=v, p_prev=p_prev, t=0,
                         ef=init_ef(compression, x=x, u=p), guard=guard)


def interact_step(problem: BilevelProblem, hg_cfg: HypergradConfig,
                  engine: ConsensusEngine, alpha: float, beta: float,
                  state: InteractState, data: AgentData) -> InteractState:
    """One INTERACT iteration over all agents."""

    def grads_fn(x_new, y_new):
        p_new, v_new = _all_agent_gradients(problem, hg_cfg, x_new, y_new,
                                            data)
        return p_new, v_new, None

    x_new, y_new, u_new, v_new, p_new, ef_new, _ = (
        consensus_descent_and_track(
            engine, state.x, state.y, state.u, state.v, state.p_prev,
            alpha, beta, grads_fn, t=state.t, ef=state.ef))
    return InteractState(x=x_new, y=y_new, u=u_new, v=v_new, p_prev=p_new,
                         t=state.t + 1, ef=ef_new, guard=state.guard)


def theorem1_step_sizes(mu_g: float, L_g: float, lam: float, m: int,
                        L_f: float | None = None,
                        safety: float = 1.0) -> tuple[float, float]:
    """Conservative (alpha, beta) satisfying the Theorem-1 bounds.

    The binding bounds from (mu_g, L_g, lam, m) with L_f defaulting to
    L_g; ``safety`` < 1 shrinks both.
    """
    L_f = L_f if L_f is not None else L_g
    L_y = (L_g / mu_g) ** 2
    L_l = (L_f + L_f * L_g / mu_g) ** 2
    L_K = max(L_f, L_g)

    beta = safety * min(
        3.0 * (mu_g + L_g) / (mu_g * L_g),
        1.0 / (mu_g + L_g),
    )
    r = beta * mu_g * L_g / (3.0 * (mu_g + L_g))
    one_minus = max(1.0 - lam, 1e-3)
    alpha = safety * min(
        1.0 / (4.0 * L_l),
        1.0 / (2.0 * m),
        1.0 / (m * one_minus),
        one_minus ** 2 / (32.0 * L_K ** 2),
        m * one_minus / (4.0 * L_l),
        9.0 * r * r * m * one_minus / (32.0 * L_y ** 2 * (1.0 + 1.0 / r) * L_f ** 2 + 1e-30),
        (1.0 - r) * (1.0 + r) * r * one_minus ** 2
        / (32.0 * L_y ** 2 * (mu_g + L_g) * L_K ** 2 * beta + 1e-30),
        one_minus / (4.0 * L_K),
        1.0,
    )
    return float(alpha), float(beta)
