"""The paper's convergence metric (eqs. 2 / 11) and its ingredients.

Counterpart of ``repro.core.metrics``, with the ghost-masked form the
padded sweeps record.

    M_t = ||grad l(x_bar)||^2            (stationarity of the average)
        + (1/m) sum_i ||x_i - x_bar||^2  (consensus error)
        + ||y* - y||^2                   (inner error, aggregated)

y*(x) comes from gradient descent on the strongly-convex inner problem,
an evaluation-only cost outside any algorithm's sample complexity.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import grad, vmap
from torch.utils import _pytree as pytree

from repro_torch.core.bilevel import AgentData, BilevelProblem
from repro_torch.hypergrad import HypergradConfig, hypergradient

__all__ = ["MetricReport", "convergence_metric", "convergence_metric_fn",
           "masked_convergence_metric", "masked_convergence_metric_fn",
           "solve_inner"]


class MetricReport(NamedTuple):
    total: torch.Tensor
    stationarity: torch.Tensor
    consensus_error: torch.Tensor
    inner_error: torch.Tensor
    outer_loss: torch.Tensor


def _tree_sq_norm(tree) -> torch.Tensor:
    return sum(torch.sum(torch.square(l)) for l in pytree.tree_leaves(tree))


def solve_inner(problem: BilevelProblem, x, y0, batch,
                steps: int = 400, lr: float = 0.5):
    """y*(x) via GD on the strongly-convex inner problem (single agent)."""
    grad_g = grad(problem.inner, argnums=1)
    y = y0
    for _ in range(steps):
        g = grad_g(x, y, batch)
        y = pytree.tree_map(lambda yi, gi: yi - lr * gi, y, g)
    return y


def convergence_metric(problem: BilevelProblem, hg_cfg: HypergradConfig,
                       x_stack, y_stack, inner_steps: int, inner_lr: float,
                       data: AgentData) -> MetricReport:
    """M_t for stacked per-agent iterates (leading axis m)."""
    m = pytree.tree_leaves(x_stack)[0].shape[0]
    x_bar = pytree.tree_map(lambda l: l.mean(dim=0), x_stack)

    consensus_error = sum(
        torch.sum(torch.square(xi - xb[None]))
        for xi, xb in zip(pytree.tree_leaves(x_stack),
                          pytree.tree_leaves(x_bar))) / m

    inner_batches = (data.inner_x, data.inner_y)

    def agent_inner_err(x_i, y_i, batch):
        y_star = solve_inner(problem, x_i, y_i, batch, inner_steps, inner_lr)
        return _tree_sq_norm(pytree.tree_map(lambda a, b: a - b, y_star, y_i))

    inner_error = torch.sum(vmap(agent_inner_err)(x_stack, y_stack,
                                                  inner_batches))

    def agent_hypergrad_at_bar(y_i, inner_b, outer_b):
        y_star = solve_inner(problem, x_bar, y_i, inner_b, inner_steps,
                             inner_lr)
        p = hypergradient(problem.outer, problem.inner, x_bar, y_star,
                          hg_cfg, f_args=(outer_b,), g_args=(inner_b,),
                          inner_hess_yy=problem.inner_hess_yy)
        return p, problem.outer(x_bar, y_star, outer_b)

    p_all, f_all = vmap(agent_hypergrad_at_bar)(
        y_stack, inner_batches, (data.outer_x, data.outer_y))
    grad_l = pytree.tree_map(lambda l: l.mean(dim=0), p_all)
    stationarity = _tree_sq_norm(grad_l)
    total = stationarity + consensus_error + inner_error
    return MetricReport(total=total, stationarity=stationarity,
                        consensus_error=consensus_error,
                        inner_error=inner_error, outer_loss=f_all.mean())


def convergence_metric_fn(problem: BilevelProblem, hg_cfg: HypergradConfig,
                          data: AgentData, inner_steps: int = 300,
                          inner_lr: float = 0.5):
    """A ``state -> M_t`` closure (0-dim tensor) over ``data``."""

    def metric(state):
        return convergence_metric(problem, hg_cfg, state.x, state.y,
                                  inner_steps, inner_lr, data).total

    return metric


# -- the ghost-masked metric of padded sweep groups ---------------------------
#
# A padded sweep group pads every state and data tensor to a common m_pad;
# ghost agents must not count in M_t.  The agent reductions are also
# association-stable: a sequential fold over the agent axis, so the sum
# over the active agents is built in the same float association whatever
# m_pad is (ghost terms add exact zeros).


def _masked_agent_sum(tree, num_active: torch.Tensor):
    """Sequential sum over the leading agent axis of every leaf, agents
    from ``num_active`` on left out.  A Python loop over the padded agent
    count with ``torch.where`` masks, so it runs under ``vmap`` (one
    ``num_active`` per experiment) and inside a CUDA graph."""
    m_pad = pytree.tree_leaves(tree)[0].shape[0]
    acc = pytree.tree_map(lambda l: torch.zeros_like(l[0]), tree)
    for i in range(m_pad):
        live = i < num_active
        acc = pytree.tree_map(
            lambda a, l: a + torch.where(live, l[i], torch.zeros_like(l[i])),
            acc, tree)
    return acc


def masked_convergence_metric(problem: BilevelProblem,
                              hg_cfg: HypergradConfig, x_stack, y_stack,
                              inner_steps: int, inner_lr: float,
                              data: AgentData,
                              num_active: torch.Tensor) -> MetricReport:
    """M_t over the first ``num_active`` agents of ghost-padded iterates.

    ``convergence_metric`` with m = num_active: ghost rows (agent index
    >= num_active) leave every average and sum.  ``num_active`` is a
    0-dim integer tensor (one per experiment under ``vmap``); the padded
    agent count comes from the leaf shapes.  Per-agent work (inner
    solves, hypergradients) still runs on ghost rows, whose padded data
    keeps it finite; only the cross-agent reductions mask.
    """
    x_bar_sum = _masked_agent_sum(x_stack, num_active)
    na = num_active.to(pytree.tree_leaves(x_bar_sum)[0].dtype)
    x_bar = pytree.tree_map(lambda l: l / na, x_bar_sum)

    def agent_cons(x_i):
        return _tree_sq_norm(pytree.tree_map(lambda a, b: a - b, x_i, x_bar))

    consensus_error = _masked_agent_sum(vmap(agent_cons)(x_stack),
                                        num_active) / na

    inner_batches = (data.inner_x, data.inner_y)

    def agent_inner_err(x_i, y_i, batch):
        y_star = solve_inner(problem, x_i, y_i, batch, inner_steps, inner_lr)
        return _tree_sq_norm(pytree.tree_map(lambda a, b: a - b, y_star, y_i))

    inner_error = _masked_agent_sum(
        vmap(agent_inner_err)(x_stack, y_stack, inner_batches), num_active)

    def agent_hypergrad_at_bar(y_i, inner_b, outer_b):
        y_star = solve_inner(problem, x_bar, y_i, inner_b, inner_steps,
                             inner_lr)
        p = hypergradient(problem.outer, problem.inner, x_bar, y_star,
                          hg_cfg, f_args=(outer_b,), g_args=(inner_b,),
                          inner_hess_yy=problem.inner_hess_yy)
        return p, problem.outer(x_bar, y_star, outer_b)

    p_all, f_all = vmap(agent_hypergrad_at_bar)(
        y_stack, inner_batches, (data.outer_x, data.outer_y))
    grad_l = pytree.tree_map(lambda l: l / na,
                             _masked_agent_sum(p_all, num_active))
    stationarity = _tree_sq_norm(grad_l)
    outer_loss = _masked_agent_sum(f_all, num_active) / na
    total = stationarity + consensus_error + inner_error
    return MetricReport(total=total, stationarity=stationarity,
                        consensus_error=consensus_error,
                        inner_error=inner_error, outer_loss=outer_loss)


def masked_convergence_metric_fn(problem: BilevelProblem,
                                 hg_cfg: HypergradConfig,
                                 inner_steps: int = 300,
                                 inner_lr: float = 0.5):
    """A ``(state, data, num_active) -> M_t`` function for padded sweeps:
    the data and the active count are arguments (one each per experiment
    of a padded group), not closed over."""

    def metric(state, data: AgentData, num_active: torch.Tensor):
        return masked_convergence_metric(problem, hg_cfg, state.x, state.y,
                                         inner_steps, inner_lr, data,
                                         num_active).total

    return metric
