"""SVR-INTERACT (Algorithm 2) and the port's minibatch sampling.

Counterpart of ``repro.core.svr_interact``.  The consensus and tracking
skeleton is Algorithm 1's; the local gradients are SPIDER/SARAH-style
recursive estimators, refreshed with a full-gradient pass every q steps:

  (t + 1) % q == 0:  p = grad_bar f(x, y)                  (full, eqs. 8-9)
  otherwise:         p = p_prev + (1/|S|) sum_xi [grad_bar f(x; xi)
                                 - grad_bar f(x_prev; xi)]       (23)
                     v analogous for grad_y g                    (24)

with the same draw xi at both iterates.  The reference computes both
branches every step and keeps one with ``jnp.where``; the port keeps t
as a Python int and computes only the branch it selects (same value,
half the work), so a CUDA graph captures each branch once.

Sampling.  ``jax.random`` cannot be reproduced in PyTorch, so the
randomness enters every stochastic step as an explicit ``Draws`` tuple,
one row per agent: the inner and outer minibatch indices and the
stochastic-Neumann k.  ``Sampler`` draws it on the host from a
``torch.Generator``; the parity tests hand the reference's own draws in
instead; a captured step copies each step's draws into its graph's
input buffer.  No random number is drawn on the device.
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

__all__ = ["Draws", "Sampler", "SvrState", "init_svr_state", "is_refresh",
           "step_draws", "svr_interact_step"]


class Draws(NamedTuple):
    """One step's random draws, a leading agent axis m on every field
    (and a leading step axis before it when ``Sampler.draw`` stacks
    several steps).

    inner: (m, bs) int64 indices into each agent's inner (train) split.
    outer: (m, bs) int64 indices into its outer (validation) split.
    k:     (m,) int64 stochastic-Neumann trip count in {0..K-1}.
    """

    inner: torch.Tensor
    outer: torch.Tensor
    k: torch.Tensor


class Sampler:
    """Draws ``Draws`` on the host from a ``torch.Generator``.

    Each step draws, in this order, the inner indices, the outer indices
    and k; so a step's draws do not depend on how many steps are drawn
    at once.

    Padded form (``pad_to``, a padded sweep group): the draws are made
    for the m active agents alone, then ghost row i takes a copy of row
    ``i % m``.  The active rows are then an unpadded run's draws, and no
    ghost draw reaches an active row.

    Local form (``local = (row0, k)``, one process of a mesh backend):
    the whole (m, ...) block is drawn and rows ``row0 .. row0 + k - 1``
    kept, so each agent gets the draws of its slot in the single-process
    run.
    """

    def __init__(self, generator: torch.Generator, m: int, n_inner: int,
                 n_outer: int, batch_size: int, neumann_k: int,
                 pad_to: int | None = None,
                 local: tuple[int, int] | None = None):
        self.generator = generator
        self.m, self.batch_size = m, batch_size
        self.n_inner, self.n_outer = n_inner, n_outer
        self.neumann_k = max(neumann_k, 1)
        if pad_to is not None and pad_to < m:
            raise ValueError(f"cannot pad {m} agents down to {pad_to}")
        if pad_to is not None and local is not None:
            raise ValueError("a sampler is padded or local, not both")
        self.rows = m if pad_to is None else pad_to
        self.local = local
        if local is not None:
            row0, k = local
            if not (0 <= row0 and 1 <= k and row0 + k <= m):
                raise ValueError(f"rows {row0} .. {row0 + k - 1} are not "
                                 f"among the {m} agents")
            self.rows = k

    def draw(self, num_steps: int, device: torch.device | str) -> Draws:
        """``num_steps`` steps' draws stacked on a leading axis, on
        ``device``."""
        shape, gen = (self.m, self.batch_size), self.generator
        steps = [Draws(torch.randint(0, self.n_inner, shape, generator=gen),
                       torch.randint(0, self.n_outer, shape, generator=gen),
                       torch.randint(0, self.neumann_k, (self.m,),
                                     generator=gen))
                 for _ in range(num_steps)]
        stacked = [torch.stack(f) for f in zip(*steps)]
        if self.local is not None:
            row0, k = self.local
            stacked = [f[:, row0:row0 + k] for f in stacked]
        elif self.rows != self.m:
            ghost = torch.arange(self.rows) % self.m
            stacked = [f[:, ghost] for f in stacked]
        return Draws(*(f.to(device) for f in stacked))

    def zeros(self, device: torch.device | str) -> Draws:
        """One step's draws, all 0: the input of warm-up steps, whose
        results are discarded."""
        idx = torch.zeros(self.rows, self.batch_size, dtype=torch.int64,
                          device=device)
        return Draws(idx, idx.clone(),
                     torch.zeros(self.rows, dtype=torch.int64, device=device))


def step_draws(draws: Draws, i: int) -> Draws:
    """Step ``i``'s draws from a stack of several steps'."""
    return Draws(*(f[i] for f in draws))


class SvrState(NamedTuple):
    x: object        # outer params, leaves (m, ...)
    y: object        # inner params
    u: object        # tracked gradient
    v: object        # inner-gradient estimator d_t
    p_prev: object   # previous outer estimator p_{t-1}
    x_prev: object   # previous iterates (the reference's state keeps them)
    y_prev: object
    t: int           # iteration counter
    ef: object = None  # wire state {"x", "u"} (compressed wire with EF)
    guard: object = None  # guard counters {"last_good", "tripped"}


def _full_grads(problem, hg_cfg, x, y, data: AgentData, k):
    """One agent's full-batch (p, v); ``k`` is its Neumann draw."""
    inner_b = (data.inner_x, data.inner_y)
    outer_b = (data.outer_x, data.outer_y)
    p = hypergradient(problem.outer, problem.inner, x, y, hg_cfg,
                      f_args=(outer_b,), g_args=(inner_b,), draw=k,
                      inner_hess_yy=problem.inner_hess_yy)
    v = grad(problem.inner, argnums=1)(x, y, inner_b)
    return p, v


def minibatch_grads(problem, hg_cfg, x, y, data: AgentData, draws: Draws):
    """One agent's (p, v) on the minibatch its ``draws`` index."""
    inner_b = (data.inner_x[draws.inner], data.inner_y[draws.inner])
    outer_b = (data.outer_x[draws.outer], data.outer_y[draws.outer])
    p = hypergradient(problem.outer, problem.inner, x, y, hg_cfg,
                      f_args=(outer_b,), g_args=(inner_b,), draw=draws.k,
                      inner_hess_yy=problem.inner_hess_yy)
    v = grad(problem.inner, argnums=1)(x, y, inner_b)
    return p, v


def broadcast_agents(tree, m: int):
    """A single-agent pytree stacked m times (as copies)."""
    return pytree.tree_map(
        lambda leaf: leaf.expand((m,) + tuple(leaf.shape)).clone(), tree)


def init_svr_state(problem: BilevelProblem, hg_cfg: HypergradConfig,
                   x0, y0, data: AgentData, draws: Draws,
                   compression: CompressionConfig | None = None,
                   guard: dict | None = None) -> SvrState:
    """u_0 = p_0 = grad_bar f(x_0, y_0), v_0 = grad_y g, full batch;
    ``draws.k`` is each agent's Neumann draw (the indices are unused).
    ``compression`` adds the x and u wire state (``init_ef``), ``guard``
    the guard's counters."""
    m = data.inner_x.shape[0]
    x, y = broadcast_agents(x0, m), broadcast_agents(y0, m)
    p, v = vmap(partial(_full_grads, problem, hg_cfg))(x, y, data, draws.k)
    copy = lambda tree: pytree.tree_map(torch.clone, tree)
    return SvrState(x=x, y=y, u=p, v=v, p_prev=copy(p), x_prev=copy(x),
                    y_prev=copy(y), t=0, ef=init_ef(compression, x=x, u=p),
                    guard=guard)


def is_refresh(t: int, q: int) -> bool:
    """Whether the step taken from iteration ``t`` is a full refresh."""
    return (t + 1) % q == 0


def svr_interact_step(problem: BilevelProblem, hg_cfg: HypergradConfig,
                      engine: ConsensusEngine, alpha: float, beta: float,
                      q: int, state: SvrState, data: AgentData,
                      draws: Draws) -> SvrState:
    """One SVR-INTERACT iteration over all agents.

    A refresh step reads ``draws.k`` only; a recursive step evaluates the
    minibatch of ``draws`` at the new and at the previous iterate.
    """

    def vr_grads(x, y, x_prev, y_prev, v_prev, p_prev, data_i, draws_i):
        p_now, v_now = minibatch_grads(problem, hg_cfg, x, y, data_i,
                                       draws_i)
        p_old, v_old = minibatch_grads(problem, hg_cfg, x_prev, y_prev,
                                       data_i, draws_i)
        p = pytree.tree_map(lambda a, b, c: a + b - c, p_prev, p_now, p_old)
        v = pytree.tree_map(lambda a, b, c: a + b - c, v_prev, v_now, v_old)
        return p, v

    def grads_fn(x_new, y_new):
        if is_refresh(state.t, q):
            p, v = vmap(partial(_full_grads, problem, hg_cfg))(
                x_new, y_new, data, draws.k)
        else:
            p, v = vmap(vr_grads)(x_new, y_new, state.x, state.y, state.v,
                                  state.p_prev, data, draws)
        return p, v, None

    x_new, y_new, u_new, v_new, p_new, ef_new, _ = (
        consensus_descent_and_track(
            engine, state.x, state.y, state.u, state.v, state.p_prev,
            alpha, beta, grads_fn, t=state.t, ef=state.ef))
    return SvrState(x=x_new, y=y_new, u=u_new, v=v_new, p_prev=p_new,
                    x_prev=state.x, y_prev=state.y, t=state.t + 1,
                    ef=ef_new, guard=state.guard)
