"""SVR-INTERACT (Algorithm 2) at LM scale, across a process group.

Counterpart of ``repro.train.svr_step``.  The consensus and tracking
skeleton of ``repro_torch.train.step``, with the SPIDER-style recursive
estimator (eqs. 23-24) for the local gradients:

  (t + 1) % q == 0:  p_t = local_grads(x_t, y_t)  on the refresh batch
  otherwise:         p_t = p_{t-1} + grads(x_t, y_t; S) - grads(x_{t-1}, y_{t-1}; S)

with the *same* minibatch S at both iterates.  The previous iterate
(x_{t-1}, y_{t-1}) lives in the state.

The step index t is known on the host, so only the branch it selects is
computed: a refresh step evaluates ``local_grads`` once, a recursive
step twice.  The JAX package evaluates both every step and keeps one
with ``jnp.where``; the results are the same.

The pods layout (``agent_mode="pods"``) as in ``repro_torch.train.step``:
both iterates are gathered over the pod for their gradients, both
evaluations take the pod's means, and a recursive step reduce-scatters
the difference of the two (the previous p and v are already shards).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.consensus import consensus_descent_and_track
from repro_torch.models.base import ArchConfig
from repro_torch.sharding.collectives import AgentMesh, PodsMesh
from repro_torch.train.bilevel_lm import check_hyper, local_grads
from repro_torch.train.step import (InteractConfig, PodLayout, TrainState,
                                    _check_layout, _local_tokens, _split,
                                    _squeeze, _unsqueeze, init_train_state,
                                    pmean)

__all__ = ["SvrTrainState", "init_svr_train_state", "make_svr_train_step"]


class SvrTrainState(NamedTuple):
    x: Any
    y: torch.Tensor
    u: Any
    v: torch.Tensor
    p_prev: Any
    x_prev: Any      # previous iterate (recursive estimator)
    y_prev: torch.Tensor
    t: int


def init_svr_train_state(cfg: ArchConfig, seed: int = 0,
                         device: str | torch.device | None = None,
                         mesh: PodsMesh | None = None) -> SvrTrainState:
    """``init_train_state``'s state (this rank's shards of it with a
    ``PodsMesh``), the previous iterate equal to it."""
    base: TrainState = init_train_state(cfg, seed, device, mesh)
    return SvrTrainState(x=base.x, y=base.y, u=base.u, v=base.v,
                         p_prev=base.p_prev, x_prev=base.x,
                         y_prev=base.y, t=base.t)


def make_svr_train_step(cfg: ArchConfig, mesh: AgentMesh,
                        icfg: InteractConfig, q: int | None = None,
                        agent_mode: str = "rows"):
    """``step(state, tokens) -> (state, metrics)``; refresh every q steps.

    ``icfg`` may be an ``InteractConfig`` or a ``SolverConfig``; ``q=None``
    reads the refresh period from the config.  ``tokens`` as
    ``make_train_step``'s: the same batch is the refresh set on refresh
    steps and S on recursive ones.  ``metrics``: ``outer_ce`` (the group
    mean at the new iterate) and ``refresh`` (1.0 on a refresh step).
    """
    icfg = InteractConfig.coerce(icfg)
    if q is None:
        if icfg.q is None:
            raise ValueError("refresh period q not given and not set on "
                             "the config")
        q = icfg.q
    ring = _check_layout(mesh, agent_mode)
    hyper = icfg.hyper
    check_hyper(hyper, differentiate=True, pods=agent_mode == "pods")
    lay = PodLayout(cfg, mesh) if agent_mode == "pods" else None
    pod = None if lay is None else lay.pod
    engine = icfg.consensus_engine(ring.num_agents, ring,
                                   None if lay is None else lay.x_shards)

    def grads(x, y, inner_t, outer_t):
        if lay is not None:
            x, y = lay.gather(x, y)
        return local_grads(cfg, hyper, _squeeze(x), y[0], inner_t, outer_t,
                           pod=pod)

    def step(state: SvrTrainState, tokens):
        inner_t, outer_t = _split(_local_tokens(ring, tokens), pod)
        refresh = (state.t + 1) % q == 0

        def grads_fn(x_new, y_new):
            # gradients at the new iterate (always needed)
            p_now, v_now, ce = grads(x_new, y_new, inner_t, outer_t)
            if refresh:
                if lay is not None:
                    return (*lay.scatter(_unsqueeze(p_now), v_now[None]),
                            ce)
                return _unsqueeze(p_now), v_now[None], ce
            # same minibatch at the previous iterate (recursive difference)
            p_old, v_old, _ = grads(state.x_prev, state.y_prev, inner_t,
                                    outer_t)
            if lay is not None:
                dp, dv = lay.scatter(
                    _unsqueeze(pytree.tree_map(torch.sub, p_now, p_old)),
                    (v_now - v_old)[None])
                return (pytree.tree_map(torch.add, state.p_prev, dp),
                        state.v + dv, ce)
            p_vr = pytree.tree_map(lambda pp, a, b: pp[0] + a - b,
                                   state.p_prev, p_now, p_old)
            v_vr = state.v[0] + v_now - v_old
            return _unsqueeze(p_vr), v_vr[None], ce

        x_new, y_new, u_new, v_new, p_new, _, ce = (
            consensus_descent_and_track(
                engine, state.x, state.y, state.u, state.v, state.p_prev,
                icfg.alpha, icfg.beta, grads_fn, t=state.t))

        new_state = SvrTrainState(
            x=x_new, y=y_new, u=u_new, v=v_new, p_prev=p_new,
            x_prev=state.x, y_prev=state.y, t=state.t + 1)
        return new_state, {"outer_ce": pmean(ring, ce)[0],
                           "refresh": torch.tensor(float(refresh))}

    return step
