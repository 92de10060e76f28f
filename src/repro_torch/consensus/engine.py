"""The ConsensusEngine API: one pluggable backend behind Steps 1 and 3.

Counterpart of ``repro.consensus.engine`` on its full-precision path.
The paper's communication result rests on the consensus combine
``x_i <- sum_j M_ij x_j`` (eqs. 6/10):

    engine.mix(tree) -> tree
        The bare combine on every (m, ...) leaf.

    engine.step1_step3(x, u, p, p_prev, alpha) -> (x_new, u_new)
            x_new = mix(x) - alpha * u          (Step 1, eq. 6)
            u_new = mix(u) + (p - p_prev)       (Step 3, eq. 10)
        The base class composes two ``mix`` calls; the ``cuda`` backend
        runs both in one fused kernel launch.

Backends: ``dense`` (the (m, m) matmul reference) and ``cuda`` (the
hand-written Hopper kernels).  The compressed wire, time-varying
topologies and Byzantine rules of the JAX engine are later slices.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

__all__ = ["BACKENDS", "ConsensusEngine", "consensus_descent_and_track",
           "make_engine", "register_backend"]


def _f32(leaf):
    return leaf.to(torch.float32)


class ConsensusEngine:
    """Base class: a consensus combine plus the fused Step-1/3 pair."""

    name = "base"

    def mix(self, tree):
        """Apply ``x_i <- sum_j M_ij x_j`` to every leaf of ``tree``."""
        raise NotImplementedError

    def step1_step3(self, x, u, p, p_prev, alpha: float):
        """Fused eq. (6) + eq. (10): returns ``(x_new, u_new)``.

        Math runs in float32 and is cast back to the leaf dtype.  The
        tracking term is grouped as ``mix(u) + (p - p_prev)``, so calling
        with ``p is p_prev`` yields ``mix(u)`` exactly.
        """
        x_mixed = self.mix(x)
        u_mixed = self.mix(u)
        x_new = pytree.tree_map(
            lambda mx, uu: (_f32(mx) - alpha * _f32(uu)).to(mx.dtype),
            x_mixed, u)
        u_new = pytree.tree_map(
            lambda mu, pn, pp: (_f32(mu) + (_f32(pn) - _f32(pp))).to(mu.dtype),
            u_mixed, p, p_prev)
        return x_new, u_new


def consensus_descent_and_track(engine: ConsensusEngine, x, y, u, v, p_prev,
                                alpha: float, beta: float,
                                grads_fn: Callable):
    """One INTERACT iteration skeleton.

      Step 1: x_new = mix(x) - alpha u ;  y_new = y - beta v
      Step 2: (p_new, v_new, aux) = grads_fn(x_new, y_new)
      Step 3: u_new = mix(u) + p_new - p_prev

    Both mixes go through one ``engine.step1_step3`` call (with
    ``p = p_prev`` its tracking term vanishes and it returns
    ``(x_new, mix(u))``), so the ``cuda`` backend runs them in a single
    kernel launch; the tracking correction is applied once the new local
    gradients exist.  Returns ``(x_new, y_new, u_new, v_new, p_new, aux)``.
    """
    x_new, u_mixed = engine.step1_step3(x, u, p_prev, p_prev, alpha)
    y_new = pytree.tree_map(
        lambda yy, vv: (_f32(yy) - beta * _f32(vv)).to(yy.dtype), y, v)

    p_new, v_new, aux = grads_fn(x_new, y_new)

    u_new = pytree.tree_map(
        lambda mu, pn, pp: (_f32(mu) + (_f32(pn) - _f32(pp))).to(mu.dtype),
        u_mixed, p_new, p_prev)
    return x_new, y_new, u_new, v_new, p_new, aux


# Backend registry: name -> factory(mixing, device).
BACKENDS: dict[str, Callable] = {}


def register_backend(name: str) -> Callable[[Callable], Callable]:
    """Decorator: register a consensus-backend factory under ``name``."""

    def deco(factory: Callable) -> Callable:
        existing = BACKENDS.get(name)
        if existing is not None and existing is not factory:
            raise ValueError(f"consensus backend {name!r} already "
                             f"registered ({existing!r})")
        BACKENDS[name] = factory
        return factory

    return deco


@register_backend("dense")
def _make_dense(mixing, device):
    from repro_torch.consensus.dense import DenseEngine
    return DenseEngine(mixing, device)


@register_backend("cuda")
def _make_cuda(mixing, device):
    from repro_torch.consensus.cuda import CudaEngine
    return CudaEngine(mixing, device)


def make_engine(backend: str, mixing,
                device: torch.device | str) -> ConsensusEngine:
    """Build a consensus backend by name on ``device``.

    ``mixing`` is a ``MixingSpec`` or a raw (m, m) matrix.
    """
    try:
        factory = BACKENDS[backend]
    except KeyError:
        raise ValueError(
            f"unknown consensus backend {backend!r}; "
            f"choose from {sorted(BACKENDS)}") from None
    return factory(mixing, device)
