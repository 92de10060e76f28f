"""The Neumann backends: the paper's eq. (22) estimator.

Counterpart of ``repro.hypergrad.neumann``.

    truncated:   (1/L) sum_{j=0}^{K-1} (I - H/L)^j b          K HVPs
    stochastic:  (K/L) (I - H/L)^k b,  k ~ U{0..K-1}          k HVPs

The reference runs the stochastic chain as a loop to the drawn k, which
``vmap`` over agents turns into a loop to the largest k with finished
lanes frozen.  The port writes that out: K - 1 trips, each agent's
iterate frozen by ``torch.where`` once the trip index reaches its k.  For
the same k the value is the reference's, the count reports k, and the
loop has a fixed length, so a CUDA graph can hold it.  The drawn k
(``draw``) comes from the caller: the port's sampler, or the reference's
own draw in the parity tests.

Backends registered here:

* ``neumann``: the HVP rebuilt per term, the reference's executed-op
  order (the K-th HVP included, its output discarded).
* ``neumann-linearized``: ``grad_y g(x, .)`` linearized once
  (``linearize_grad_y``), the product chain replaying the stored tangent
  map in the flat raveled space, and the truncated sum skipping the
  discarded K-th HVP (K - 1 HVPs, the same value).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.hypergrad.config import HypergradConfig
from repro_torch.hypergrad.engine import (HypergradEngine, hvp_yy,
                                          linearize_grad_y, register_backend)
from repro_torch.hypergrad.operator import (HypergradStats, LinearOperator,
                                            as_operator, ravel, tree_scale,
                                            tree_sub)

__all__ = ["NeumannEngine", "NeumannLinearizedEngine",
           "neumann_stochastic_apply", "neumann_truncated_apply"]


def neumann_truncated_apply(matvec: Callable, b, k_terms: int,
                            lipschitz_g: float, *, skip_last: bool = False):
    """(1/L) sum_{j<K} (I - H/L)^j b; returns ``(value, hvp_count)``.

    By default keeps the reference's executed-op order, K-th HVP included
    (its output is discarded), so the value matches it op for op.
    ``skip_last`` omits that HVP (K - 1 HVPs, the same value), as the
    linearized backend and the LM head's chain do.
    """
    op = as_operator(matvec)
    L = lipschitz_g
    acc = pytree.tree_map(torch.zeros_like, b)
    if k_terms <= 0:
        return acc, 0
    v, count = b, 0
    for _ in range(k_terms - 1 if skip_last else k_terms):
        acc = pytree.tree_map(torch.add, acc, v)
        hv, count = op.apply_counted(v, count)
        v = tree_sub(v, tree_scale(1.0 / L, hv))
    if skip_last:   # the final term joins the sum without a closing HVP
        acc = pytree.tree_map(torch.add, acc, v)
    return tree_scale(1.0 / L, acc), count


def neumann_stochastic_apply(matvec: Callable, b, k_terms: int,
                             lipschitz_g: float, k: torch.Tensor):
    """(K/L) (I - H/L)^k b for a drawn ``k`` in {0..K-1} (an int tensor,
    one per agent under ``vmap``); returns ``(value, k)``.

    K - 1 HVPs run; trip j updates the iterate only where ``j < k``.
    """
    op = as_operator(matvec)
    L = lipschitz_g
    v = b
    for j in range(k_terms - 1):
        hv, _ = op.apply_counted(v, 0)
        stepped = tree_sub(v, tree_scale(1.0 / L, hv))
        live = k > j
        v = pytree.tree_map(lambda new, old: torch.where(live, new, old),
                            stepped, v)
    return tree_scale(float(k_terms) / L, v), k


@register_backend("neumann")
class NeumannEngine(HypergradEngine):
    """The eq.-(22) estimator, an HVP rebuilt per term."""

    def solve(self, g, x, y, b, cfg: HypergradConfig, g_args, draw=None,
              inner_hess_yy=None):
        op = LinearOperator(lambda v: hvp_yy(g, x, y, v, *g_args))
        if cfg.stochastic_k:
            if draw is None:
                raise ValueError("stochastic_k needs the drawn k (draw=)")
            z, count = neumann_stochastic_apply(op, b, cfg.neumann_k,
                                                cfg.lipschitz_g, draw)
        else:
            z, count = neumann_truncated_apply(op, b, cfg.neumann_k,
                                               cfg.lipschitz_g)
        return z, HypergradStats.zero()._replace(hvp_count=count)


@register_backend("neumann-linearized")
class NeumannLinearizedEngine(HypergradEngine):
    """Linearize-once replay of the eq.-(22) product chain."""

    def solve(self, g, x, y, b, cfg: HypergradConfig, g_args, draw=None,
              inner_hess_yy=None):
        hvp = linearize_grad_y(g, x, y, g_args)
        b_flat, unravel = ravel(b)
        op = LinearOperator(lambda vf: ravel(hvp(unravel(vf)))[0])
        if cfg.stochastic_k:
            if draw is None:
                raise ValueError("stochastic_k needs the drawn k (draw=)")
            z_flat, count = neumann_stochastic_apply(
                op, b_flat, cfg.neumann_k, cfg.lipschitz_g, draw)
        else:
            z_flat, count = neumann_truncated_apply(
                op, b_flat, cfg.neumann_k, cfg.lipschitz_g, skip_last=True)
        stats = HypergradStats.zero()._replace(hvp_count=count, grad_count=1)
        return unravel(z_flat), stats
