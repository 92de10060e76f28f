"""The ``cg`` hypergradient backend and ``cg_solve``: fixed-trip CG.

Counterpart of ``repro.hypergrad.cg`` on its fixed-trip path.  The loop
always runs ``iters`` matvecs; the tolerance only freezes the iterate
(step sizes forced to 0 once ``sqrt(rs) <= tol``).  The freeze is a
tensor ``torch.where``, never a Python branch on a tensor, so the solve
runs under ``torch.func.vmap`` over agents and inside a CUDA graph.  The
reference's early-exit loop (``early_exit=True``, the ``cg-linearized``
backend) would read the residual on the host every trip, which a graph
cannot hold, so it is not ported.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.hypergrad.config import HypergradConfig
from repro_torch.hypergrad.engine import (HypergradEngine, hvp_yy,
                                          register_backend)
from repro_torch.hypergrad.operator import (HypergradStats, LinearOperator,
                                            as_operator, flat_dot, tree_axpy)

__all__ = ["CgEngine", "CgInfo", "cg_solve"]


class CgInfo(NamedTuple):
    """Solve diagnostics returned beside the CG solution.

    residual_norm: final ||b - A x|| (recurrence residual).
    iterations:    productive iterations (those before the freeze).
    matvecs:       matvecs executed: the full trip count.
    """

    residual_norm: torch.Tensor
    iterations: torch.Tensor
    matvecs: int


def _threshold(b, tol: float, rel_tol: bool):
    if not rel_tol:
        return tol
    return tol * torch.sqrt(flat_dot(b, b))


def _cg_frozen(op: LinearOperator, b, iters: int, tol, count0: int,
               with_info: bool = False):
    """Fixed ``iters`` trip count; the tolerance freezes the iterate.

    Returns ``(x, CgInfo or None, count)`` with ``count = count0 +
    iters``; ``with_info`` counts the productive iterations (two more
    small kernels a trip, so the backend's solve skips them).
    """
    x = pytree.tree_map(torch.zeros_like, b)
    r, p = b, b
    rs = flat_dot(b, b)
    its = torch.zeros_like(rs, dtype=torch.int32) if with_info else None
    count = count0
    for _ in range(iters):
        ap, count = op.apply_counted(p, count)
        denom = flat_dot(p, ap)
        alpha = torch.where(denom > 0, rs / torch.clamp_min(denom, 1e-30), 0.0)
        active = torch.sqrt(rs) > tol
        alpha = torch.where(active, alpha, 0.0)
        x = tree_axpy(alpha, p, x)
        r = tree_axpy(-alpha, ap, r)
        rs_new = flat_dot(r, r)
        beta = torch.where(active, rs_new / torch.clamp_min(rs, 1e-30), 0.0)
        p = tree_axpy(beta, p, r)
        rs = torch.where(active, rs_new, rs)
        if with_info:
            its = its + active.to(torch.int32)
    info = (CgInfo(residual_norm=torch.sqrt(rs), iterations=its,
                   matvecs=count - count0) if with_info else None)
    return x, info, count


def cg_solve(matvec: Callable, b, iters: int, tol: float, *,
             rel_tol: bool = True, return_info: bool = False):
    """Conjugate gradients for an SPD ``matvec`` on pytrees, ``iters``
    trips.

    ``rel_tol`` scales the residual test by ``||b||`` (default; ``False``
    for the absolute test).  ``return_info`` also returns a ``CgInfo``.
    """
    x, info, _ = _cg_frozen(as_operator(matvec), b, iters, _threshold(b, tol, rel_tol), 0,
                            with_info=return_info)
    return (x, info) if return_info else x


@register_backend("cg")
class CgEngine(HypergradEngine):
    """Fixed trip count, one forward-over-reverse HVP per matvec."""

    def solve(self, g, x, y, b, cfg: HypergradConfig, g_args, draw=None,
              inner_hess_yy=None):
        op = LinearOperator(lambda v: hvp_yy(g, x, y, v, *g_args))
        thresh = _threshold(b, cfg.cg_tol, cfg.cg_rel_tol)
        z, _info, count = _cg_frozen(op, b, cfg.cg_iters, thresh, 0)
        return z, HypergradStats.zero()._replace(hvp_count=count)
