"""The ``cg`` hypergradient backend: fixed-trip conjugate gradients.

Counterpart of the ``cg`` backend of ``repro.hypergrad.cg``.  The loop
always runs ``cfg.cg_iters`` matvecs; the tolerance only freezes the
iterate (step sizes forced to 0 once ``sqrt(rs) <= tol``).  The freeze is
a tensor ``torch.where``, never a Python branch on a tensor, so the solve
runs under ``torch.func.vmap`` over agents with a fixed matvec count.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.hypergrad.config import HypergradConfig
from repro_torch.hypergrad.engine import (HypergradEngine, hvp_yy,
                                          register_backend)
from repro_torch.hypergrad.operator import (HypergradStats, LinearOperator,
                                            flat_dot, tree_axpy)

__all__ = ["CgEngine"]


def _threshold(b, tol: float, rel_tol: bool):
    if not rel_tol:
        return tol
    return tol * torch.sqrt(flat_dot(b, b))


def _cg_frozen(op: LinearOperator, b, iters: int, tol, count0: int):
    """Fixed ``iters`` trip count; the tolerance freezes the iterate.

    Returns ``(x, count)`` with ``count = count0 + iters`` matvecs.
    """
    x = pytree.tree_map(torch.zeros_like, b)
    r, p = b, b
    rs = flat_dot(b, b)
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
    return x, count


@register_backend("cg")
class CgEngine(HypergradEngine):
    """Fixed trip count, one forward-over-reverse HVP per matvec."""

    def solve(self, g, x, y, b, cfg: HypergradConfig, g_args):
        op = LinearOperator(lambda v: hvp_yy(g, x, y, v, *g_args))
        thresh = _threshold(b, cfg.cg_tol, cfg.cg_rel_tol)
        z, count = _cg_frozen(op, b, cfg.cg_iters, thresh, 0)
        return z, HypergradStats.zero()._replace(hvp_count=count)
