"""The CG backends and ``cg_solve``: fixed-trip CG.

Counterpart of ``repro.hypergrad.cg``.  Every loop here runs ``iters``
matvecs; the tolerance only freezes the iterate.  The freeze is a tensor
``torch.where``, never a Python branch on a tensor, so a solve runs
under ``torch.func.vmap`` over agents and inside a CUDA graph.

* ``cg``: the reference's fixed-trip loop (step sizes forced to 0 once
  ``sqrt(rs) <= tol``).
* ``cg-linearized``: ``grad_y g(x, .)`` linearized once
  (``linearize_grad_y``), CG in the flat raveled space.  The reference
  exits its ``while_loop`` at the tolerance; a graph cannot branch, so
  the port runs all ``cg_iters`` trips and freezes x, r and p with
  ``torch.where`` from the first trip whose start passes the test
  (``_cg_early_exit``).  The iterate is the reference's, and a device
  counter of the trips not frozen is the reference's trip count: its
  ``CgInfo.iterations`` and the backend's ``hvp_count``.  The trips
  after the freeze still run their matvec.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.hypergrad.config import HypergradConfig
from repro_torch.hypergrad.engine import (HypergradEngine, hvp_yy,
                                          linearize_grad_y, register_backend)
from repro_torch.hypergrad.operator import (HypergradStats, LinearOperator,
                                            as_operator, flat_dot, ravel,
                                            tree_axpy)

__all__ = ["CgEngine", "CgInfo", "CgLinearizedEngine", "cg_solve"]


class CgInfo(NamedTuple):
    """Solve diagnostics returned beside the CG solution.

    residual_norm: final ||b - A x|| (recurrence residual).
    iterations:    productive iterations (those before the freeze; the
                   trips the reference's early exit runs).
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


def _cg_early_exit(op: LinearOperator, b: torch.Tensor, iters: int, tol):
    """The reference's early-exit CG on a flat vector ``b``, as ``iters``
    trips: a trip whose start fails ``sqrt(rs) > tol`` (or any later one)
    leaves x, r and p as they were.  Returns ``(x, CgInfo)``; the info's
    ``iterations`` (a 0-dim int32 tensor) counts the trips not frozen."""
    x = torch.zeros_like(b)
    r, p = b, b
    rs = b @ b
    its = torch.zeros_like(rs, dtype=torch.int32)
    for _ in range(iters):
        active = torch.sqrt(rs) > tol
        ap = op.matvec(p)
        denom = p @ ap
        alpha = torch.where(denom > 0, rs / torch.clamp_min(denom, 1e-30),
                            0.0)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        rs_new = r_new @ r_new
        p_new = r_new + (rs_new / torch.clamp_min(rs, 1e-30)) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rs = torch.where(active, rs_new, rs)
        its = its + active.to(torch.int32)
    return x, CgInfo(residual_norm=torch.sqrt(rs), iterations=its,
                     matvecs=iters * op.cost)


def cg_solve(matvec: Callable, b, iters: int, tol: float, *,
             rel_tol: bool = True, early_exit: bool = False,
             return_info: bool = False):
    """Conjugate gradients for an SPD ``matvec`` on pytrees, ``iters``
    trips.

    ``rel_tol`` scales the residual test by ``||b||`` (default; ``False``
    for the absolute test).  ``early_exit`` takes the reference's
    early-exit iterate (a flat tensor ``b``; x, r and p frozen from the
    first trip that passes the test, every trip run).  ``return_info``
    also returns a ``CgInfo``.
    """
    op = as_operator(matvec)
    thresh = _threshold(b, tol, rel_tol)
    if early_exit:
        x, info = _cg_early_exit(op, b, iters, thresh)
    else:
        x, info, _ = _cg_frozen(op, b, iters, thresh, 0,
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


@register_backend("cg-linearized")
class CgLinearizedEngine(HypergradEngine):
    """Linearize-once CG in the flat raveled space, the reference's
    early-exit iterate as ``cg_iters`` frozen trips."""

    def solve(self, g, x, y, b, cfg: HypergradConfig, g_args, draw=None,
              inner_hess_yy=None):
        hvp = linearize_grad_y(g, x, y, g_args)
        b_flat, unravel = ravel(b)
        op = LinearOperator(lambda vf: ravel(hvp(unravel(vf)))[0])
        # the cg oracle's tolerance semantics, so swapping backends changes
        # the cost, not the solve quality
        z_flat, info = cg_solve(op, b_flat, cfg.cg_iters, cfg.cg_tol,
                                rel_tol=cfg.cg_rel_tol, early_exit=True,
                                return_info=True)
        stats = HypergradStats.zero()._replace(hvp_count=info.iterations,
                                               grad_count=1)
        return unravel(z_flat), stats
