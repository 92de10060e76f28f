"""The ``cholesky`` hypergradient backend: materialise H_yy, factor, solve.

Counterpart of ``repro.hypergrad.cholesky``.  The Section-6 inner
problem is a small strongly convex head (d_y = 105 at full size), so the
inverse of eq. (5) can be applied exactly: build the (d_y, d_y) Hessian,
factor it once, solve.  H_yy comes from the problem's closed form
(``BilevelProblem.inner_hess_yy``: one evaluation, counted as one
Hessian) where it has one, else from d_y HVPs against the identity basis
(batched under ``vmap``; one primal pass of grad_y g, counted as one
gradient), symmetrised.

The factorisation is ``torch.linalg.cholesky_ex``, which leaves its
``info`` on the device: ``torch.linalg.cholesky`` reads it on the host,
which a CUDA graph cannot hold.  The solve is two triangular solves
(cuBLAS trsm on the card): ``torch.cholesky_solve`` on a batch goes
through MAGMA's batched potrs, which allocates device memory inside the
call, so a CUDA graph cannot capture it either.  Like the reference,
which factors with LAPACK, this runs outside the port's kernels.
"""
from __future__ import annotations

import torch

from repro_torch.hypergrad.config import HypergradConfig
from repro_torch.hypergrad.engine import (HypergradEngine, hvp_yy,
                                          register_backend)
from repro_torch.hypergrad.operator import (HypergradStats, LinearOperator,
                                            ravel)

__all__ = ["CholeskyEngine", "cho_factor_solve"]


def cho_factor_solve(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``H^{-1} b`` for an SPD ``H`` by a Cholesky factorisation."""
    factor, _info = torch.linalg.cholesky_ex(H)
    z = torch.linalg.solve_triangular(factor, b[:, None], upper=False)
    return torch.linalg.solve_triangular(factor.mT, z, upper=True)[:, 0]


@register_backend("cholesky")
class CholeskyEngine(HypergradEngine):
    """Materialise-and-factor H_yy for small inner problems."""

    def solve(self, g, x, y, b, cfg: HypergradConfig, g_args, draw=None,
              inner_hess_yy=None):
        b_flat, unravel = ravel(b)
        d = b_flat.shape[0]
        stats = HypergradStats.zero()
        if inner_hess_yy is not None:
            H = inner_hess_yy(x, y, *g_args)
            if tuple(H.shape) != (d, d):
                raise ValueError(
                    f"inner_hess_yy returned {tuple(H.shape)}, expected "
                    f"({d}, {d}) in ravel(y) order")
            stats = stats._replace(hess_count=1)
        else:
            op = LinearOperator(
                lambda e: ravel(hvp_yy(g, x, y, unravel(e), *g_args))[0])
            eye = torch.eye(d, dtype=b_flat.dtype, device=b_flat.device)
            rows, count = op.apply_basis(eye, 0)
            # rows[i] = H e_i; symmetrise away the AD round-off
            H = 0.5 * (rows + rows.T)
            stats = stats._replace(hvp_count=count, grad_count=1)
        if cfg.cholesky_jitter:
            H = H + cfg.cholesky_jitter * torch.eye(d, dtype=H.dtype,
                                                    device=H.device)
        return unravel(cho_factor_solve(H, b_flat)), stats
