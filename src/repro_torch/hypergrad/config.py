"""`HypergradConfig`: how the inner-Hessian inverse of eq. (5) is applied.

Counterpart of ``repro.hypergrad.config``, with the same fields and
defaults.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["HypergradConfig"]


@dataclasses.dataclass(frozen=True)
class HypergradConfig:
    """How to apply the inner-Hessian inverse.

    Attributes:
      method: legacy selector ("cg" or "neumann"); ``backend`` wins when set.
      cg_iters: trip count of the CG backends (``cg-linearized`` freezes
        its iterate once the tolerance passes and counts the trips before).
      cg_tol: residual below which the CG iterate freezes.
      neumann_k: K, the truncation order of eq. (22).
      lipschitz_g: L_g, the scale of the Neumann series ((I - H/L_g) must
        be a contraction).
      stochastic_k: draw k ~ U{0..K-1} and apply the unbiased single
        product (K/L_g)(I - H/L_g)^k of eq. (22) instead of the truncated
        sum; the caller hands the drawn k over (``draw``).
      backend: ``HypergradEngine`` registry name ("cg", "cg-linearized",
        "neumann", "neumann-linearized", "cholesky"); ``None`` derives it
        from ``method``.  Validated by ``resolve_backend()``.
      cg_rel_tol: compare ``sqrt(rs)`` against ``cg_tol * ||b||`` instead of
        the absolute ``cg_tol``.
      cholesky_jitter: diagonal added to H_yy before it is factored.
    """

    method: Literal["cg", "neumann"] = "cg"
    cg_iters: int = 32
    cg_tol: float = 1e-8
    neumann_k: int = 8
    lipschitz_g: float = 1.0
    stochastic_k: bool = False
    backend: str | None = None
    cg_rel_tol: bool = False
    cholesky_jitter: float = 0.0

    def resolve_backend(self) -> str:
        """The registry name this config selects; raises when unknown."""
        from repro_torch.hypergrad.engine import available_backends
        name = self.backend if self.backend is not None else self.method
        if name not in available_backends():
            raise ValueError(
                f"hypergradient backend {name!r} is not available in the "
                f"port; choose from {available_backends()}")
        return name
