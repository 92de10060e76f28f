"""`HypergradConfig`: how the inner-Hessian inverse of eq. (5) is applied.

Counterpart of ``repro.hypergrad.config``.  This slice of the port has
the ``cg`` backend only; the Neumann and Cholesky fields of the JAX
config arrive with their backends.
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
      cg_iters: fixed trip count of the ``cg`` backend.
      cg_tol: residual below which the CG iterate freezes.
      backend: ``HypergradEngine`` registry name; ``None`` derives it from
        ``method``.  Validated by ``resolve_backend()``.
      cg_rel_tol: compare ``sqrt(rs)`` against ``cg_tol * ||b||`` instead of
        the absolute ``cg_tol``.
    """

    method: Literal["cg", "neumann"] = "cg"
    cg_iters: int = 32
    cg_tol: float = 1e-8
    backend: str | None = None
    cg_rel_tol: bool = False

    def resolve_backend(self) -> str:
        """The registry name this config selects; raises when unknown."""
        from repro_torch.hypergrad.engine import available_backends
        name = self.backend if self.backend is not None else self.method
        if name not in available_backends():
            raise ValueError(
                f"hypergradient backend {name!r} is not available in the "
                f"port; choose from {available_backends()}")
        return name
