"""Hypergradient engines: one ``hypergradient(...)`` surface.

Counterpart of ``repro.hypergrad``; backends ``cg``, ``cg-linearized``,
``neumann``, ``neumann-linearized`` and ``cholesky``.
"""
from repro_torch.hypergrad.config import HypergradConfig
from repro_torch.hypergrad.engine import (
    HypergradEngine,
    available_backends,
    get_backend,
    hvp_xy,
    hvp_yy,
    hypergradient,
    hypergradient_with_stats,
    linearize,
    linearize_grad_y,
    measure_counts,
    measure_problem_counts,
    register_backend,
)
from repro_torch.hypergrad.operator import HypergradStats, LinearOperator
from repro_torch.hypergrad.cg import CgInfo, cg_solve
from repro_torch.hypergrad.neumann import (
    neumann_stochastic_apply,
    neumann_truncated_apply,
)

__all__ = [
    "CgInfo",
    "HypergradConfig",
    "HypergradEngine",
    "HypergradStats",
    "LinearOperator",
    "available_backends",
    "cg_solve",
    "get_backend",
    "hvp_xy",
    "hvp_yy",
    "hypergradient",
    "hypergradient_with_stats",
    "linearize",
    "linearize_grad_y",
    "measure_counts",
    "measure_problem_counts",
    "neumann_stochastic_apply",
    "neumann_truncated_apply",
    "register_backend",
]
