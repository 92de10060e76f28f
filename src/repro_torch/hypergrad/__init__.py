"""Hypergradient engines: one ``hypergradient(...)`` surface.

Counterpart of ``repro.hypergrad``; this slice has the ``cg`` backend.
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
    measure_counts,
    measure_problem_counts,
    register_backend,
)
from repro_torch.hypergrad.operator import HypergradStats, LinearOperator

__all__ = [
    "HypergradConfig",
    "HypergradEngine",
    "HypergradStats",
    "LinearOperator",
    "available_backends",
    "get_backend",
    "hvp_xy",
    "hvp_yy",
    "hypergradient",
    "hypergradient_with_stats",
    "measure_counts",
    "measure_problem_counts",
    "register_backend",
]
