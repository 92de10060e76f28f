"""Solver API: one registry, one config, one runner.

    from repro_torch.solvers import SolverConfig, solve

    result = solve(SolverConfig(algo="interact", backend="cuda"), 40,
                   record_every=5)
"""
from repro_torch.solvers.api import (
    SolveResult,
    SolverBase,
    available_solvers,
    default_setup,
    make_solver,
    register_solver,
    run_recorded,
    solve,
)
from repro_torch.solvers.config import SolverConfig, TopologyConfig

# Importing the implementation module populates the registry.
from repro_torch.solvers import interact as _interact  # noqa: F401

__all__ = [
    "SolveResult",
    "SolverBase",
    "SolverConfig",
    "TopologyConfig",
    "available_solvers",
    "default_setup",
    "make_solver",
    "register_solver",
    "run_recorded",
    "solve",
]
