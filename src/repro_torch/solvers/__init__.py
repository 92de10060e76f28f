"""Solver API: one registry, one config, one runner.

    from repro_torch.solvers import SolverConfig, solve

    result = solve(SolverConfig(algo="svr-interact", backend="cuda"), 40,
                   record_every=5)
    grid = sweep(expand_grid(SolverConfig(), seed=range(8)), 40, 5)

``algo`` is one of "interact", "svr-interact", "gt-dsgd", "d-sgd".
"""
from repro_torch.byzantine import ByzantineConfig, GuardConfig
from repro_torch.solvers.api import (
    EagerStepper,
    GraphStepper,
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
from repro_torch.solvers.sweep import (SweepGroup, SweepResult, expand_grid,
                                       sweep)

# Importing the implementation modules populates the registry.
from repro_torch.solvers import baselines as _baselines  # noqa: F401
from repro_torch.solvers import interact as _interact  # noqa: F401
from repro_torch.solvers import svr_interact as _svr  # noqa: F401

__all__ = [
    "ByzantineConfig",
    "EagerStepper",
    "GraphStepper",
    "GuardConfig",
    "SolveResult",
    "SolverBase",
    "SolverConfig",
    "SweepGroup",
    "SweepResult",
    "TopologyConfig",
    "available_solvers",
    "default_setup",
    "expand_grid",
    "make_solver",
    "register_solver",
    "run_recorded",
    "solve",
    "sweep",
]
