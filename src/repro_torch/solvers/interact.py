"""Registry entry for INTERACT (Algorithm 1).

Full local gradients every iteration: n IFO calls per agent per step
(Definition 1), two consensus rounds (Steps 1 and 3).  The math lives in
``repro_torch.core.interact``.
"""
from __future__ import annotations

from repro_torch.byzantine import init_guard
from repro_torch.core.interact import init_state, interact_step
from repro_torch.solvers.api import SolverBase, register_solver

__all__ = ["InteractSolver"]


@register_solver("interact")
class InteractSolver(SolverBase):
    """Deterministic INTERACT: full gradient pass (eqs. 8-9) each step."""

    def _init_state(self, problem, hg_cfg, x0, y0, data):
        return init_state(problem, hg_cfg, x0, y0, data,
                          compression=self.config.compression,
                          guard=init_guard(self.config.guard,
                                           data.inner_x.device))

    def _make_param_step(self, problem, hg_cfg, engine, n):
        def step(state, data, draws, alpha, beta):
            return interact_step(problem, hg_cfg, engine, alpha, beta,
                                 state, data)

        return step

    def samples_per_step(self, n: int) -> float:
        return float(n)
