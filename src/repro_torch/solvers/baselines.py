"""Registry entries for the Section-6 baselines: GT-DSGD and D-SGD.

GT-DSGD keeps INTERACT's tracking skeleton (two consensus rounds) on
plain minibatch gradients; D-SGD also drops tracking, so it communicates
once per iteration (one ``consensus_mix`` on the ``cuda`` backend) but
pays for it in convergence (Fig. 2).
"""
from __future__ import annotations

from repro_torch.byzantine import init_guard
from repro_torch.core.baselines import (dsgd_step, gt_dsgd_step,
                                        init_dsgd_state, init_gt_dsgd_state)
from repro_torch.core.svr_interact import step_draws
from repro_torch.solvers.api import SolverBase, register_solver

__all__ = ["DsgdSolver", "GtDsgdSolver"]


@register_solver("gt-dsgd")
class GtDsgdSolver(SolverBase):
    """Gradient-tracked decentralized SGD (stripped-down INTERACT)."""

    uses_draws = True

    def _init_state(self, problem, hg_cfg, x0, y0, data):
        draws = step_draws(self.draw(1, data.inner_x.device), 0)
        return init_gt_dsgd_state(problem, hg_cfg, x0, y0, data, draws,
                                  compression=self.config.compression,
                                  guard=init_guard(self.config.guard,
                                                   data.inner_x.device))

    def _make_param_step(self, problem, hg_cfg, engine, n):
        def step(state, data, draws, alpha, beta):
            return gt_dsgd_step(problem, hg_cfg, engine, alpha, beta, state,
                                data, draws)

        return step

    def samples_per_step(self, n: int) -> float:
        return float(self.config.resolve_batch(n))


@register_solver("d-sgd")
class DsgdSolver(SolverBase):
    """Decentralized SGD without gradient tracking (one mix per step)."""

    communications_per_step = 1  # only x is mixed; no tracker exchange
    uses_draws = True

    def _init_state(self, problem, hg_cfg, x0, y0, data):
        return init_dsgd_state(x0, y0, data.inner_x.shape[0],
                               compression=self.config.compression,
                               guard=init_guard(self.config.guard,
                                                data.inner_x.device))

    def _make_param_step(self, problem, hg_cfg, engine, n):
        def step(state, data, draws, alpha, beta):
            return dsgd_step(problem, hg_cfg, engine, alpha, beta, state,
                             data, draws)

        return step

    def samples_per_step(self, n: int) -> float:
        return float(self.config.resolve_batch(n))
