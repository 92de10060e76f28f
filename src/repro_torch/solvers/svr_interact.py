"""Registry entry for SVR-INTERACT (Algorithm 2).

SPIDER-style recursive estimators with a full refresh every q steps.
Amortized per-agent IFO cost: one n-sample refresh every q iterations
plus two batch-size evaluations per recursive step (Corollary 4's
O(sqrt(n)) regime at the paper's q = |S| = ceil(sqrt(n)) defaults).
"""
from __future__ import annotations

from repro_torch.byzantine import init_guard
from repro_torch.core.svr_interact import (init_svr_state, is_refresh,
                                           step_draws, svr_interact_step)
from repro_torch.solvers.api import SolverBase, register_solver

__all__ = ["SvrInteractSolver"]


@register_solver("svr-interact")
class SvrInteractSolver(SolverBase):
    """Variance-reduced INTERACT (eqs. 23-24 estimators)."""

    uses_draws = True

    def _init_state(self, problem, hg_cfg, x0, y0, data):
        draws = step_draws(self.draw(1, data.inner_x.device), 0)
        return init_svr_state(problem, hg_cfg, x0, y0, data, draws,
                              compression=self.config.compression,
                              guard=init_guard(self.config.guard,
                                               data.inner_x.device))

    def _make_param_step(self, problem, hg_cfg, engine, n):
        self._q = q = self.config.resolve_q(n)

        def step(state, data, draws, alpha, beta):
            return svr_interact_step(problem, hg_cfg, engine, alpha, beta,
                                     q, state, data, draws)

        return step

    def branch(self, t: int) -> bool:
        """True for a refresh step, False for a recursive one."""
        return is_refresh(t, self._q)

    def samples_per_step(self, n: int) -> float:
        # amortized: one full refresh (n) every q steps + 2*batch otherwise
        q = self.config.resolve_q(n)
        bs = self.config.resolve_batch(n)
        return float(n / q + 2 * bs)

    def hypergrad_calls_per_step(self, n: int) -> float:
        # a refresh step makes one full-batch estimator call, every other
        # step the two minibatch calls of eq. 23: (1 + 2(q-1)) / q
        return 2.0 - 1.0 / self.config.resolve_q(n)
