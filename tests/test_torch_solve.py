"""The slice as a whole: the port's ``solve`` against the JAX package's.

Both run Algorithm 1 on the same arrays (the JAX package's Section-6
instance at m = 5, n = 100 per agent, full widths) for 10 steps and
record the eq.-11 metric every 5.  The JAX ``pallas`` backend (its
kernel in interpret mode) is held against the port's ``cuda`` backend on
CPU tensors (its kernels' plain versions), and ``dense`` against
``dense``.

Tolerance: the one-step state gap measured in tests/test_torch_interact
is below ``ONE_STEP_TOL`` = 2e-6 of each field's scale; over 10 steps
that allows 10 * 2e-6 = 2e-5 relative on the trace.  Measured: 2e-7.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.solvers import SolverConfig as JConfig  # noqa: E402
from repro.solvers import default_setup as j_default_setup  # noqa: E402
from repro.solvers import solve as j_solve  # noqa: E402
from repro_torch.convert import (agent_data_from_numpy,  # noqa: E402
                                 tree_from_numpy)
from repro_torch.core import MLPMetaProblem  # noqa: E402
from repro_torch.solvers import SolverConfig, solve  # noqa: E402

TRACE_RTOL = 10 * 2e-6
NUM_STEPS, RECORD_EVERY = 10, 5


@pytest.fixture(scope="module")
def instance():
    problem, x0, y0, data = j_default_setup(0, num_agents=5, n_per_agent=100)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(j=dict(problem=problem, x0=x0, y0=y0, data=data),
                t=dict(problem=MLPMetaProblem(mu_g=0.5, lipschitz_g=4.0),
                       x0=tree_from_numpy(np_tree(x0), "cpu"),
                       y0=tree_from_numpy(np_tree(y0), "cpu"),
                       data=agent_data_from_numpy(np_tree(data), "cpu")))


@pytest.mark.parametrize("jax_backend,port_backend",
                         [("pallas", "cuda"), ("dense", "dense")])
def test_eq11_trace_matches_jax(instance, jax_backend, port_backend):
    want = j_solve(JConfig(algo="interact", alpha=0.3, beta=0.3,
                           backend=jax_backend),
                   NUM_STEPS, RECORD_EVERY, **instance["j"])
    got = solve(SolverConfig(algo="interact", alpha=0.3, beta=0.3,
                             backend=port_backend),
                NUM_STEPS, RECORD_EVERY, device="cpu", **instance["t"])
    assert len(got.trace) == len(want.trace) == 3
    assert all(np.isfinite(got.trace)) and got.trace[-1] < got.trace[0]
    np.testing.assert_allclose(got.trace, want.trace, rtol=TRACE_RTOL)
    assert (got.hvp_per_step, got.grad_per_step) == (
        want.hvp_per_step, want.grad_per_step) == (33, 1)
    assert got.samples_per_step == want.samples_per_step == 100.0
    assert got.communications_per_step == want.communications_per_step == 2
    assert got.state.t == NUM_STEPS
    assert got.us_per_step > 0 and got.round_latency_us > 0
