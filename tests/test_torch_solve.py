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

The stochastic solvers draw other random numbers than the JAX package's
(tests/test_torch_svr_baselines.py holds their steps to the reference's
on handed-over draws), so here their ``solve`` is held to the
reference's costs and counts, and to a falling trace.  On the CPU,
``run_traced`` must give ``run_recorded``'s list bit for bit, in the
reference's layout, and its INTERACT trace must match the reference's
``run_traced`` within ``TRACE_RTOL``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.core import convergence_metric_fn as j_metric_fn  # noqa: E402
from repro.hypergrad import HypergradConfig as JHypergradConfig  # noqa: E402
from repro.solvers import SolverConfig as JConfig  # noqa: E402
from repro.solvers import default_setup as j_default_setup  # noqa: E402
from repro.solvers import make_solver as j_make_solver  # noqa: E402
from repro.solvers import solve as j_solve  # noqa: E402
from repro_torch.convert import (agent_data_from_numpy,  # noqa: E402
                                 tree_from_numpy)
from repro_torch.core import MLPMetaProblem  # noqa: E402
from repro_torch.core import convergence_metric_fn  # noqa: E402
from repro_torch.hypergrad import HypergradConfig  # noqa: E402
from repro_torch.solvers import (EagerStepper, GraphStepper,  # noqa: E402
                                 SolverConfig, make_solver, run_recorded,
                                 solve)

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


STOCHASTIC = ["svr-interact", "gt-dsgd", "d-sgd"]


@pytest.mark.parametrize("algo,backend", [("svr-interact", "cg"),
                                           ("gt-dsgd", "cholesky"),
                                           ("d-sgd", "cg")])
def test_stochastic_solve_costs_match_jax(instance, algo, backend):
    """Costs and counts against the reference's ``solve`` (n = 100:
    q = |S| = 10; ``cholesky`` counts a Hessian); the trace falls."""
    hg = dict(backend=backend)
    want = j_solve(JConfig(algo=algo, backend="dense",
                           hypergrad=JHypergradConfig(**hg)),
                   NUM_STEPS, RECORD_EVERY, **instance["j"])
    got = solve(SolverConfig(algo=algo, backend="cuda",
                             hypergrad=HypergradConfig(**hg)),
                NUM_STEPS, RECORD_EVERY, device="cpu", **instance["t"])
    assert len(got.trace) == len(want.trace) == 3
    assert all(np.isfinite(got.trace)) and got.trace[-1] < got.trace[0]
    assert got.trace[0] == pytest.approx(want.trace[0], rel=TRACE_RTOL)
    for field in ("hvp_per_step", "grad_per_step", "hess_per_step",
                  "samples_per_step", "communications_per_step"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.state.t == NUM_STEPS
    assert got.us_per_step > 0 and got.round_latency_us > 0


@pytest.fixture(scope="module")
def small():
    problem, x0, y0, data = j_default_setup(0, num_agents=4, n_per_agent=40,
                                            hidden=8)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(j=(problem, x0, y0, data),
                t=(MLPMetaProblem(mu_g=0.5, lipschitz_g=4.0),
                   tree_from_numpy(np_tree(x0), "cpu"),
                   tree_from_numpy(np_tree(y0), "cpu"),
                   agent_data_from_numpy(np_tree(data), "cpu")))


@pytest.mark.parametrize("algo", ["interact"] + STOCHASTIC)
def test_run_traced_equals_run_recorded_bitwise(small, algo):
    """Two solvers from one seed: ``run_traced``'s device trace and
    ``run_recorded``'s list agree bit for bit (6 steps, a record every 4:
    before steps 0 and 4, and after the last), as do the final states.
    The metric is eq. 11 with a 30-step inner solve, for speed."""
    problem, x0, y0, data = small["t"]
    config = SolverConfig(algo=algo, backend="cuda", q=4, batch_size=5,
                          seed=5)
    traced, recorded = make_solver(config), make_solver(config)
    state = traced.init(problem, None, x0, y0, data)
    metric = convergence_metric_fn(problem, HypergradConfig(), data,
                                   inner_steps=30)
    state_t, trace = traced.run_traced(state, data, 6, 4, metric)
    state = recorded.init(problem, None, x0, y0, data)
    state_r, want, _ = run_recorded(recorded, state, data, 6, 4,
                                    lambda st: float(metric(st)))
    assert isinstance(trace, torch.Tensor) and trace.shape == (3,)
    assert trace.tolist() == want
    assert state_t.t == state_r.t == 6
    for a, b in zip(torch.utils._pytree.tree_leaves(state_t),
                    torch.utils._pytree.tree_leaves(state_r)):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)
    _, empty = traced.run_traced(state_t, data, 2)
    assert empty.shape == (0,)


def test_cpu_steps_through_one_kept_eager_stepper(small):
    """On the CPU ``scan=True`` takes the eager stepper: one per solver
    and data, warmed once, whose ``advance`` is ``run`` bit for bit; a
    graph stepper refuses CPU tensors."""
    problem, x0, y0, data = small["t"]
    config = SolverConfig(algo="gt-dsgd", backend="cuda", batch_size=5,
                          seed=3)
    solver, plain = make_solver(config), make_solver(config)
    state = solver.init(problem, None, x0, y0, data)
    assert solver.stepper is None
    stepper = solver.stepper_for(state, data, scan=True)
    assert isinstance(stepper, EagerStepper) and not stepper.warmed
    stepper.prepare(2)
    assert stepper.warmed
    run_recorded(solver, state, data, 2, scan=True)
    assert solver.stepper is stepper and stepper.state().t == 2
    stepper.advance(1)
    want = plain.run(plain.init(problem, None, x0, y0, data), data, 3)
    for a, b in zip(torch.utils._pytree.tree_leaves(stepper.state()),
                    torch.utils._pytree.tree_leaves(want)):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)
    with pytest.raises(ValueError, match="CUDA device"):
        GraphStepper(solver, state, data)


def test_run_traced_matches_jax_run_traced(small):
    """INTERACT's ``run_traced`` against the reference's, same layout
    (eq. 11 with a 30-step inner solve on both sides)."""
    problem, x0, y0, data = small["j"]
    jsolver = j_make_solver(JConfig(algo="interact"))
    jstate = jsolver.init(None, problem, None, x0, y0, data)
    _, want = jsolver.run_traced(jstate, data, 6, 4,
                                 j_metric_fn(problem, JHypergradConfig(),
                                             data, inner_steps=30))
    problem, x0, y0, data = small["t"]
    solver = make_solver(SolverConfig(algo="interact"))
    state = solver.init(problem, None, x0, y0, data)
    _, got = solver.run_traced(state, data, 6, 4, convergence_metric_fn(
        problem, HypergradConfig(), data, inner_steps=30))
    assert got.shape == want.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TRACE_RTOL)
