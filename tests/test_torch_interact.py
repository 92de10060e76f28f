"""One INTERACT step of the port against the JAX package's.

The JAX solver runs 3 steps of the Section-6 instance (5 agents at full
widths, n = 100); its state crosses to the port through
``repro_torch.convert``, the port steps it once, and the result is held
against JAX's step 4.  This one-step gap is what sets the trace
tolerance of tests/test_torch_solve.py.

Measured on the CPU: the largest gap of any state field is 4.4e-7 of
that field's largest magnitude (the v field; x 7.8e-8).  ``ONE_STEP_TOL``
allows 2e-6, a margin of about 4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.core import convergence_metric as j_metric  # noqa: E402
from repro.hypergrad import HypergradConfig as JHypergradConfig  # noqa: E402
from repro.solvers import SolverConfig as JConfig  # noqa: E402
from repro.solvers import default_setup as j_default_setup  # noqa: E402
from repro.solvers import make_solver as j_make_solver  # noqa: E402
from repro_torch.convert import (agent_data_from_numpy,  # noqa: E402
                                 state_from_numpy, tree_from_numpy)
from repro_torch.core import MLPMetaProblem, convergence_metric  # noqa: E402
from repro_torch.core import init_state  # noqa: E402
from repro_torch.hypergrad import HypergradConfig  # noqa: E402
from repro_torch.solvers import SolverConfig, make_solver  # noqa: E402

ONE_STEP_TOL = 2e-6
FIELDS = ("x", "y", "u", "v", "p_prev")
np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def run():
    problem, x0, y0, data = j_default_setup(0, num_agents=5, n_per_agent=100)
    solver = j_make_solver(JConfig(algo="interact", backend="dense"))
    states = [solver.init(None, problem, None, x0, y0, data)]
    states[0] = np_tree(states[0])  # the step donates its input buffers
    for _ in range(4):
        states.append(np_tree(solver.step(jax.tree_util.tree_map(
            jax.numpy.asarray, states[-1]), data)))
    return dict(problem=problem, data=data, states=states,
                x0=np_tree(x0), y0=np_tree(y0),
                tdata=agent_data_from_numpy(np_tree(data), "cpu"),
                tproblem=MLPMetaProblem(mu_g=0.5, lipschitz_g=4.0))


def _gap(port_state, jax_state):
    """Largest |port - jax| of each field over that field's largest |jax|."""
    out = {}
    for f in FIELDS:
        got = [l.numpy() for l in
               torch.utils._pytree.tree_leaves(getattr(port_state, f))]
        want = jax.tree_util.tree_leaves(getattr(jax_state, f))
        scale = max(float(np.max(np.abs(w))) for w in want)
        out[f] = max(float(np.max(np.abs(g - w)))
                     for g, w in zip(got, want)) / scale
    return out


def test_init_state_matches(run):
    state = init_state(run["tproblem"], HypergradConfig(),
                       tree_from_numpy(run["x0"], "cpu"),
                       tree_from_numpy(run["y0"], "cpu"), run["tdata"])
    assert state.t == 0
    gaps = _gap(state, run["states"][0])
    assert max(gaps.values()) < ONE_STEP_TOL, gaps


@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_one_step_from_jax_state_matches_jax_step(run, backend):
    solver = make_solver(SolverConfig(algo="interact", backend=backend))
    solver.build(run["tproblem"], device="cpu", m=5)
    state3 = state_from_numpy(run["states"][3], "cpu")
    assert state3.t == 3
    state4 = solver.step(state3, run["tdata"])
    assert state4.t == 4
    gaps = _gap(state4, run["states"][4])
    assert max(gaps.values()) < ONE_STEP_TOL, gaps


def test_convergence_metric_matches(run):
    jstate = run["states"][4]
    as_jax = lambda t: jax.tree_util.tree_map(jax.numpy.asarray, t)
    want = j_metric(run["problem"], JHypergradConfig(), as_jax(jstate.x),
                    as_jax(jstate.y), 300, 0.5, run["data"])
    tstate = state_from_numpy(jstate, "cpu")
    got = convergence_metric(run["tproblem"], HypergradConfig(), tstate.x,
                             tstate.y, 300, 0.5, run["tdata"])
    for name in got._fields:
        assert float(getattr(got, name)) == pytest.approx(
            float(getattr(want, name)), rel=1e-5, abs=1e-9), name
