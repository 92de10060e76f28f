"""SVR-INTERACT, GT-DSGD and D-SGD of the port against the JAX package's.

The JAX solvers run the Section-6 instance at a small size (4 agents,
n = 40, hidden 8, q = 4, |S| = 5) for 10 steps.  Each step's random draws
are rebuilt here with ``jax.random`` exactly as the reference derives
them from its state key (``per_agent_keys`` and the splits of
``repro.core.svr_interact`` and ``repro.core.baselines``) and handed to
the port's step through its ``Draws`` seam, so both packages take the
same minibatches and the same Neumann k.  The port's states are held
against the reference's field by field, relative to each field's
largest magnitude:
- ``ONE_STEP_TOL`` = 2e-6 (the INTERACT bound of
  tests/test_torch_interact.py): one step from the reference's state;
  measured at most 1.04e-6 over every one of the ten steps, algorithms,
  hypergradients and backends (SVR-INTERACT, Neumann, step 8).
- ``TRAJ_TOL`` = 10 * ``ONE_STEP_TOL`` = 2e-5: ten steps from the
  reference's initial state; measured at most 1.6e-6.
Both run with the ``cg`` hypergradient (the default) and the stochastic
Neumann one (K = 4), on the port's ``dense`` and ``cuda`` backends (the
latter on CPU tensors: its kernels' plain versions).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.svr_interact import per_agent_keys  # noqa: E402
from repro.hypergrad import HypergradConfig as JHypergradConfig  # noqa: E402
from repro.solvers import SolverConfig as JConfig  # noqa: E402
from repro.solvers import default_setup as j_default_setup  # noqa: E402
from repro.solvers import make_solver as j_make_solver  # noqa: E402
from repro_torch.convert import (agent_data_from_numpy,  # noqa: E402
                                 state_from_numpy, tree_from_numpy)
from repro_torch.core import (Draws, DsgdState, GtDsgdState,  # noqa: E402
                              MLPMetaProblem, SvrState, init_gt_dsgd_state,
                              init_svr_state)
from repro_torch.hypergrad import HypergradConfig  # noqa: E402
from repro_torch.solvers import SolverConfig, make_solver  # noqa: E402

ONE_STEP_TOL = 2e-6
TRAJ_TOL = 10 * ONE_STEP_TOL
M, N, Q, BS, K = 4, 40, 4, 5, 4
NUM_STEPS = 10
KINDS = {"svr-interact": SvrState, "gt-dsgd": GtDsgdState,
         "d-sgd": DsgdState}
HG = {"cg": dict(),
      "neumann": dict(method="neumann", neumann_k=K, lipschitz_g=4.0,
                      stochastic_k=True)}
np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)


def agent_draws(agent_keys, how: str, n_inner: int, n_outer: int) -> Draws:
    """The draws the reference makes from per-agent keys: ``full`` (the
    Neumann k from the key itself), ``minibatch`` (a 3-way split into
    inner, outer and k keys) or ``recursive`` (the minibatch draws of the
    first half of a 2-way split)."""
    def one(key):
        if how == "full":
            zero = jnp.zeros((BS,), jnp.int32)
            return zero, zero, jax.random.randint(key, (), 0, K)
        if how == "recursive":
            key = jax.random.split(key)[0]
        k_in, k_out, k_neu = jax.random.split(key, 3)
        return (jax.random.randint(k_in, (BS,), 0, n_inner),
                jax.random.randint(k_out, (BS,), 0, n_outer),
                jax.random.randint(k_neu, (), 0, K))

    inner, outer, k = jax.vmap(one)(agent_keys)
    return Draws(*(torch.tensor(np.asarray(a), dtype=torch.int64)
                   for a in (inner, outer, k)))


def step_draws_of(algo: str, key, t: int, n_inner: int, n_outer: int):
    """The draws of the reference's step from a state with ``key``, ``t``."""
    agent_keys = per_agent_keys(jax.random.split(key)[1], M)
    if algo != "svr-interact":
        return agent_draws(agent_keys, "minibatch", n_inner, n_outer)
    how = "full" if (t + 1) % Q == 0 else "recursive"
    return agent_draws(agent_keys, how, n_inner, n_outer)


@pytest.fixture(scope="module")
def instance():
    problem, x0, y0, data = j_default_setup(0, num_agents=M, n_per_agent=N,
                                            hidden=8)
    return dict(problem=problem, x0=x0, y0=y0, data=data,
                n_inner=data.inner_x.shape[1], n_outer=data.outer_x.shape[1],
                tproblem=MLPMetaProblem(mu_g=0.5, lipschitz_g=4.0),
                tx0=tree_from_numpy(np_tree(x0), "cpu"),
                ty0=tree_from_numpy(np_tree(y0), "cpu"),
                tdata=agent_data_from_numpy(np_tree(data), "cpu"))


@pytest.fixture(scope="module")
def runs(instance):
    """The reference's runs, made on first use and kept for the module."""
    return {}


def reference_run(instance, runs, algo: str, hg: str):
    """The reference's states 0..NUM_STEPS (numpy) and the draws of each
    of its steps."""
    if (algo, hg) not in runs:
        solver = j_make_solver(JConfig(algo=algo, q=Q, batch_size=BS,
                                       backend="dense",
                                       hypergrad=JHypergradConfig(**HG[hg])))
        state = solver.init(None, instance["problem"], None, instance["x0"],
                            instance["y0"], instance["data"])
        states, draws = [np_tree(state)], []
        for t in range(NUM_STEPS):
            draws.append(step_draws_of(algo, states[-1].key, t,
                                       instance["n_inner"],
                                       instance["n_outer"]))
            state = solver.step(jax.tree_util.tree_map(jnp.asarray,
                                                       states[-1]),
                                instance["data"])
            states.append(np_tree(state))
        runs[algo, hg] = states, draws
    return runs[algo, hg]


def port_solver(instance, algo, hg, backend):
    solver = make_solver(SolverConfig(algo=algo, q=Q, batch_size=BS,
                                      backend=backend))
    return solver.build(instance["tproblem"], HypergradConfig(**HG[hg]),
                        device="cpu", m=M, n=N)


def gaps(port_state, ref_state, kind) -> dict:
    """Largest |port - ref| of each field over that field's largest |ref|;
    a field the reference leaves ``None`` (the wire state ``ef`` of an
    uncompressed run) must be ``None`` in the port too."""
    out = {}
    for f in kind._fields:
        if f == "t":
            continue
        if getattr(ref_state, f) is None:
            assert getattr(port_state, f) is None, f
            continue
        got = [l.numpy() for l in
               torch.utils._pytree.tree_leaves(getattr(port_state, f))]
        want = jax.tree_util.tree_leaves(getattr(ref_state, f))
        scale = max(float(np.max(np.abs(w))) for w in want)
        out[f] = max(float(np.max(np.abs(g - w)))
                     for g, w in zip(got, want)) / scale
    return out


@pytest.mark.parametrize("hg", sorted(HG))
@pytest.mark.parametrize("algo", ["svr-interact", "gt-dsgd"])
def test_init_state_matches_reference(instance, runs, algo, hg):
    states, _ = reference_run(instance, runs, algo, hg)
    key = jax.random.split(jax.random.PRNGKey(0))[1]
    how = "full" if algo == "svr-interact" else "minibatch"
    draws = agent_draws(per_agent_keys(key, M), how, instance["n_inner"],
                        instance["n_outer"])
    init = init_svr_state if algo == "svr-interact" else init_gt_dsgd_state
    state = init(instance["tproblem"], HypergradConfig(**HG[hg]),
                 instance["tx0"], instance["ty0"], instance["tdata"], draws)
    assert state.t == 0
    g = gaps(state, states[0], KINDS[algo])
    assert max(g.values()) < ONE_STEP_TOL, g


@pytest.mark.parametrize("backend", ["dense", "cuda"])
@pytest.mark.parametrize("hg", sorted(HG))
@pytest.mark.parametrize("algo,t", [("svr-interact", 3),
                                    ("svr-interact", 4),
                                    ("gt-dsgd", 4), ("d-sgd", 4)],
                         ids=["svr-refresh", "svr-recursive", "gt-dsgd",
                              "d-sgd"])
def test_one_step_from_reference_state(instance, runs, algo, t, hg,
                                       backend):
    states, draws = reference_run(instance, runs, algo, hg)
    kind = KINDS[algo]
    solver = port_solver(instance, algo, hg, backend)
    state = solver.step(state_from_numpy(states[t], "cpu", kind),
                        instance["tdata"], draws[t])
    assert state.t == t + 1
    g = gaps(state, states[t + 1], kind)
    assert max(g.values()) < ONE_STEP_TOL, g


@pytest.mark.parametrize("backend", ["dense", "cuda"])
@pytest.mark.parametrize("hg", sorted(HG))
@pytest.mark.parametrize("algo", ["svr-interact", "gt-dsgd", "d-sgd"])
def test_trajectory_matches_reference(instance, runs, algo, hg, backend):
    """Ten steps from the reference's initial state; SVR-INTERACT crosses
    the refreshes at t = 3 and 7."""
    states, draws = reference_run(instance, runs, algo, hg)
    kind = KINDS[algo]
    solver = port_solver(instance, algo, hg, backend)
    state = state_from_numpy(states[0], "cpu", kind)
    for t in range(NUM_STEPS):
        state = solver.step(state, instance["tdata"], draws[t])
    assert state.t == NUM_STEPS
    g = gaps(state, states[NUM_STEPS], kind)
    assert max(g.values()) < TRAJ_TOL, g


@pytest.mark.parametrize("q,batch_size", [(None, None), (7, None), (3, 11)])
@pytest.mark.parametrize("n", [40, 600])
@pytest.mark.parametrize("algo", ["interact", "svr-interact", "gt-dsgd",
                                  "d-sgd"])
def test_registry_costs_match_reference(algo, n, q, batch_size):
    got = make_solver(SolverConfig(algo=algo, q=q, batch_size=batch_size))
    want = j_make_solver(JConfig(algo=algo, q=q, batch_size=batch_size))
    assert got.samples_per_step(n) == want.samples_per_step(n)
    assert got.hypergrad_calls_per_step(n) == want.hypergrad_calls_per_step(n)
    assert got.communications_per_step == want.communications_per_step
    config = SolverConfig(q=q, batch_size=batch_size)
    jconfig = JConfig(q=q, batch_size=batch_size)
    assert config.resolve_q(n) == jconfig.resolve_q(n)
    assert config.resolve_batch(n) == jconfig.resolve_batch(n)


def test_sampler_draws_do_not_depend_on_chunking(instance):
    """A step's draws are the same whether drawn alone or with others,
    and ``init`` takes the first step's draws from ``config.seed``."""
    solver = make_solver(SolverConfig(algo="gt-dsgd", q=Q, batch_size=BS,
                                      seed=3))
    solver.init(instance["tproblem"], None, instance["tx0"],
                instance["ty0"], instance["tdata"])
    together = solver.draw(3, "cpu")
    again = make_solver(SolverConfig(algo="gt-dsgd", q=Q, batch_size=BS,
                                     seed=3))
    again.init(instance["tproblem"], None, instance["tx0"], instance["ty0"],
               instance["tdata"])
    apart = [again.draw(1, "cpu") for _ in range(3)]
    for field, stacked in zip(Draws._fields, together):
        assert torch.equal(stacked, torch.cat([getattr(d, field)
                                               for d in apart]))
    assert together.inner.shape == (3, M, BS)
    assert int(together.inner.max()) < instance["n_inner"]
    assert int(together.outer.max()) < instance["n_outer"]
    assert together.k.shape == (3, M) and int(together.k.max()) < 8
