"""The port's batched sweeps against the JAX package's and against itself.

The fixture is tests/test_sweep.py's (4 agents, 80 samples each, d_in 8,
a 2 x 8 tanh backbone, 3 classes, ``cg`` at 8 trips, the eq.-11 metric
at 20 inner steps), built by the JAX package and carried over as numpy
(``repro_torch.convert``); padded grids take 3- and 4-agent networks.

Tolerances.  ``ONE_STEP_TOL`` = 2e-6 is the one-step state gap of
tests/test_torch_interact.py (measured at 32 CG trips; this file's 8
leave it a thin margin, so each comparison prints its largest gap); a
trace over ``STEPS`` steps is held to ``STEPS`` times it, against the
JAX package (INTERACT, whose steps take no draws) and against the
port's own per-config ``run_traced`` (every algorithm: same generators,
same draws; a batched sum may round otherwise than an unbatched one).
Padded rows are held to the *unpadded* JAX rows, never to the
reference's padded ones (ROADMAP Queue C: its bitwise padded-vs-unpadded
claim fails on some CPUs).  The masked metric is held to the
reference's within 1e-6 relative.

The consensus kernels' vmap rules run here on their batched plain
versions; tests/test_torch_kernels_cuda.py holds the batched kernels on
the card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.solvers as jsolvers  # noqa: E402
from repro.byzantine import ByzantineConfig as JByz  # noqa: E402
from repro.consensus.compress import (  # noqa: E402
    CompressionConfig as JCompression)
from repro.hypergrad import HypergradConfig as JHypergrad  # noqa: E402
from repro.solvers.sweep import _group_by_static_key as j_groups  # noqa: E402
from repro.topology.process import (  # noqa: E402
    TopologyProcessConfig as JProcess)
from repro.topology.process import realize_stream as j_realize  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.byzantine import ByzantineConfig  # noqa: E402
from repro_torch.consensus import CompressionConfig  # noqa: E402
from repro_torch.consensus.dense import DenseEngine  # noqa: E402
from repro_torch.convert import (agent_data_from_numpy,  # noqa: E402
                                 tree_from_numpy)
from repro_torch.hypergrad import HypergradConfig  # noqa: E402
from repro_torch.kernels.consensus_step import ops, ref  # noqa: E402
from repro_torch.solvers import (SolverConfig, TopologyConfig,  # noqa: E402
                                 expand_grid, make_solver, sweep)
from repro_torch.solvers.sweep import _group_by_static_key  # noqa: E402
from repro_torch.topology.process import (  # noqa: E402
    TopologyProcessConfig, realize_stream)

M, N = 4, 80
SIZES = (3, 4)
ALGOS = ("interact", "svr-interact", "gt-dsgd", "d-sgd")
ONE_STEP_TOL = 2e-6
STEPS, EVERY = 4, 2
TRACE_RTOL = STEPS * ONE_STEP_TOL
np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)


def assert_traces_close(got, want) -> None:
    """``got`` within ``TRACE_RTOL`` of ``want``, relative; the largest
    gap is printed beside the bound (8 CG trips leave it a thin margin)."""
    got, want = np.asarray(got), np.asarray(want)
    gap = float(np.max(np.abs(got - want) / np.abs(want)))
    print(f"traces at 8 CG trips: largest relative gap {gap:.3e}, bound "
          f"{TRACE_RTOL:.1e}")
    np.testing.assert_allclose(got, want, rtol=TRACE_RTOL)


@pytest.fixture(scope="module")
def setup():
    jdatas = {m: jcore.make_synthetic_agents(
        jax.random.PRNGKey(0), num_agents=m, n_per_agent=N, d_in=8,
        num_classes=3) for m in SIZES}
    jx0 = jcore.init_mlp_backbone(jax.random.PRNGKey(1), 8, hidden=8)
    jy0 = jcore.init_head(jax.random.PRNGKey(2), 8, 3)
    jprob = jcore.MLPMetaProblem(mu_g=0.5, lipschitz_g=4.0)
    jhg = JHypergrad(method="cg", cg_iters=8)
    prob = core.MLPMetaProblem(mu_g=0.5, lipschitz_g=4.0)
    hg = HypergradConfig(method="cg", cg_iters=8)
    datas = {m: agent_data_from_numpy(np_tree(d), "cpu")
             for m, d in jdatas.items()}
    adj = core.erdos_renyi_adjacency(M, 0.5, seed=3)
    return dict(
        j=dict(problem=jprob, x0=jx0, y0=jy0, datas=jdatas, hg=jhg,
               spec=jcore.laplacian_mixing(adj),
               metric=jcore.convergence_metric_fn(jprob, jhg, jdatas[M],
                                                  inner_steps=20)),
        t=dict(problem=prob, x0=tree_from_numpy(np_tree(jx0), "cpu"),
               y0=tree_from_numpy(np_tree(jy0), "cpu"), datas=datas,
               hg=hg, spec=core.laplacian_mixing(adj),
               metric=core.convergence_metric_fn(prob, hg, datas[M],
                                                 inner_steps=20)))


def _pair(setup, algo="interact", **kw):
    """The same config in both packages: (JAX, port)."""
    out = []
    for side, cls, types in (
            ("j", jsolvers.SolverConfig, (JCompression, JProcess, JByz,
                                          jsolvers.TopologyConfig)),
            ("t", SolverConfig, (CompressionConfig, TopologyProcessConfig,
                                 ByzantineConfig, TopologyConfig))):
        s = setup[side]
        args = dict(algo=algo, alpha=0.1, beta=0.1, batch_size=6, q=5,
                    mixing=s["spec"], hypergrad=s["hg"], seed=7)
        for key, value in kw.items():
            if isinstance(value, dict):
                kind = {"compression": 0, "topology_process": 1,
                        "byzantine": 2, "topology": 3}[key]
                value = types[kind](**value)
            args[key] = value
        out.append(cls(**args))
    return tuple(out)


def _grid(setup, axes: dict, **kw):
    """The cartesian grid of ``_pair`` configs over ``axes``."""
    names = list(axes)
    rows = [dict(zip(names, vals)) for vals in
            np.array(np.meshgrid(*[np.arange(len(axes[k])) for k in names],
                                 indexing="ij")).reshape(len(names), -1).T]
    pairs = [_pair(setup, **{**kw, **{k: axes[k][i] for k, i in r.items()}})
             for r in rows]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _port_sweep(setup, configs, m=M, **kw):
    t = setup["t"]
    kw.setdefault("metric_fn", t["metric"])
    kw.setdefault("data", t["datas"][m])
    return sweep(configs, STEPS, EVERY, problem=t["problem"], x0=t["x0"],
                 y0=t["y0"], device="cpu", **kw)


def _run_traced(setup, cfg, m=M, metric=None):
    t = setup["t"]
    solver = make_solver(cfg)
    state = solver.init(t["problem"], None, t["x0"], t["y0"], t["datas"][m])
    _, trace = solver.run_traced(state, t["datas"][m], STEPS, EVERY,
                                 metric or t["metric"])
    return trace.numpy()


# -- the slice as a whole ----------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_interact_seed_alpha_sweep_matches_jax(setup, backend):
    """INTERACT's seed x alpha grid: one group in both packages, every
    row within TRACE_RTOL of the JAX package's."""
    jcfgs, tcfgs = _grid(setup, dict(seed=(0, 1), alpha=(0.1, 0.05)),
                         backend=backend)
    jcfgs = [dataclasses.replace(c, backend="dense") for c in jcfgs]
    j = setup["j"]
    want = jsolvers.sweep(jcfgs, STEPS, EVERY, problem=j["problem"],
                          x0=j["x0"], y0=j["y0"], data=j["datas"][M],
                          metric_fn=j["metric"])
    got = _port_sweep(setup, tcfgs)
    assert got.num_dispatches == want.num_dispatches == 1
    assert got.traces.shape == want.traces.shape == (4, STEPS // EVERY + 1)
    assert np.all(np.isfinite(got.traces))
    assert np.all(got.traces[:, -1] < got.traces[:, 0])
    assert_traces_close(got.traces, want.traces)


@pytest.mark.parametrize("backend", ["dense", "cuda"])
@pytest.mark.parametrize("algo", ALGOS)
def test_sweep_matches_per_config_run_traced(setup, algo, backend):
    """Each algorithm's group of two seeds and two alphas against the
    port's own per-config ``run_traced`` (same generators, same draws),
    and against its sequential replay of the single-experiment step."""
    tcfgs = [_pair(setup, algo, backend=backend, seed=s, alpha=a)[1]
             for s, a in ((0, 0.1), (1, 0.05))]
    got = _port_sweep(setup, tcfgs, compare_sequential=True)
    assert got.num_dispatches == 1
    for i, cfg in enumerate(tcfgs):
        solo = _run_traced(setup, cfg)
        assert solo[0] == got.traces[i][0]
        assert_traces_close(got.traces[i], solo)
    assert_traces_close(got.traces_sequential, got.traces)
    assert got.vmap_speedup is not None and got.measured


# -- grouping -----------------------------------------------------------------

# case: (grid axes, other fields, pad_to, the number of groups)
GROUPINGS = {
    "batch-fields": (dict(seed=(0, 1), alpha=(0.1, 0.2), beta=(0.1, 0.3)),
                     {}, None, 1),
    "algo": (dict(algo=ALGOS, seed=(0, 1)), {}, None, 4),
    "backend": (dict(seed=(0, 1), backend=("dense", "cuda")), {}, None, 2),
    "padded": (dict(num_agents=(3, 4), seed=(0, 1),
                    topology=({"kind": "ring"}, {"kind": "erdos-renyi"})),
               dict(mixing=None), 4, 1),
    "padded-algos": (dict(algo=ALGOS, num_agents=(3, 4)),
                     dict(mixing=None), 6, 4),
    "wire": (dict(compression=({"kind": "int8"}, {"kind": "sign1bit"},
                               {"kind": "int8"}),
                  communication_interval=(1, 2), seed=(0, 1)), {}, None, 4),
    "byzantine": (dict(byzantine=({"kind": "sign-flip", "num_byzantine": 1},
                                  {"kind": "sign-flip", "num_byzantine": 2},
                                  {"kind": "sign-flip", "num_byzantine": 1,
                                   "seed": 5}),
                       seed=(0, 1)), {}, None, 5),
    "byzantine-padded": (dict(byzantine=(
        {"kind": "sign-flip", "num_byzantine": 1},
        {"kind": "sign-flip", "num_byzantine": 2},
        {"kind": "gaussian", "num_byzantine": 1}), num_agents=(3, 4)),
        dict(mixing=None), 4, 2),
    "topology-process": (dict(topology_process=(
        {"kind": "link-failure", "p": 0.1}, {"kind": "link-failure",
                                              "p": 0.3},
        {"kind": "straggler", "p": 0.3}), seed=(0, 1)), {}, None, 2),
}


@pytest.mark.parametrize("case", sorted(GROUPINGS))
def test_grouping_matches_reference(setup, case):
    axes, kw, pad_to, count = GROUPINGS[case]
    jcfgs, tcfgs = _grid(setup, axes, **kw)
    want = j_groups(jcfgs, pad_to=pad_to)
    assert _group_by_static_key(tcfgs, pad_to=pad_to) == want
    assert len(want) == count
    for jc, tc in zip(jcfgs, tcfgs):
        assert tc.batch_values() == jc.batch_values()
    assert SolverConfig.BATCH_FIELDS == jsolvers.SolverConfig.BATCH_FIELDS


def test_mixing_spec_keyed_by_value(setup):
    """Two separately built equal networks share a group."""
    adj = core.erdos_renyi_adjacency(M, 0.5, seed=3)
    a = SolverConfig(mixing=core.laplacian_mixing(adj))
    b = SolverConfig(mixing=core.laplacian_mixing(adj.copy()), seed=3)
    c = SolverConfig(mixing=core.ring_mixing(M))
    assert _group_by_static_key([a, b, c]) == [[0, 1], [2]]


# -- the padding primitives ------------------------------------------------------

@pytest.mark.parametrize("kind", ["ring", "erdos-renyi"])
def test_pad_mixing_bit_equal(kind):
    spec = TopologyConfig(kind=kind).mixing_spec(5)
    jspec = jsolvers.TopologyConfig(kind=kind).mixing_spec(5)
    got = core.pad_mixing(spec, 8)
    np.testing.assert_array_equal(got, np.asarray(jcore.pad_mixing(jspec,
                                                                   8)))
    core.validate_mixing(got)
    np.testing.assert_array_equal(got[5:, 5:], np.eye(3))
    with pytest.raises(ValueError, match="cannot pad"):
        core.pad_mixing(spec, 4)
    x = torch.randn(8, 13, generator=torch.Generator().manual_seed(0))
    mixed = DenseEngine.padded(spec, 8, "cpu").mix(x)
    assert torch.equal(mixed[5:], x[5:])


def test_padded_stream_bit_equal():
    spec = TopologyConfig(kind="erdos-renyi").mixing_spec(5)
    jspec = jsolvers.TopologyConfig(kind="erdos-renyi").mixing_spec(5)
    got = realize_stream(TopologyProcessConfig("link-failure", p=0.3,
                                               period=6), spec, 3)
    want = j_realize(JProcess("link-failure", p=0.3, period=6), jspec, 3)
    gp, wp = got.padded(7), want.padded(7)
    np.testing.assert_array_equal(gp.matrices, wp.matrices)
    np.testing.assert_array_equal(gp.edge_mask, wp.edge_mask)


def test_pad_agent_data_bit_equal(setup):
    got = core.pad_agent_data(setup["t"]["datas"][3], 7)
    want = jcore.pad_agent_data(setup["j"]["datas"][3], 7)
    for name, g in zip(got._fields, got):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(getattr(want, name)))
    assert core.pad_agent_data(setup["t"]["datas"][3], 3) is \
        setup["t"]["datas"][3]


# -- the masked metric --------------------------------------------------------

def _spread(tree, m, seed):
    """Per-agent copies of ``tree`` with agent-specific perturbations."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda l: np.asarray(l)[None] + 0.1 * rng.standard_normal(
            (m,) + np.shape(l)).astype(np.float32), np_tree(tree))


@pytest.mark.parametrize("num_active", [2, 3])
def test_masked_metric_matches_reference(setup, num_active):
    j, t = setup["j"], setup["t"]
    data = jcore.pad_agent_data(j["datas"][3], 6)
    x, y = _spread(j["x0"], 6, 0), _spread(j["y0"], 6, 1)
    masked = jax.jit(jcore.masked_convergence_metric,
                     static_argnums=(0, 1, 4, 5))
    want = masked(j["problem"], j["hg"],
                  jax.tree_util.tree_map(jnp.asarray, x),
                  jax.tree_util.tree_map(jnp.asarray, y), 20, 0.5, data,
                  jnp.int32(num_active))
    got = core.masked_convergence_metric(
        t["problem"], t["hg"], tree_from_numpy(x, "cpu"),
        tree_from_numpy(y, "cpu"), 20, 0.5,
        agent_data_from_numpy(np_tree(data), "cpu"),
        torch.tensor(num_active))
    for name in got._fields:
        assert float(getattr(got, name)) == pytest.approx(
            float(getattr(want, name)), rel=1e-6, abs=1e-9), name


def test_masked_metric_at_full_occupancy_equals_unmasked(setup):
    t = setup["t"]
    x = tree_from_numpy(_spread(setup["j"]["x0"], M, 2), "cpu")
    y = tree_from_numpy(_spread(setup["j"]["y0"], M, 3), "cpu")
    plain = core.convergence_metric(t["problem"], t["hg"], x, y, 20, 0.5,
                                    t["datas"][M])
    masked = core.masked_convergence_metric(t["problem"], t["hg"], x, y, 20,
                                            0.5, t["datas"][M],
                                            torch.tensor(M))
    for name in plain._fields:
        assert float(getattr(masked, name)) == pytest.approx(
            float(getattr(plain, name)), rel=1e-6), name


# -- padded groups -------------------------------------------------------------

def _padded_grid(setup, algo, **kw):
    """3 agents on a ring and 4 on ER(0.5): one padded group."""
    pairs = [_pair(setup, algo, mixing=None, num_agents=m,
                   topology={"kind": kind}, **kw)
             for m, kind in zip(SIZES, ("ring", "erdos-renyi"))]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _masked(setup):
    t = setup["t"]
    return core.masked_convergence_metric_fn(t["problem"], t["hg"],
                                             inner_steps=20)


def test_padded_interact_matches_unpadded_jax(setup):
    """INTERACT over 3 agents on a ring and 4 on ER: one padded group,
    each row within TRACE_RTOL of the JAX package's unpadded run of it."""
    j, t = setup["j"], setup["t"]
    jcfgs, tcfgs = _padded_grid(setup, "interact")
    metric = jcore.convergence_metric_fn
    want = np.stack([jsolvers.sweep(
        [c], STEPS, EVERY, problem=j["problem"], x0=j["x0"], y0=j["y0"],
        data=j["datas"][c.num_agents],
        metric_fn=metric(j["problem"], j["hg"], j["datas"][c.num_agents],
                         inner_steps=20)).traces[0] for c in jcfgs])
    got = sweep(tcfgs, STEPS, EVERY, problem=t["problem"], x0=t["x0"],
                y0=t["y0"], data=t["datas"], metric_fn=_masked(setup),
                pad_agents=True, device="cpu")
    assert got.num_dispatches == 1 and got.pad_to == 4
    assert got.groups[0].num_active == SIZES
    assert_traces_close(got.traces, want)


@pytest.mark.parametrize("algo", ALGOS[1:])
def test_padded_sweep_matches_unpadded_port(setup, algo):
    """The stochastic solvers, padded against the port's unpadded runs:
    the padded sampler's active rows are the unpadded draws."""
    t = setup["t"]
    _, tcfgs = _padded_grid(setup, algo)
    got = sweep(tcfgs, STEPS, EVERY, problem=t["problem"], x0=t["x0"],
                y0=t["y0"], data=t["datas"], metric_fn=_masked(setup),
                pad_agents=True, device="cpu")
    assert got.num_dispatches == 1
    for i, cfg in enumerate(tcfgs):
        m = cfg.num_agents
        solo = _run_traced(setup, cfg, m, core.convergence_metric_fn(
            t["problem"], t["hg"], t["datas"][m], inner_steps=20))
        assert_traces_close(got.traces[i], solo)


@pytest.mark.parametrize("extra", [1, 3])
def test_ghost_rows_never_change_active_trajectory(setup, extra):
    """However many ghosts sit on top of the largest network, the active
    rows' final states and the traces stay as they were."""
    t = setup["t"]
    _, tcfgs = _grid(setup, dict(seed=(0, 1)), algo="svr-interact",
                     mixing=None, num_agents=4,
                     topology={"kind": "ring"})
    run = lambda pad_to: sweep(
        tcfgs, STEPS, EVERY, problem=t["problem"], x0=t["x0"], y0=t["y0"],
        data=t["datas"], metric_fn=_masked(setup), pad_agents=True,
        pad_to=pad_to, return_states=True, device="cpu")
    base, padded = run(4), run(4 + extra)
    np.testing.assert_allclose(padded.traces, base.traces, rtol=1e-6)
    for a, b in zip(base.states, padded.states):
        for la, lb in zip(torch.utils._pytree.tree_leaves((a.x, a.y, a.u)),
                          torch.utils._pytree.tree_leaves((b.x, b.y, b.u))):
            torch.testing.assert_close(lb[:4], la, rtol=1e-6, atol=1e-7)


def test_padded_sampler_active_rows_equal_unpadded():
    plain = core.Sampler(torch.Generator().manual_seed(3), 3, 50, 20, 6, 4)
    padded = core.Sampler(torch.Generator().manual_seed(3), 3, 50, 20, 6, 4,
                          pad_to=7)
    a, b = plain.draw(5, "cpu"), padded.draw(5, "cpu")
    ghost = torch.arange(7) % 3
    for fa, fb in zip(a, b):
        assert fb.shape[1] == 7
        assert torch.equal(fb[:, :3], fa)
        assert torch.equal(fb, fa[:, ghost])
    assert padded.zeros("cpu").inner.shape == (7, 6)


def test_padded_byzantine_group_matches_unpadded_port(setup):
    """Attacker count x network size: one padded group; each row's
    trace against the port's unpadded run of it (masks bound by the
    active count, noise rows independent of m)."""
    t = setup["t"]
    _, tcfgs = _grid(setup, dict(num_agents=SIZES, byzantine=(
        {"kind": "gaussian", "num_byzantine": 1, "scale": 2.0},
        {"kind": "gaussian", "num_byzantine": 2, "scale": 1.0})),
        algo="gt-dsgd", mixing=None, topology={"kind": "ring"})
    got = sweep(tcfgs, STEPS, EVERY, problem=t["problem"], x0=t["x0"],
                y0=t["y0"], data=t["datas"], metric_fn=_masked(setup),
                pad_agents=True, device="cpu")
    assert got.num_dispatches == 1
    for i, cfg in enumerate(tcfgs):
        m = cfg.num_agents
        solo = _run_traced(setup, cfg, m, core.convergence_metric_fn(
            t["problem"], t["hg"], t["datas"][m], inner_steps=20))
        assert_traces_close(got.traces[i], solo)


def test_stream_group_matches_per_config_run_traced(setup):
    """Failure rate x seed over link-failure: one dense group, each
    experiment on its own realized stream."""
    _, tcfgs = _grid(setup, dict(topology_process=(
        {"kind": "link-failure", "p": 0.2, "period": 3},
        {"kind": "link-failure", "p": 0.5, "period": 3}), seed=(0, 1)),
        algo="gt-dsgd")
    got = _port_sweep(setup, tcfgs)
    assert got.num_dispatches == 1
    for i, cfg in enumerate(tcfgs):
        assert_traces_close(got.traces[i], _run_traced(setup, cfg))


# -- diagnostics --------------------------------------------------------------

def _both_raise(setup, jcfgs, tcfgs, j_kw, t_kw):
    """The port's sweep and the reference's raise one message."""
    j, t = setup["j"], setup["t"]
    with pytest.raises(ValueError) as want:
        jsolvers.sweep(jcfgs, STEPS, EVERY, problem=j["problem"],
                       x0=j["x0"], y0=j["y0"], **j_kw)
    with pytest.raises(ValueError) as got:
        sweep(tcfgs, STEPS, EVERY, problem=t["problem"], x0=t["x0"],
              y0=t["y0"], device="cpu", **t_kw)
    return str(got.value), str(want.value)


DIAGNOSTICS = ["mixed-m", "pad-agents-cuda", "pad-to-small",
               "mixed-samples", "mixed-streams-cuda"]


@pytest.mark.parametrize("case", DIAGNOSTICS)
def test_diagnostics_raise_with_reference_messages(setup, case):
    j, t = setup["j"], setup["t"]
    if case == "mixed-m":
        jc, tc = _padded_grid(setup, "interact")
        got, want = _both_raise(setup, jc, tc, dict(data=j["datas"][4]),
                                dict(data=t["datas"][4]))
        # the offending configs' static keys print each package's types
        got, want = got.split("Offending")[0], want.split("Offending")[0]
    elif case == "pad-agents-cuda":
        jc, tc = _padded_grid(setup, "interact", backend="cuda")
        jc = [dataclasses.replace(c, backend="pallas") for c in jc]
        got, want = _both_raise(setup, jc, tc, dict(
            data=j["datas"], pad_agents=True), dict(
            data=t["datas"], pad_agents=True))
        want = want.replace("'pallas'", "'cuda'")
    elif case == "pad-to-small":
        jc, tc = _padded_grid(setup, "interact")
        got, want = _both_raise(setup, jc, tc, dict(
            data=j["datas"], pad_agents=True, pad_to=3), dict(
            data=t["datas"], pad_agents=True, pad_to=3))
    elif case == "mixed-samples":
        jc, tc = _padded_grid(setup, "interact")
        jd = dict(j["datas"])
        jd[3] = jcore.make_synthetic_agents(jax.random.PRNGKey(0), 3, 40,
                                            d_in=8, num_classes=3)
        td = dict(t["datas"])
        td[3] = agent_data_from_numpy(np_tree(jd[3]), "cpu")
        got, want = _both_raise(setup, jc, tc, dict(data=jd,
                                                    pad_agents=True),
                                dict(data=td, pad_agents=True))
    else:
        jc, tc = _grid(setup, dict(topology_process=(
            {"kind": "link-failure", "p": 0.2},
            {"kind": "link-failure", "p": 0.5})), backend="cuda")
        jc = [dataclasses.replace(c, backend="pallas") for c in jc]
        got, want = _both_raise(setup, jc, tc, dict(data=j["datas"][M]),
                                dict(data=t["datas"][M]))
        want = want.replace("'pallas'", "'cuda'")
    assert got == want


def test_sweep_without_device_raises_without_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA card")
    _, tc = _pair(setup)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep([tc], 1, n_per_agent=20)


def test_expand_grid_is_row_major():
    grid = expand_grid(SolverConfig(), seed=range(2), alpha=(0.3, 0.1))
    assert [(c.seed, c.alpha) for c in grid] == [
        (0, 0.3), (0, 0.1), (1, 0.3), (1, 0.1)]


# -- the kernels' vmap rules on the CPU -----------------------------------------

@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-exp"])
@pytest.mark.parametrize("kernel", ["consensus_step", "consensus_mix"])
def test_vmap_rule_matches_loop_of_plain_calls(kernel, shared):
    """Under ``vmap`` the wrappers reach the batched plain version; each
    experiment's slice equals an unbatched plain call on it."""
    gen = torch.Generator().manual_seed(0)
    B, m, d = 3, 5, 37
    mats = torch.rand(B, m, m, generator=gen)
    x, u, p, pp = (torch.randn(B, m, d, generator=gen) for _ in range(4))
    alpha = torch.tensor([0.3, 0.1, 0.2])
    M = (lambda b: mats[0]) if shared else (lambda b: mats[b])
    if kernel == "consensus_step":
        fn = lambda Mb, x, u, p, pp, a: ops.consensus_step(
            Mb, x, u, p, pp, alpha=a)
        got = torch.func.vmap(fn, in_dims=(None if shared else 0, 0, 0, 0,
                                           0, 0))(
            mats[0] if shared else mats, x, u, p, pp, alpha)
        for b in range(B):
            want = ref.consensus_step_ref(M(b), x[b], u[b], p[b], pp[b],
                                          alpha=float(alpha[b]))
            for g, w in zip(got, want):
                torch.testing.assert_close(g[b], w, rtol=1e-6, atol=1e-6)
    else:
        got = torch.func.vmap(ops.consensus_mix,
                              in_dims=(None if shared else 0, 0))(
            mats[0] if shared else mats, x)
        for b in range(B):
            torch.testing.assert_close(got[b], ref.consensus_mix_ref(M(b),
                                                                     x[b]),
                                       rtol=1e-6, atol=1e-6)
