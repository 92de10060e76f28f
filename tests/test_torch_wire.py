"""The port's compressed wire and measured-bytes ledger against the JAX
package's.

Compressors, on one (m, D) buffer from a numpy seed, against the JAX
package's ``vmap`` of ``encode_decode``: ``none`` and ``topk`` exactly;
``sign1bit`` within ``SIGN_RTOL`` = 1e-6 relative (its mean sums in
another order: one ulp measured); ``int8`` within one quantum of the
row's scale, on at most ``INT8_SHARE`` = 1% of the entries (a division
that rounds to the other side of a half; none measured).  Byte counts are
integers and must be equal.

One step from the JAX package's own state: the JAX solver runs each of
the six wire and topology configurations of ``chip_smoke.py``'s ``wire``
phase on the Section-6 instance at a small size (m = 5, n = 40 per
agent, ``cg`` at 8 trips, q = 4, |S| = 5) for 7 steps; at a warm-up, a
compressed and a silent step (where the configuration has them) the
port takes the reference's state, wire state included
(``state_from_numpy``), and, for the stochastic algorithms, the
reference's draws (rebuilt from its key as
tests/test_torch_svr_baselines.py does), and must land on the
reference's next state within ``ONE_STEP_TOL`` = 2e-6 of each field's
scale (the bound of tests/test_torch_interact.py), on both backends.
The topk selection then sees identical inputs, so it picks identical
entries.

The one-step bound was measured at 32 CG trips (tests/test_torch_interact.py);
at this file's 8 the unconverged solve amplifies float32 order
differences and leaves it little margin, so each one-step case prints
its largest gap beside the bound.  Two more INTERACT rows, the
``random-gossip`` (period 10) and ``straggler`` (p = 0.3, period 10)
processes, run at 32 trips (``TRIPS_32_CONFIGS``) under the same bound.

The ledger: ``solve(...).measured_wire_bytes`` equals the JAX package's
priced ``cumulative_wire_bytes`` integer for integer over a kind x
``compress_after`` x interval grid, and the JAX ``solve``'s measured
bytes on three of its points.  The ``none`` compressor with interval 1
and the ``static`` process are the old path bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.consensus import CompressionConfig as JCompression  # noqa: E402
from repro.consensus import attach_ledger as j_attach_ledger  # noqa: E402
from repro.consensus import cumulative_wire_bytes as j_priced  # noqa: E402
from repro.consensus import init_ef as j_init_ef  # noqa: E402
from repro.consensus import make_compressor as j_make_compressor  # noqa: E402
from repro.consensus import make_engine as j_make_engine  # noqa: E402
from repro.core import ring_mixing as j_ring_mixing  # noqa: E402
from repro.core.svr_interact import per_agent_keys  # noqa: E402
from repro.hypergrad import HypergradConfig as JHypergradConfig  # noqa: E402
from repro.solvers import SolverConfig as JConfig  # noqa: E402
from repro.solvers import default_setup as j_default_setup  # noqa: E402
from repro.solvers import make_solver as j_make_solver  # noqa: E402
from repro.solvers import solve as j_solve  # noqa: E402
from repro.topology import TopologyProcessConfig as JTopology  # noqa: E402
from repro_torch.consensus import (CommsLedger,  # noqa: E402
                                   CompressionConfig, attach_ledger,
                                   cumulative_wire_bytes, init_ef,
                                   make_compressor, make_engine)
from repro_torch.convert import (agent_data_from_numpy,  # noqa: E402
                                 state_from_numpy, tree_from_numpy)
from repro_torch.core import (Draws, DsgdState, GtDsgdState,  # noqa: E402
                              InteractState, MLPMetaProblem, SvrState,
                              ring_mixing)
from repro_torch.hypergrad import HypergradConfig  # noqa: E402
from repro_torch.solvers import SolverConfig, make_solver, solve  # noqa: E402
from repro_torch.topology import TopologyProcessConfig  # noqa: E402

SIGN_RTOL = 1e-6
INT8_SHARE = 0.01
ONE_STEP_TOL = 2e-6
KINDS = ("none", "int8", "sign1bit", "topk")
M, N, Q, BS, K = 5, 40, 4, 5, 8
CG_TRIPS = 8
NUM_STEPS = 7
STATES = {"interact": InteractState, "svr-interact": SvrState,
          "gt-dsgd": GtDsgdState, "d-sgd": DsgdState}
# chip_smoke.py's wire rows: (algo, options, the steps held here).
# sign1bit-ef-warm5-k2: step 4 warms up, 5 is silent, 6 compresses;
# SVR-INTERACT refreshes at step 3 (q = 4).
CONFIGS = {
    "sign1bit-ef-warm5-k2": ("interact", dict(
        compression=dict(kind="sign1bit", compress_after=5),
        communication_interval=2), (4, 5, 6)),
    "topk-gamma0.5": ("interact", dict(
        compression=dict(kind="topk", topk_frac=0.05, gamma=0.5)), (0, 3)),
    "int8-ef-svr-interact": ("svr-interact", dict(
        compression=dict(kind="int8")), (2, 3)),
    "int8-ef-d-sgd": ("d-sgd", dict(compression=dict(kind="int8")), (0, 3)),
    "link-failure-0.3": ("gt-dsgd", dict(topology_process=dict(
        kind="link-failure", p=0.3, period=40)), (0, 1, 5)),
    "adaptive": ("interact", dict(topology_process=dict(
        kind="adaptive", tau=1.0)), (0, 3)),
}
# INTERACT one-step rows at the bound's own trip count
TRIPS_32 = 32
TRIPS_32_CONFIGS = {
    "random-gossip-10": ("interact", dict(topology_process=dict(
        kind="random-gossip", period=10)), (0, 3, 6)),
    "straggler-0.3": ("interact", dict(topology_process=dict(
        kind="straggler", p=0.3, period=10)), (0, 3, 6)),
}
np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)


def config_pair(algo, opts, backend="dense", cg_iters=CG_TRIPS, **extra):
    """The JAX package's and the port's ``SolverConfig`` for ``opts``."""
    common = dict(algo=algo, q=Q, batch_size=BS, seed=0, **extra)
    j, t = dict(common), dict(common, backend=backend)
    if "compression" in opts:
        j["compression"] = JCompression(**opts["compression"])
        t["compression"] = CompressionConfig(**opts["compression"])
    if "topology_process" in opts:
        j["topology_process"] = JTopology(**opts["topology_process"])
        t["topology_process"] = TopologyProcessConfig(
            **opts["topology_process"])
    if "communication_interval" in opts:
        j["communication_interval"] = t["communication_interval"] = opts[
            "communication_interval"]
    return (JConfig(**j, hypergrad=JHypergradConfig(cg_iters=cg_iters)),
            SolverConfig(**t, hypergrad=HypergradConfig(cg_iters=cg_iters)))


def agent_draws(agent_keys, how: str, n_inner: int, n_outer: int) -> Draws:
    """The draws the reference makes from per-agent keys (see
    tests/test_torch_svr_baselines.py): ``full``, ``minibatch`` or
    ``recursive``."""
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


def step_draws_of(algo: str, state, t: int, n_inner: int, n_outer: int):
    """The draws of the reference's step from ``state`` (None for
    INTERACT, which draws nothing)."""
    if algo == "interact":
        return None
    agent_keys = per_agent_keys(jax.random.split(state.key)[1], M)
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
def runs():
    """The reference's runs, made on first use and kept for the module."""
    return {}


def trips_of(name: str) -> int:
    return TRIPS_32 if name in TRIPS_32_CONFIGS else CG_TRIPS


def reference_run(instance, runs, name: str):
    """The reference's states 0..NUM_STEPS (numpy) and each step's draws."""
    if name not in runs:
        algo, opts, _ = CONFIGS.get(name) or TRIPS_32_CONFIGS[name]
        jconfig, _ = config_pair(algo, opts, cg_iters=trips_of(name))
        solver = j_make_solver(jconfig)
        state = solver.init(None, instance["problem"], None, instance["x0"],
                            instance["y0"], instance["data"])
        states, draws = [np_tree(state)], []
        for t in range(NUM_STEPS):
            draws.append(step_draws_of(algo, states[-1], t,
                                       instance["n_inner"],
                                       instance["n_outer"]))
            state = solver.step(jax.tree_util.tree_map(jnp.asarray,
                                                       states[-1]),
                                instance["data"])
            states.append(np_tree(state))
        runs[name] = states, draws
    return runs[name]


def gaps(port_state, ref_state, kind) -> dict:
    """Largest |port - ref| of each field over that field's largest |ref|
    (the wire state's leaves in the reference's sorted-key order, which
    the port keeps); a field the reference leaves ``None`` must be
    ``None`` in the port too."""
    out = {}
    for f in kind._fields:
        if f == "t":
            continue
        want = getattr(ref_state, f)
        if want is None:
            assert getattr(port_state, f) is None, f
            continue
        got = [l.numpy() for l in
               torch.utils._pytree.tree_leaves(getattr(port_state, f))]
        want = jax.tree_util.tree_leaves(want)
        assert [g.shape for g in got] == [w.shape for w in want], f
        scale = max(float(np.max(np.abs(w))) for w in want) or 1.0
        out[f] = max(float(np.max(np.abs(g - w)))
                     for g, w in zip(got, want)) / scale
    return out


# -- compressors and byte counts ------------------------------------------

@pytest.mark.parametrize("shape", [(5, 208), (5, 760), (3, 7)])
@pytest.mark.parametrize("kind", KINDS)
def test_compressor_matches_reference(kind, shape):
    v = np.random.default_rng(sum(shape)).standard_normal(shape)
    v = v.astype(np.float32)
    want = np.asarray(jax.vmap(j_make_compressor(
        JCompression(kind)).encode_decode)(jnp.asarray(v)))
    got = make_compressor(CompressionConfig(kind)).encode_decode(
        torch.tensor(v)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if kind in ("none", "topk"):
        np.testing.assert_array_equal(got, want)
    elif kind == "sign1bit":
        np.testing.assert_allclose(got, want, rtol=SIGN_RTOL, atol=0)
    else:
        quantum = np.abs(v).max(axis=1, keepdims=True) / 127.0
        off = np.abs(got - want)
        assert np.all(off <= quantum * (1 + 1e-6))
        assert np.mean(off > 0) <= INT8_SHARE


@pytest.mark.parametrize("kind", KINDS)
def test_byte_counts_match_reference(kind):
    opts = dict(kind=kind, compress_after=3, topk_frac=0.07)
    want_c = j_make_compressor(JCompression(**opts))
    got_c = make_compressor(CompressionConfig(**opts))
    for size in (1, 7, 208, 760, 1001):
        assert got_c.bytes_on_wire(size) == want_c.bytes_on_wire(size)
    for comms, interval in ((2, 1), (1, 3), (2, 2)):
        assert cumulative_wire_bytes(
            CompressionConfig(**opts), 760, 11, comms, interval) == j_priced(
            JCompression(**opts), 760, 11, comms, interval)
    tree = [np.zeros((7, 6), np.float32), {"w": np.zeros(88, np.float32)}]
    want = j_make_engine("dense", j_ring_mixing(M),
                         compression=JCompression(**opts))
    got = make_engine("dense", ring_mixing(M), "cpu",
                      compression=CompressionConfig(**opts))
    assert got.bytes_on_wire(tree_from_numpy(tree, "cpu")) == \
        want.bytes_on_wire(tree)


def test_init_ef_matches_reference_layout():
    x = [np.ones((M, 3, 2), np.float32), np.ones((M, 4), np.float32)]
    u = [2 * a for a in x]
    want = np_tree(j_init_ef(JCompression("int8"), x=x, u=u))
    got = init_ef(CompressionConfig("int8"), x=tree_from_numpy(x, "cpu"),
                  u=tree_from_numpy(u, "cpu"))
    assert list(got) == list(want) == ["u", "x"]
    for g, w in zip(torch.utils._pytree.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert not g.any()
    assert init_ef(CompressionConfig("int8", error_feedback=False),
                   x=x) is None
    assert init_ef(CompressionConfig("none"), x=x) is None


# -- the engine's wire-aware combine --------------------------------------

def _wire_tree(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((M, 7, 6)).astype(np.float32),
            {"w": rng.standard_normal((M, 88)).astype(np.float32)}]


@pytest.mark.parametrize("backend", ["dense", "cuda"])
@pytest.mark.parametrize("t", [1, 4, 5], ids=["warm-up", "compressed",
                                             "silent"])
@pytest.mark.parametrize("kind", KINDS[1:])
def test_mix_ef_matches_reference(kind, t, backend):
    """``mix_ef`` from the reference's wire state after three rounds, at a
    warm-up step (t = 1 < compress_after = 3), a compressed step and a
    silent one (interval 2)."""
    opts = dict(kind=kind, compress_after=3, gamma=0.7)
    jeng = j_make_engine("dense", j_ring_mixing(M),
                         compression=JCompression(**opts),
                         communication_interval=2)
    teng = make_engine(backend, ring_mixing(M), "cpu",
                       compression=CompressionConfig(**opts),
                       communication_interval=2)
    ef = j_init_ef(JCompression(**opts), x=_wire_tree(0))["x"]
    for r in range(3):
        _, ef = jeng.mix_ef(_wire_tree(r), ef, 2 * r)
    tree = _wire_tree(7)
    want, want_ef = np_tree(jeng.mix_ef(tree, ef, t))
    got, got_ef = teng.mix_ef(tree_from_numpy(tree, "cpu"),
                              tree_from_numpy(np_tree(ef), "cpu"), t)
    for g, w in zip(torch.utils._pytree.tree_leaves((got, got_ef)),
                    jax.tree_util.tree_leaves((want, want_ef))):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=ONE_STEP_TOL * np.abs(w).max())


@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_none_wire_and_interval_one_is_mix_bitwise(backend):
    engine = make_engine(backend, ring_mixing(M), "cpu",
                         compression=CompressionConfig("none"))
    tree = tree_from_numpy(_wire_tree(3), "cpu")
    assert not engine.wire_active
    got, ef = engine.mix_ef(tree, None, 0)
    assert ef is None
    for g, w in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(engine.mix(tree))):
        assert torch.equal(g, w)


def test_wire_options_are_validated():
    with pytest.raises(ValueError, match="communication_interval"):
        make_engine("dense", ring_mixing(M), "cpu", communication_interval=0)
    with pytest.raises(ValueError, match="gamma"):
        make_engine("cuda", ring_mixing(M), "cpu",
                    compression=CompressionConfig("int8", gamma=0.0))
    with pytest.raises(ValueError, match="unknown compressor"):
        make_engine("dense", ring_mixing(M), "cpu",
                    compression=CompressionConfig("fp4"))
    with pytest.raises(ValueError, match="step index"):
        make_engine("dense", ring_mixing(M), "cpu",
                    communication_interval=2).mix_ef(
            tree_from_numpy(_wire_tree(0), "cpu"))


# -- one algorithm step from the reference's state --------------------------

STEP_CASES = [(name, t) for name, (_, _, steps) in CONFIGS.items()
              for t in steps]


def one_step_gaps(instance, runs, name, t, backend) -> dict:
    """The port's step from the reference's state ``t``, against the
    reference's state ``t + 1``: ``gaps``, printed beside the bound."""
    algo, opts, _ = CONFIGS.get(name) or TRIPS_32_CONFIGS[name]
    states, draws = reference_run(instance, runs, name)
    kind = STATES[algo]
    _, config = config_pair(algo, opts, backend, cg_iters=trips_of(name))
    solver = make_solver(config).build(instance["tproblem"], device="cpu",
                                       m=M, n=N)
    state = solver.step(state_from_numpy(states[t], "cpu", kind),
                        instance["tdata"], draws[t])
    assert state.t == t + 1
    g = gaps(state, states[t + 1], kind)
    worst = max(g, key=g.get)
    print(f"{name} step {t} {backend} at {trips_of(name)} CG trips: largest "
          f"gap {g[worst]:.3e} ({worst}), bound {ONE_STEP_TOL:.0e}")
    return g


@pytest.mark.parametrize("backend", ["dense", "cuda"])
@pytest.mark.parametrize("name,t", STEP_CASES)
def test_one_step_from_reference_state(instance, runs, name, t, backend):
    g = one_step_gaps(instance, runs, name, t, backend)
    assert max(g.values()) < ONE_STEP_TOL, g


@pytest.mark.parametrize("backend", ["dense", "cuda"])
@pytest.mark.parametrize("name,t", [
    (name, t) for name, (_, _, steps) in TRIPS_32_CONFIGS.items()
    for t in steps])
def test_one_step_at_32_trips(instance, runs, name, t, backend):
    """INTERACT over random-gossip and straggler streams, at the trip
    count the bound was measured at."""
    g = one_step_gaps(instance, runs, name, t, backend)
    assert max(g.values()) < ONE_STEP_TOL, g


def test_step_variant_carries_the_wire_schedule(instance):
    """The key a captured graph is kept under: warm-up, compressed and
    silent steps differ; an uncompressed config keeps one graph."""
    _, config = config_pair(*CONFIGS["sign1bit-ef-warm5-k2"][:2])
    solver = make_solver(config).build(instance["tproblem"], device="cpu",
                                       m=M, n=N)
    keys = [solver.step_variant(t) for t in range(8)]
    assert keys[4] == (None, True, True)      # warm-up round
    assert keys[1] == keys[5] == (None, False, False)   # silent
    assert keys[6] == (None, False, True)     # compressed round
    assert len(set(keys)) == 3
    _, config = config_pair("svr-interact", {})
    solver = make_solver(config).build(instance["tproblem"], device="cpu",
                                       m=M, n=N)
    assert {solver.step_variant(t) for t in range(8)} == {
        (True, False, True), (False, False, True)}


@pytest.mark.parametrize("backend", ["dense", "cuda"])
@pytest.mark.parametrize("algo", sorted(STATES))
def test_none_and_static_are_the_old_path_bitwise(instance, algo, backend):
    """``none`` with interval 1 and the ``static`` process change nothing:
    two steps equal the default config's bit for bit, with no wire
    state and no topology attached."""
    base = SolverConfig(algo=algo, q=Q, batch_size=BS, backend=backend,
                        hypergrad=HypergradConfig(cg_iters=CG_TRIPS))
    noop = SolverConfig(**{**base.__dict__,
                           "compression": CompressionConfig("none"),
                           "communication_interval": 1,
                           "topology_process": TopologyProcessConfig(
                               "static", p=0.3)})
    finals = []
    for config in (base, noop):
        solver = make_solver(config)
        state = solver.init(instance["tproblem"], None, instance["tx0"],
                            instance["ty0"], instance["tdata"])
        assert state.ef is None and solver._engine.topology is None
        finals.append(solver.run(state, instance["tdata"], 2))
    for a, b in zip(torch.utils._pytree.tree_leaves(finals[0]),
                    torch.utils._pytree.tree_leaves(finals[1])):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


# -- the measured-bytes ledger ----------------------------------------------

LEDGER_GRID = [(kind, ca, k) for kind in KINDS for ca, k in ((0, 1), (3, 2))]


@pytest.fixture(scope="module")
def ledger_instance(instance):
    return dict(problem=instance["tproblem"], x0=instance["tx0"],
                y0=instance["ty0"], data=instance["tdata"])


@pytest.mark.parametrize("algo", ["interact", "d-sgd"])
@pytest.mark.parametrize("kind,compress_after,interval", LEDGER_GRID)
def test_solve_measures_the_priced_bytes(ledger_instance, algo, kind,
                                         compress_after, interval):
    steps = 7
    opts = dict(kind=kind, compress_after=compress_after)
    config = SolverConfig(algo=algo, batch_size=BS,
                          compression=CompressionConfig(**opts),
                          communication_interval=interval,
                          hypergrad=HypergradConfig(cg_iters=2))
    res = solve(config, steps, device="cpu", **ledger_instance)
    comms = 1 if algo == "d-sgd" else 2
    entries = sum(l[0].numel() for l in
                  torch.utils._pytree.tree_leaves(res.state.x))
    want = j_priced(JCompression(**opts), entries, steps, comms, interval)
    assert res.measured_wire_bytes == want[-1]
    assert res.bytes_per_round == j_make_compressor(
        JCompression(**opts)).bytes_on_wire(entries)
    assert res.communications_per_step == comms


@pytest.mark.parametrize("algo", ["interact", "gt-dsgd"])
def test_fused_cuda_step_measures_its_two_streams(ledger_instance, algo):
    """The ``cuda`` backend's fused full-precision step (one
    ``consensus_step``) notes the x and u streams too, so its measured
    bytes are the priced ones (the JAX package's fused ``pallas`` step
    notes none and measures 0)."""
    config = SolverConfig(algo=algo, backend="cuda", batch_size=BS,
                          hypergrad=HypergradConfig(cg_iters=2))
    res = solve(config, 3, device="cpu", **ledger_instance)
    entries = sum(l[0].numel() for l in
                  torch.utils._pytree.tree_leaves(res.state.x))
    assert res.measured_wire_bytes == j_priced(JCompression(), entries, 3,
                                               2)[-1] > 0


@pytest.mark.parametrize("algo,kind,compress_after,interval", [
    ("interact", "int8", 3, 2), ("d-sgd", "sign1bit", 2, 1),
    ("svr-interact", "topk", 0, 3)])
def test_solve_measured_bytes_equal_jax_solve(algo, kind, compress_after,
                                              interval):
    opts = dict(kind=kind, compress_after=compress_after)
    common = dict(algo=algo, communication_interval=interval, seed=2)
    want = j_solve(JConfig(**common, compression=JCompression(**opts),
                           hypergrad=JHypergradConfig(cg_iters=2)),
                   6, num_agents=4, n_per_agent=20)
    got = solve(SolverConfig(**common, compression=CompressionConfig(**opts),
                             hypergrad=HypergradConfig(cg_iters=2)),
                6, num_agents=4, n_per_agent=20, device="cpu")
    assert got.measured_wire_bytes == want.measured_wire_bytes > 0
    assert got.bytes_per_round == want.bytes_per_round


def test_ledger_notes_overwrite_and_commit_the_schedule():
    """A stream noted twice (a warm-up step, then the capture) counts
    once; the commit replays warm-up and silent rounds on the host."""
    cfg = CompressionConfig("int8", compress_after=2)
    engine = make_engine("cuda", ring_mixing(M), "cpu", compression=cfg,
                         communication_interval=2)
    ledger = attach_ledger(engine, CommsLedger())
    tree = tree_from_numpy(_wire_tree(0), "cpu")
    for t in (0, 1, 2):
        engine.mix_ef(tree, None, t)
    assert list(ledger.streams) == ["x"]
    entries = 7 * 6 + 88
    assert ledger.commit_steps(5) == cumulative_wire_bytes(
        cfg, entries, 5, 1, 2)[-1]
    assert ledger.commit_steps(4) == cumulative_wire_bytes(
        cfg, entries, 9, 1, 2)[-1] - cumulative_wire_bytes(
        cfg, entries, 5, 1, 2)[-1]
    assert ledger.steps_committed == 9 and ledger.collectives_issued == 5
    assert ledger.bytes_per_step() == entries + 4
    summary = ledger.summary()
    assert summary["streams"]["x"]["entries"] == entries
    jengine = j_make_engine("dense", j_ring_mixing(M),
                            compression=JCompression("int8",
                                                     compress_after=2),
                            communication_interval=2)
    jledger = j_attach_ledger(jengine)
    jengine.mix_ef(_wire_tree(0), None, 0)
    jledger.commit_steps(9)
    assert ledger.measured_wire_bytes == jledger.measured_wire_bytes
