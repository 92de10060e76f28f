"""The port's time-varying topologies against the JAX package's.

Both realize a stream in numpy from ``default_rng([seed, t])``, so the
matrices and edge masks of every stream process (static, link-failure,
straggler, random-gossip) must be bitwise equal, and so must the repair
rule, the adjacency, the spectral gaps and the per-link wire bytes.  On
the device the round's matrix is the stream's in float32, bitwise equal
to the reference's ``StreamTopology``.  The adaptive matrix is computed
in float32 from the iterates by a different library: within
``ADAPTIVE_ATOL`` = 1e-6 (entries lie in [0, 1]; measured below 1e-7).
One algorithm step under each of chip_smoke.py's two topology rows
(link-failure GT-DSGD, adaptive INTERACT) is held to the reference's in
tests/test_torch_wire.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.consensus import CompressionConfig as JCompression  # noqa: E402
from repro.core import erdos_renyi_adjacency as j_er  # noqa: E402
from repro.core import laplacian_mixing as j_laplacian  # noqa: E402
from repro.core import ring_mixing as j_ring_mixing  # noqa: E402
from repro.topology import AdaptiveTopology as JAdaptive  # noqa: E402
from repro.topology import StreamTopology as JStream  # noqa: E402
from repro.topology import TopologyProcessConfig as JTopology  # noqa: E402
from repro.topology import adaptive_mixing as j_adaptive  # noqa: E402
from repro.topology import adjacency_of as j_adjacency  # noqa: E402
from repro.topology import masked_mixing as j_masked  # noqa: E402
from repro.topology import realize_stream as j_realize  # noqa: E402
from repro.topology import stream_wire_bytes as j_stream_bytes  # noqa: E402
from repro_torch.consensus import CompressionConfig, make_engine  # noqa: E402
from repro_torch.core import mix_pytree  # noqa: E402
from repro_torch.solvers import (SolverConfig, default_setup,  # noqa: E402
                                 make_solver, solve)
from repro_torch.hypergrad import HypergradConfig  # noqa: E402
from repro_torch.topology import (TopologyProcessConfig,  # noqa: E402
                                  adaptive_mixing, adjacency_of,
                                  attach_topology,
                                  available_topology_processes,
                                  masked_mixing, realize_stream, stream_of,
                                  stream_wire_bytes)

ADAPTIVE_ATOL = 1e-6
STREAMS = ("static", "link-failure", "straggler", "random-gossip")
BASES = {"er5": lambda: j_laplacian(j_er(5, 0.5, 0)).matrix,
         "ring8": lambda: j_ring_mixing(8).matrix}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("base", sorted(BASES))
@pytest.mark.parametrize("kind", STREAMS)
def test_realized_stream_equals_reference_bitwise(kind, base, seed):
    mat = np.asarray(BASES[base]())
    opts = dict(kind=kind, p=0.3, period=12)
    want = j_realize(JTopology(**opts), mat, seed)
    got = realize_stream(TopologyProcessConfig(**opts), mat, seed)
    assert got.matrices.dtype == want.matrices.dtype == np.float64
    np.testing.assert_array_equal(got.matrices, want.matrices)
    np.testing.assert_array_equal(got.edge_mask, want.edge_mask)
    np.testing.assert_array_equal(got.spectral_gaps(), want.spectral_gaps())
    assert got.mean_spectral_gap == want.mean_spectral_gap
    np.testing.assert_array_equal(got.active_out_degree(),
                                  want.active_out_degree())
    # a longer stream extends the shorter one; it never reshuffles it
    longer = realize_stream(TopologyProcessConfig(**opts), mat, seed, 20)
    np.testing.assert_array_equal(longer.matrices[:12], got.matrices)
    for kind_c, ca, k in (("none", 0, 1), ("int8", 3, 2),
                          ("topk", 1, 3)):
        assert stream_wire_bytes(
            got, CompressionConfig(kind_c, compress_after=ca), 760, 15, 2,
            k) == j_stream_bytes(want, JCompression(kind_c, compress_after=ca),
                                 760, 15, 2, k)


def test_repair_rule_and_adjacency_equal_reference_bitwise():
    rng = np.random.default_rng(3)
    for base in (BASES["er5"](), BASES["ring8"]()):
        base = np.asarray(base)
        np.testing.assert_array_equal(adjacency_of(base), j_adjacency(base))
        m = base.shape[0]
        for _ in range(5):
            keep = np.triu(rng.random((m, m)) > 0.4, k=1)
            keep = keep | keep.T
            got = masked_mixing(base, keep)
            np.testing.assert_array_equal(got, j_masked(base, keep))
            np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-12)
            assert np.all(got >= 0) and np.array_equal(got, got.T)
        np.testing.assert_array_equal(
            masked_mixing(base, np.ones((m, m), bool)), base)


def test_process_config_is_validated_like_the_reference():
    assert available_topology_processes() == (
        "adaptive", "link-failure", "random-gossip", "static", "straggler")
    for bad in (dict(p=1.5), dict(period=0), dict(tau=0.0)):
        with pytest.raises(ValueError):
            TopologyProcessConfig("link-failure", **bad)
        with pytest.raises(ValueError):
            JTopology("link-failure", **bad)
    with pytest.raises(ValueError, match="unknown topology process"):
        realize_stream(TopologyProcessConfig("ring-of-fire"),
                       BASES["er5"](), 0)
    with pytest.raises(ValueError, match="state-dependent"):
        realize_stream(TopologyProcessConfig("adaptive"), BASES["er5"](), 0)
    cfg = TopologyProcessConfig("adaptive")
    assert cfg.state_dependent and not cfg.is_static
    assert TopologyProcessConfig().is_static
    assert TopologyProcessConfig(seed=4).resolve_seed(9) == 4
    assert TopologyProcessConfig().resolve_seed(9) == 9


@pytest.mark.parametrize("spread", [0.05, 1.0])
def test_adaptive_mixing_matches_reference(spread):
    rng = np.random.default_rng(11)
    x2d = (spread * rng.standard_normal((5, 760))).astype(np.float32)
    adj = j_adjacency(BASES["er5"]()).astype(np.float32)
    want = np.asarray(j_adaptive(jnp.asarray(x2d), jnp.asarray(adj), 1.0))
    got = adaptive_mixing(torch.tensor(x2d), torch.tensor(adj), 1.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ADAPTIVE_ATOL)
    got = got.double()
    assert torch.allclose(got, got.T) and bool((got >= 0).all())
    assert torch.allclose(got.sum(dim=1), torch.ones(5, dtype=got.dtype),
                          atol=1e-6)


@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_round_matrix_is_the_streams_in_float32(backend):
    """``load_round(t)`` puts ``stream[t % T]`` in the engine's one round
    buffer (the address a captured graph keeps); ``topology_matrix``
    returns that buffer, bitwise the reference's round matrix."""
    mat = BASES["er5"]()
    cfg = dict(kind="link-failure", p=0.3, period=6)
    engine = make_engine(backend, mat, "cpu")
    attach_topology(engine, TopologyProcessConfig(**cfg), mat, seed=5)
    stream = stream_of(engine)
    want = JStream(j_realize(JTopology(**cfg), mat, 5).matrices)
    np.testing.assert_array_equal(
        stream.matrices, j_realize(JTopology(**cfg), mat, 5).matrices)
    buffer = engine.topology.round
    x = torch.tensor(np.random.default_rng(0).standard_normal((5, 9)),
                     dtype=torch.float32)
    for t in (0, 1, 5, 6, 13):
        engine.load_round(t)
        got = engine.topology_matrix(t)
        assert got is buffer
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want.matrix_at(t)))
        assert torch.equal(engine.mix(x, matrix=got), mix_pytree(got, x))
    # a round asked for without a load is loaded on the spot (eagerly)
    got = engine.topology_matrix(8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.matrix_at(8)))
    assert engine.topology.loaded == 8


@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_adaptive_engine_matrix_matches_reference(backend):
    mat = BASES["er5"]()
    engine = make_engine(backend, mat, "cpu")
    attach_topology(engine, TopologyProcessConfig("adaptive", tau=0.5), mat,
                    seed=0)
    assert stream_of(engine) is None
    rng = np.random.default_rng(2)
    tree = [rng.standard_normal((5, 7, 3)).astype(np.float32) * 0.1,
            rng.standard_normal((5, 4)).astype(np.float32) * 0.1]
    want = JAdaptive(j_adjacency(mat), 0.5).matrix_at(
        3, [jnp.asarray(a) for a in tree])
    got = engine.topology_matrix(3, [torch.tensor(a) for a in tree])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ADAPTIVE_ATOL)
    with pytest.raises(ValueError, match="iterates"):
        engine.topology_matrix(3)


@pytest.mark.parametrize("kind", ["link-failure", "straggler",
                                  "random-gossip", "adaptive"])
def test_solver_steps_on_a_time_varying_topology(kind):
    """Each process drives a solver: the step loads its round (a stream's
    buffer holds the last step's matrix), the run stays finite, and the
    ledger still charges one broadcast payload a stream a round."""
    problem, x0, y0, data = default_setup(0, num_agents=5, n_per_agent=20,
                                          hidden=4, device="cpu")
    config = SolverConfig(algo="gt-dsgd", backend="cuda", batch_size=4,
                          topology_process=TopologyProcessConfig(
                              kind, p=0.3, period=3),
                          hypergrad=HypergradConfig(cg_iters=2))
    res = solve(config, 4, problem=problem, x0=x0, y0=y0, data=data,
                device="cpu")
    assert res.state.t == 4
    assert all(bool(torch.isfinite(l).all())
               for l in torch.utils._pytree.tree_leaves(res.state.x))
    entries = sum(l[0].numel() for l in
                  torch.utils._pytree.tree_leaves(res.state.x))
    assert res.measured_wire_bytes == 4 * 2 * 4 * entries
    solver = make_solver(config)
    state = solver.init(problem, None, x0, y0, data)
    solver.run(state, data, 4)
    topology = solver._engine.topology
    if kind != "adaptive":
        assert topology.loaded == 3
        np.testing.assert_array_equal(
            topology.round.numpy(),
            stream_of(solver._engine).matrices[0].astype(np.float32))
