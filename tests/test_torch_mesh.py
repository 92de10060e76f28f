"""The port's mesh consensus engines across real process groups.

The port's ``allgather`` and ``ppermute`` backends (both impls) run in
gloo groups of 2, 4 and 8 processes on the CPU (``tests/
_torch_mesh_worker.py``, one subprocess a rank, each with a timeout),
m = 8 agents, each rank its m / world rows, and are held against the
port's single-process ``dense`` engine on the whole table: ring, 2 x 4
torus, ER(0.5) and complete graphs; ``mix``, the fused ``step1_step3``,
a round-matrix override (``PermuteWeights`` on ``ppermute``); ``mix_ef``
with error feedback under ``none``, ``int8`` and ``sign1bit``
(``ppermute`` compresses every leaf on its own, so its reference
compresses each leaf too); a link-failure stream's round matrices over
three steps (the adaptive process is refused on both: a process holds
its own rows only); ``ring_mix_tree``; the trimmed-mean and median
combines over
``allgather``'s gathered table; sign-flip and gaussian attacks; local-DP
noise.  Each group runs once per module, in a module-scoped fixture.

Bounds: ``allgather``'s compressed wire (as
tests/test_consensus_backends.py asks of the JAX package) and every
attacked slice are bit for bit the dense engine's rows; the rest within
``TOL`` = 1e-6 absolute (the largest gap is printed).  The same inputs
then run through the JAX package's mesh engines on 8 forced host devices
(a subprocess, as tests/test_distributed.py runs them), and the port's
8-process outputs are held to them within ``TOL``; the port's attacks
and DP noise draw from numpy, not ``jax.random``, so those two are held
to the port's dense engine only.  ``permute_schedule``'s offsets and
weights are the JAX package's exactly.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_worker as W  # noqa: E402
from repro.core import consensus as j_consensus  # noqa: E402
from repro.sharding.collectives import \
    permute_schedule as j_permute_schedule  # noqa: E402
from repro_torch.core import consensus as t_consensus  # noqa: E402
from repro_torch.kernels.consensus_step import ops  # noqa: E402
from repro_torch.launch import distributed as D  # noqa: E402
from repro_torch.sharding.collectives import (  # noqa: E402
    AgentMesh, _outgoing_payload, permute_mix_leaf, permute_schedule)

TOL = 1e-6
TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
WORLDS = (2, 4, 8)
TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(world: int, out: Path) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, str(TESTS / "_torch_mesh_worker.py"), str(world),
         str(rank), str(port), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]


def _wait_all(procs):
    errors = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            if p.returncode:
                errors.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, errors[0]


_JAX = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    sys.path.insert(0, TESTS)
    import _torch_mesh_worker as W
    from repro import core
    from repro.byzantine import ByzantineConfig
    from repro.consensus import (AllGatherEngine, CompressionConfig,
                                 PermuteEngine)
    from repro.sharding.collectives import PermuteWeights
    from repro.sharding.compat import set_mesh, shard_map

    mesh = jax.make_mesh((8,), ("data",))
    m = W.M_AGENTS
    host = W.make_inputs(m)
    x, u, p, pp = (jax.tree_util.tree_map(jnp.asarray, host[n])
                   for n in ("x", "u", "p", "p_prev"))
    outputs = {}

    def run(name, fn, *args):
        smap = shard_map(fn, mesh=mesh, in_specs=(P("data"),) * len(args),
                         out_specs=P("data"), axis_names={"data"},
                         check_vma=False)
        with set_mesh(mesh):
            out = jax.jit(smap)(*args)
        for i, leaf in enumerate(W.canonical_leaves(out)):
            outputs[f"{name}|{i}"] = np.asarray(leaf)

    for graph in W.GRAPHS:
        mat = W.mixing_matrix(core, graph)
        dropped = W.dropped_edge(mat)
        engines = {
            "allgather": AllGatherEngine(jnp.asarray(mat, jnp.float32)),
            "ppermute": PermuteEngine(mat),
            "psum": PermuteEngine(mat, impl="psum")}
        for name, eng in engines.items():
            key = f"{graph}/{name}"
            run(f"mix/{key}", lambda t, e=eng: e.mix(t), x)
            run(f"step/{key}", lambda a, b, c, d, e=eng: dict(zip(
                ("x", "u"), e.step1_step3(a, b, c, d, W.ALPHA))),
                x, u, p, pp)
            if name == "allgather":
                over = jnp.asarray(dropped, jnp.float32)
            else:
                idx = np.arange(m)
                over = PermuteWeights(
                    jnp.asarray(np.stack([dropped[idx, (idx + o) % m]
                                          for o in eng.schedule.offsets]),
                                jnp.float32),
                    jnp.asarray(np.diag(dropped).copy(), jnp.float32),
                    jnp.asarray(dropped, jnp.float32))
            run(f"override/{key}", lambda t, e=eng, o=over: e.mix(
                t, matrix=o), x)

    mat = W.mixing_matrix(core, "erdos-renyi")
    zeros = jax.tree_util.tree_map(jnp.zeros_like, x)
    ef = {"e": zeros, "ref": zeros}
    t0 = jnp.int32(W.T_ROUND)
    for kind in W.COMPRESSORS:
        comp = CompressionConfig(kind)
        for name, eng in (
                ("allgather", AllGatherEngine(
                    jnp.asarray(mat, jnp.float32), compression=comp)),
                ("ppermute", PermuteEngine(mat, compression=comp)),
                ("psum", PermuteEngine(mat, impl="psum",
                                       compression=comp))):
            run(f"mix_ef/{kind}/{name}", lambda t, r, e=eng: dict(zip(
                ("mixed", "ef"), e.mix_ef(t, r, t0))), x, ef)
    for rule in ("trimmed-mean", "coordinate-median"):
        eng = AllGatherEngine(jnp.asarray(mat, jnp.float32),
                              byzantine=ByzantineConfig(combine=rule))
        run(f"combine/{rule}/allgather", lambda t, e=eng: e._combine(t), x)
    np.savez(OUT, **outputs)
    print("JAX_MESH_OK", len(outputs))
""")


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """{world: checks.json} of one run of each group, and the 8-process
    group's gathered outputs; the JAX package's outputs beside them."""
    root = tmp_path_factory.mktemp("mesh")
    dirs = {w: root / f"world{w}" for w in WORLDS}
    for d in dirs.values():
        d.mkdir()
    env = dict(os.environ, PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    jax_out = root / "jax.npz"
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", f"TESTS = {str(TESTS)!r}\n"
         f"OUT = {str(jax_out)!r}\n" + _JAX], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for world in WORLDS:
        _wait_all(_run_group(world, dirs[world]))
    _wait_all([jax_proc])
    checks = {w: json.loads((d / "checks.json").read_text())
              for w, d in dirs.items()}
    largest = max(v["max_abs"] for c in checks.values() for v in c.values()
                  if isinstance(v, dict))
    print(f"mesh engines against dense: largest gap {largest:.3e} "
          f"(bound {TOL})")
    return dict(checks=checks,
                port=dict(np.load(dirs[8] / "outputs.npz")),
                jax=dict(np.load(jax_out)))


def _check_names(world: int) -> list[str]:
    """The checks a group of ``world`` processes makes."""
    engines = ["allgather"] + (["ppermute", "psum"] if world == 8 else [])
    names = [f"{op}/{g}/{e}" for g in W.GRAPHS for e in engines
             for op in ("mix", "step", "override")]
    names += [f"mix_ef/{c}/{e}" for c in W.COMPRESSORS for e in engines]
    names += [f"stream/t{t}/{e}" for t in range(3)
              for e in ["allgather"] + (["ppermute"] if world == 8 else [])]
    names += [f"combine/{r}/allgather"
              for r in ("trimmed-mean", "coordinate-median")]
    attackers = ["allgather"] + (["ppermute"] if world == 8 else [])
    names += [f"attack_{what}/{kind}/{e}" for kind in ("sign-flip",
                                                       "gaussian")
              for e in attackers for what in ("payload", "mix")]
    if world == 8:
        names += [f"dp{off}/{impl}" for impl in ("ppermute", "psum")
                  for off in ("", "_off")]
        names.append("mix/ring/ring_mix_tree")
    return names


def _bitwise_required(name: str) -> bool:
    """allgather's compressed wire and every attacked slice."""
    return (name.startswith("mix_ef/") and name.endswith("/allgather")
            or name.startswith("attack_payload/"))


@pytest.mark.parametrize("world,name", [(w, n) for w in WORLDS
                                        for n in _check_names(w)])
def test_mesh_engine_matches_dense(groups, world, name):
    got = groups["checks"][world][name]
    if _bitwise_required(name):
        assert got["bitwise"], got
    assert got["max_abs"] <= TOL, got


@pytest.mark.parametrize("world,name", [
    (8, "dp_without_key_raises"), (2, "indivisible_mesh_raises"),
    (2, "ppermute_k_gt_1_raises"), (4, "adaptive_on_mesh_raises")])
def test_mesh_refusals(groups, world, name):
    assert groups["checks"][world][name] is True


_JAX_NAMES = [n for n in _check_names(8)
              if not n.startswith(("attack_", "dp", "stream/"))
              and n != "mix/ring/ring_mix_tree"]


@pytest.mark.parametrize("name", _JAX_NAMES)
def test_mesh_engine_matches_jax(groups, name):
    keys = sorted(k for k in groups["jax"] if k.split("|")[0] == name)
    assert keys and keys == sorted(k for k in groups["port"]
                                   if k.split("|")[0] == name)
    for k in keys:
        np.testing.assert_allclose(groups["port"][k], groups["jax"][k],
                                   rtol=0, atol=TOL, err_msg=k)


def test_largest_gap_against_jax_is_printed(groups):
    gap = max(float(np.max(np.abs(groups["port"][k] - groups["jax"][k])))
              for k in groups["jax"])
    print(f"mesh engines against the JAX package: largest gap {gap:.3e} "
          f"(bound {TOL})")
    assert gap <= TOL


@pytest.mark.parametrize("graph", sorted(W.GRAPHS))
def test_permute_schedule_is_the_jax_packages(graph):
    mat = W.mixing_matrix(t_consensus, graph)
    np.testing.assert_array_equal(mat, W.mixing_matrix(j_consensus, graph))
    got, want = permute_schedule(mat), j_permute_schedule(mat)
    assert got.offsets == want.offsets
    assert got.rounds_per_mix == want.rounds_per_mix
    for field in ("weights", "self_weights", "matrix"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


def test_dp_noise_statistics_and_self_term():
    """The payload a neighbour receives is the value plus dp_sigma times a
    standard normal: its mean and standard deviation over a large leaf
    match; the agent's own term mixes the clean value."""
    sigma = 0.05
    x = torch.zeros(1, 200_000)
    noise = (_outgoing_payload(x, 3, sigma, (7, 3)) - x).double()
    n = noise.numel()
    assert abs(float(noise.mean())) < 5 * sigma / n ** 0.5
    assert abs(float(noise.std()) / sigma - 1) < 0.01
    other = _outgoing_payload(x, 4, sigma, (7, 3)) - x
    assert not torch.equal(noise.float(), other)        # slot by slot
    again = _outgoing_payload(x, 3, sigma, (7, 3), leaf_index=1) - x
    assert not torch.equal(noise.float(), again)        # leaf by leaf
    # one process holding its one agent (no offsets: a 1-agent network):
    # the combine is the self term, which stays clean under noise
    mesh = AgentMesh.local(1, "cpu")
    sched = permute_schedule(np.eye(1))
    y = torch.randn(1, 16)
    out = permute_mix_leaf(y, mesh, sched, dp_sigma=sigma, dp_key=(7, 3))
    assert torch.equal(out, y)


def test_dp_sigma_without_key_raises():
    mesh = AgentMesh.local(1, "cpu")
    with pytest.raises(ValueError, match="dp_sigma requires dp_key"):
        permute_mix_leaf(torch.ones(1, 4), mesh, permute_schedule(np.eye(1)),
                         dp_sigma=0.1, impl="psum")


def test_ppermute_refuses_more_than_one_agent_a_process():
    from repro_torch.consensus import PermuteEngine
    mat = t_consensus.ring_mixing(4).matrix
    with pytest.raises(ValueError, match="one agent a process"):
        PermuteEngine(mat, "cpu", mesh=AgentMesh.local(4, "cpu"))


def test_nccl_with_more_ranks_than_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        D.resolve_wire(D.DistributedConfig(num_processes=2, wire="nccl"))
    device, label = D.resolve_wire(D.DistributedConfig(num_processes=2,
                                                       process_id=1,
                                                       wire="gloo"))
    assert (device, label) == (torch.device("cuda", 0), "gloo-staged")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        D.resolve_wire(D.DistributedConfig(wire="nccl", device="cpu"))


def test_initialize_needs_a_coordinator():
    with pytest.raises(ValueError, match="coordinator is not set"):
        D.initialize(D.DistributedConfig(wire="gloo", device="cpu"))
    assert not torch.distributed.is_initialized()


def test_row_block_launcher_refuses_cpu_tensors():
    M = torch.full((4, 4), 0.25)
    x = torch.ones(4, 8)
    with pytest.raises(ValueError, match="no consensus kernel for device"):
        ops._launch_step(M, x, x, x[:2], x[:2], x[:2].clone(),
                         x[:2].clone(), 0.3, 2)
    # the wrapper itself takes the plain version on the CPU, counting no
    # launch
    before = dict(ops.ROW_LAUNCHES)
    ops.consensus_step_kernel(M, x, x, x[:2], x[:2], alpha=0.3, row0=2)
    assert ops.ROW_LAUNCHES == before


def test_stream_off_the_base_offsets_raises():
    from repro_torch.topology import PermuteStreamTopology
    ring = t_consensus.ring_mixing(8)
    full = np.full((1, 8, 8), 1 / 8)
    with pytest.raises(ValueError, match="outside the base schedule"):
        PermuteStreamTopology(permute_schedule(ring), full, "cpu")
