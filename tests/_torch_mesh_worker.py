"""One rank of the mesh-engine checks in tests/test_torch_mesh.py.

    python tests/_torch_mesh_worker.py WORLD RANK PORT OUT_DIR

Every rank of a gloo group of WORLD processes builds the same inputs
(``make_inputs``, numpy from a seed), runs the port's ``allgather`` and
(with one agent a process) ``ppermute`` engines, both impls, on its rows,
and holds each result against the port's single-process ``dense`` engine
on the whole table.  Rank 0 writes ``checks.json`` ({check: {"max_abs",
"bitwise"}} over every rank) and, for the comparison with the JAX
package, ``outputs.npz`` (each result gathered to (m, ...)).

``make_inputs`` and ``GRAPHS`` are numpy only, so the JAX package's side
of the comparison imports them too.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

M_AGENTS = 8
ALPHA = 0.3
DP_SIGMA = 0.05
DP_KEY = (7, 3)
T_ROUND = 4
# the graphs every engine mixes over: (builder, arguments), the builders
# being those of both packages' core.consensus
GRAPHS = {
    "ring": ("ring_mixing", (M_AGENTS,), {"self_weight": 1.0 / 3.0}),
    "erdos-renyi": ("erdos_renyi", (M_AGENTS, 0.5, 11), {}),
    "torus": ("torus_mixing", (2, 4), {}),
    "complete": ("complete", (M_AGENTS,), {}),
}
COMPRESSORS = ("none", "int8", "sign1bit")


def mixing_matrix(core, name: str) -> np.ndarray:
    """``name``'s (m, m) matrix from ``core`` (either package's
    ``core`` module)."""
    builder, args, kwargs = GRAPHS[name]
    if builder == "erdos_renyi":
        m, p, seed = args
        return np.asarray(core.laplacian_mixing(
            core.erdos_renyi_adjacency(m, p, seed)).matrix)
    if builder == "complete":
        m, = args
        return np.asarray(core.laplacian_mixing(
            np.ones((m, m)) - np.eye(m)).matrix)
    return np.asarray(getattr(core, builder)(*args, **kwargs).matrix)


def dropped_edge(mat: np.ndarray) -> np.ndarray:
    """``mat`` with its first off-diagonal edge dropped (weight moved to
    the diagonals): a round matrix on the same offsets."""
    out = mat.copy()
    i, j = np.argwhere((np.abs(out) > 0) & ~np.eye(len(out), dtype=bool))[0]
    w = out[i, j]
    out[i, j] = out[j, i] = 0.0
    out[i, i] += w
    out[j, j] += w
    return out


def canonical_leaves(tree) -> list:
    """The leaves of a tree of dicts (keys sorted, as JAX orders them),
    lists and tuples, in one order for both packages."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in canonical_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in canonical_leaves(item)]
    return [tree]


def make_inputs(m: int = M_AGENTS) -> dict:
    """x, u, p, p_prev trees ({"w", "b", "nest"}) and a big leaf for the
    noise statistics, float32 numpy."""
    rng = np.random.default_rng(2024)
    x = {"w": rng.standard_normal((m, 37, 5), dtype=np.float32),
         "b": rng.standard_normal((m, 131), dtype=np.float32),
         "nest": (rng.standard_normal((m, 3), dtype=np.float32),)}
    scale = lambda c: {"w": c * x["w"], "b": c * x["b"],
                       "nest": (c * x["nest"][0],)}
    return {"x": x, "u": scale(np.float32(0.5)), "p": scale(np.float32(0.1)),
            "p_prev": scale(np.float32(0.2))}


def main(world: int, rank: int, port: int, out_dir: str) -> None:
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch import core
    from repro_torch.byzantine import ByzantineConfig
    from repro_torch.consensus import (AllGatherEngine, CompressionConfig,
                                       DenseEngine, PermuteEngine, init_ef)
    from repro_torch.launch import distributed as D
    from repro_torch.sharding.collectives import (
        PermuteWeights, dp_noise, permute_mix_tree, permute_schedule,
        ring_mix_tree)
    from repro_torch.topology import TopologyProcessConfig, attach_topology

    torch.set_num_threads(1)
    D.initialize(D.DistributedConfig(
        coordinator=f"127.0.0.1:{port}", num_processes=world,
        process_id=rank, wire="gloo", device="cpu", timeout_s=120))
    m = M_AGENTS
    mesh = D.agent_mesh(m)
    row0, k = mesh.row0, mesh.local_agents
    host = make_inputs(m)
    full = {n: pytree.tree_map(torch.from_numpy, t) for n, t in host.items()}
    local = {n: D.shard_host_tree(mesh, t, m) for n, t in full.items()}
    own = lambda tree: pytree.tree_map(lambda l: l[row0:row0 + k], tree)
    checks, outputs = {}, {}

    def record(name, got, want):
        g = [t.float() for t in pytree.tree_leaves(got)]
        w = [t.float() for t in pytree.tree_leaves(want)]
        assert [t.shape for t in g] == [t.shape for t in w], name
        checks[name] = {
            "max_abs": max(float((a - b).abs().max()) for a, b in zip(g, w)),
            "bitwise": all(torch.equal(a, b) for a, b in zip(g, w))}
        outputs[name] = D.gather_tree(mesh, got)

    t0 = T_ROUND
    for graph in GRAPHS:
        mat = mixing_matrix(core, graph)
        dense = DenseEngine(mat, "cpu")
        engines = {"allgather": AllGatherEngine(mat, "cpu", mesh=mesh)}
        if k == 1:
            engines.update(
                ppermute=PermuteEngine(mat, "cpu", mesh=mesh),
                psum=PermuteEngine(mat, "cpu", mesh=mesh, impl="psum"))
        want_x, want_u = dense.step1_step3(full["x"], full["u"], full["p"],
                                           full["p_prev"], ALPHA)
        dropped = dropped_edge(mat)
        want_drop = dense.mix(full["x"], matrix=torch.as_tensor(
            dropped, dtype=torch.float32))
        for name, eng in engines.items():
            key = f"{graph}/{name}"
            record(f"mix/{key}", eng.mix(local["x"]),
                   own(dense.mix(full["x"])))
            gx, gu = eng.step1_step3(local["x"], local["u"], local["p"],
                                     local["p_prev"], ALPHA)
            record(f"step/{key}", {"x": gx, "u": gu},
                   {"x": own(want_x), "u": own(want_u)})
            if name == "allgather":
                over = torch.as_tensor(dropped, dtype=torch.float32)
            else:
                idx = np.arange(m)
                over = PermuteWeights(
                    torch.as_tensor(np.stack(
                        [dropped[idx, (idx + o) % m]
                         for o in eng.schedule.offsets]),
                        dtype=torch.float32),
                    torch.as_tensor(np.diag(dropped).copy(),
                                    dtype=torch.float32),
                    torch.as_tensor(dropped, dtype=torch.float32))
            record(f"override/{key}", eng.mix(local["x"], matrix=over),
                   own(want_drop))

    # a link-failure stream: each step's round matrix (allgather: the
    # round buffer; ppermute: the weights on the base offsets)
    process = TopologyProcessConfig("link-failure", p=0.3, period=3)
    mat = mixing_matrix(core, "erdos-renyi")
    dense = attach_topology(DenseEngine(mat, "cpu"), process, mat, seed=5)
    engines = {"allgather": AllGatherEngine(mat, "cpu", mesh=mesh)}
    if k == 1:
        engines["ppermute"] = PermuteEngine(mat, "cpu", mesh=mesh)
    for name, eng in engines.items():
        attach_topology(eng, process, mat, seed=5)
        for t in range(3):
            want_x, want_u = dense.step1_step3(
                full["x"], full["u"], full["p"], full["p_prev"], ALPHA, t=t)
            gx, gu = eng.step1_step3(local["x"], local["u"], local["p"],
                                     local["p_prev"], ALPHA, t=t)
            record(f"stream/t{t}/{name}", {"x": gx, "u": gu},
                   {"x": own(want_x), "u": own(want_u)})
    try:
        attach_topology(AllGatherEngine(mat, "cpu", mesh=mesh),
                        TopologyProcessConfig("adaptive"), mat, seed=5)
        checks["adaptive_on_mesh_raises"] = False
    except ValueError as err:
        checks["adaptive_on_mesh_raises"] = "adaptive" in str(err)

    if k == 1:
        # the ring special case: ring_mixing's schedule
        record("mix/ring/ring_mix_tree",
               ring_mix_tree(local["x"], mesh, 1.0 / 3.0),
               own(DenseEngine(mixing_matrix(core, "ring"), "cpu").mix(
                   full["x"])))

    # the compressed wire with error feedback, each compressor, ER(0.5)
    mat = mixing_matrix(core, "erdos-renyi")
    for kind in COMPRESSORS:
        comp = CompressionConfig(kind)
        dense = DenseEngine(mat, "cpu", compression=comp)
        ef_full = init_ef(CompressionConfig("int8"), x=full["x"])["x"]
        ef_local = init_ef(CompressionConfig("int8"), x=local["x"])["x"]
        want, want_ef = dense.mix_ef(full["x"], ef_full, t0)
        ag = AllGatherEngine(mat, "cpu", mesh=mesh, compression=comp)
        got, got_ef = ag.mix_ef(local["x"], ef_local, t0)
        record(f"mix_ef/{kind}/allgather", {"mixed": got, "ef": got_ef},
               {"mixed": own(want), "ef": pytree.tree_map(own, want_ef)})
        if k == 1:
            # per-leaf payloads: the reference compresses each leaf of each
            # agent on its own and mixes the reconstruction densely, the
            # agent's own term clean
            comp_eng = DenseEngine(mat, "cpu", compression=comp)
            enc = lambda l: comp_eng.compressor.encode_decode(
                l.reshape(m, -1)).reshape(l.shape)
            payload = pytree.tree_map(enc, full["x"])
            diag = torch.as_tensor(np.diag(mat).copy(), dtype=torch.float32)
            leaf_want = pytree.tree_map(
                lambda mx, xx, pl: mx + diag.reshape(
                    (-1,) + (1,) * (xx.dim() - 1)) * (xx - pl),
                DenseEngine(mat, "cpu").mix(payload), full["x"], payload)
            leaf_ef = ({"e": pytree.tree_map(lambda a, b: a - b, full["x"],
                                             payload), "ref": payload}
                       if comp.active else ef_full)
            for impl in ("ppermute", "psum"):
                eng = PermuteEngine(mat, "cpu", mesh=mesh, impl=impl,
                                    compression=comp)
                got, got_ef = eng.mix_ef(local["x"], ef_local, t0)
                record(f"mix_ef/{kind}/{impl}", {"mixed": got, "ef": got_ef},
                       {"mixed": own(leaf_want),
                        "ef": pytree.tree_map(own, leaf_ef)})

    # robust combines over the gathered table
    for rule in ("trimmed-mean", "coordinate-median"):
        byz = ByzantineConfig(combine=rule)
        want = DenseEngine(mat, "cpu", byzantine=byz)._combine(full["x"])
        got = AllGatherEngine(mat, "cpu", mesh=mesh,
                              byzantine=byz)._combine(local["x"])
        record(f"combine/{rule}/allgather", got, own(want))

    # attacks: the corrupted slice, then the weighted combine
    for kind, nb in (("sign-flip", 2), ("gaussian", 3)):
        byz = ByzantineConfig(kind=kind, num_byzantine=nb, scale=5.0)
        dense = DenseEngine(mat, "cpu", byzantine=byz, attack_seed=1)
        want_pay = dense._attack_payload(full["x"], t0, "x")
        want_mix, _ = dense.mix_ef(full["x"], None, t0)
        engines = {"allgather": AllGatherEngine(
            mat, "cpu", mesh=mesh, byzantine=byz, attack_seed=1)}
        if k == 1:
            engines["ppermute"] = PermuteEngine(
                mat, "cpu", mesh=mesh, byzantine=byz, attack_seed=1)
        for name, eng in engines.items():
            record(f"attack_payload/{kind}/{name}",
                   eng._attack_payload(local["x"], t0, "x"), own(want_pay))
            record(f"attack_mix/{kind}/{name}",
                   eng.mix_ef(local["x"], None, t0)[0], own(want_mix))

    # local-DP noise: neighbours see the noised payload, the self term is
    # the clean value
    if k == 1:
        sched = permute_schedule(mat)
        noised = pytree.tree_unflatten(
            [x + DP_SIGMA * torch.from_numpy(np.stack(
                [dp_noise(DP_KEY, leaf, j, (1,) + tuple(x.shape[1:]))[0]
                 for j in range(m)]))
             for leaf, x in enumerate(pytree.tree_leaves(full["x"]))],
            pytree.tree_structure(full["x"]))
        diag = torch.as_tensor(np.diag(mat).copy(), dtype=torch.float32)
        want = pytree.tree_map(
            lambda mx, xx, nx: mx + diag.reshape(
                (-1,) + (1,) * (xx.dim() - 1)) * (xx - nx),
            DenseEngine(mat, "cpu").mix(noised), full["x"], noised)
        for impl in ("ppermute", "psum"):
            eng = PermuteEngine(mat, "cpu", mesh=mesh, impl=impl,
                                dp_sigma=DP_SIGMA)
            record(f"dp/{impl}", eng.mix(local["x"], dp_key=DP_KEY),
                   own(want))
            # the engine without a dp_key mixes clean
            record(f"dp_off/{impl}", eng.mix(local["x"]),
                   own(DenseEngine(mat, "cpu").mix(full["x"])))
        try:
            permute_mix_tree(local["x"], mesh, sched, dp_sigma=DP_SIGMA)
            checks["dp_without_key_raises"] = False
        except ValueError as err:
            checks["dp_without_key_raises"] = "dp_key" in str(err)

    if world == 2:
        try:
            D.agent_mesh(3)
            checks["indivisible_mesh_raises"] = False
        except ValueError as err:
            checks["indivisible_mesh_raises"] = "does not divide" in str(err)
        try:
            PermuteEngine(mat, "cpu", mesh=mesh)
            checks["ppermute_k_gt_1_raises"] = False
        except ValueError as err:
            checks["ppermute_k_gt_1_raises"] = "one agent a process" in str(
                err)

    every = mesh.gather_object(checks)
    if rank == 0:
        merged = {}
        for name in checks:
            got = [c[name] for c in every]
            if isinstance(got[0], dict):
                merged[name] = {
                    "max_abs": max(g["max_abs"] for g in got),
                    "bitwise": all(g["bitwise"] for g in got)}
            else:
                merged[name] = all(got)
        out = Path(out_dir)
        (out / "checks.json").write_text(json.dumps(merged, indent=1))
        np.savez(out / "outputs.npz", **{
            f"{name}|{i}": leaf.numpy()
            for name, tree in outputs.items()
            for i, leaf in enumerate(canonical_leaves(tree))})
    D.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
