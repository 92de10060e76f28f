"""One rank of the pods-layout checks in tests/test_torch_pods.py.

    python tests/_torch_pods_worker.py RANK PORT OUT_DIR

Every rank of a gloo group of 4 processes, laid out as a (pod, data,
model) mesh of ``SHAPE`` = (2, 2, 1): 2 agents, each a pod of 2 ranks.
Each rank reads ``OUT_DIR/inputs.pkl`` (for each case of ``CASES`` the
JAX package's initial ``TrainState`` of 2 agents and the tokens, and a
prefix where the config has a frontend, as numpy), carries its shards
into the port (``train_state_from_numpy(..., pod=(k, d))``) and runs
``make_train_step(..., agent_mode="pods")``:

- each case's INTERACT steps, recording every capacity route of a moe
  ffn (this rank's tokens, the router, the kept entries numbered over
  the pod's batch);
- the moe ffn alone with the world's 4 ranks as one pod, each holding
  its share of one batch (``inputs.pkl``'s ``chunks``), routed whole and
  in token chunks (``CHUNKS``);
- the int8 wire and local-DP noise, one step each from the initial
  state, beside the rows layout's step on this rank's ring (the ranks of
  its data index across the pods: one agent a process, whole states);
- the initial shards of ``init_train_state(..., mesh=)`` against the
  whole state's slices, and the shards' bytes;
- last, once the test has written ``OUT_DIR/svr_inputs.pkl`` (a mid-run
  state), the SVR-INTERACT steps (``make_svr_train_step``).

Each rank writes ``rank<r>.pkl``: its shards as numpy, the metrics and
the routes.
"""
from __future__ import annotations

import collections
import pickle
import sys
import time
from pathlib import Path

from _torch_train_worker import SETTINGS, hyper_kwargs

SHAPE = (2, 2, 1)
# the reduced configs: tests/test_torch_train.py's settings; the moe ones
# at a capacity factor where slots drop
CASES = {"smollm": ("smollm-360m", {}),
         "mixtral": ("mixtral-8x7b", dict(capacity_factor=1.0)),
         "dbrx": ("dbrx-132b", dict(capacity_factor=1.0)),
         "paligemma": ("paligemma-3b", {})}
INTERACT_STEPS, SVR_STEPS, Q = 2, 3, 3
WIRE = {"int8": dict(consensus_compress="int8"),
        "dp": dict(dp_sigma=0.05)}
# the moe ffn's token chunks on a pod of the 4 ranks, each 16 tokens of
# the batch's 64: none, chunks of 8 within a rank's share, chunks of 32
# over 2 ranks' shares
CHUNKS = {"whole": None, "within": 8, "across": 32}


def config(case: str):
    from repro_torch.configs import get_config
    arch, extra = CASES[case]
    return get_config(arch).reduced(vocab_size=SETTINGS["vocab_size"],
                                    num_layers=SETTINGS["num_layers"],
                                    dtype="float32", **extra)


def _load_when_written(path: Path, timeout: float = 240.0):
    deadline = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} was not written in {timeout} s")
        time.sleep(0.05)
    return pickle.loads(path.read_bytes())


def main(rank: int, port: int, out_dir: str) -> None:
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.convert import train_state_from_numpy
    from repro_torch.launch import distributed as D
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import moe as Moe
    from repro_torch.sharding import partition as P
    from repro_torch.train.bilevel_lm import BilevelHyper
    from repro_torch.train.step import (InteractConfig, init_train_state,
                                        make_train_step)
    from repro_torch.train.svr_step import make_svr_train_step

    torch.set_num_threads(1)
    world = SHAPE[0] * SHAPE[1]
    D.initialize(D.DistributedConfig(
        coordinator=f"127.0.0.1:{port}", num_processes=world,
        process_id=rank, wire="gloo", device="cpu", timeout_s=240))
    pm = D.pods_mesh(make_production_mesh(shape=SHAPE))
    k, d = pm.pod_size, pm.data_index
    s = SETTINGS
    inputs = pickle.loads((Path(out_dir) / "inputs.pkl").read_bytes())
    icfg = InteractConfig(alpha=s["alpha"], beta=s["beta"],
                          hyper=BilevelHyper(**hyper_kwargs()))

    def to_port(fields, cfg, pod=(k, d)):
        return train_state_from_numpy(
            collections.namedtuple("JState", list(fields))(**fields), cfg,
            "cpu", pm.agent, pod=pod)

    host = lambda st: pytree.tree_map(
        lambda l: l.numpy() if isinstance(l, torch.Tensor) else l,
        st._asdict())
    out = {"rank": rank, "agent": pm.agent, "data": d, "seconds": {}}

    # the capacity routes of the moe ffns, in call order
    routing, routes = Moe.capacity_routing, []

    def recording(params, tokens, **kw):
        r = routing(params, tokens, **kw)
        n = tokens.shape[0]
        tok, slot = torch.nonzero(r.keep, as_tuple=True)
        routes.append(dict(
            tokens=tokens.detach().numpy().copy(),
            router=params["router"].detach().numpy().copy(),
            kept=torch.stack([tok + d * n, slot, r.experts[tok, slot],
                              r.positions[tok, slot]], 1).numpy(),
            slots=int(r.keep.numel()), capacity=r.capacity))
        return r

    Moe.capacity_routing = recording
    for case, data in inputs["cases"].items():
        t0 = time.perf_counter()
        cfg = config(case)
        tokens = torch.as_tensor(data["tokens"])
        prefix = (None if data.get("prefix") is None
                  else torch.as_tensor(data["prefix"]))
        step = make_train_step(cfg, pm, icfg, agent_mode="pods",
                               with_prefix=prefix is not None)
        state, metrics = to_port(data["state"], cfg), []
        del routes[:]
        for _ in range(INTERACT_STEPS):
            state, met = step(state, tokens, prefix)
            metrics.append({key: float(v) for key, v in met.items()})
        out[case] = dict(state=host(state), metrics=metrics,
                         routes=list(routes))
        out["seconds"][case] = time.perf_counter() - t0
    Moe.capacity_routing = routing

    # -- moe token chunks: the world's 4 ranks as one pod, each its share of
    # one batch, routed whole, in chunks within a share and across 2 shares
    ch = inputs["chunks"]
    world_pod = D.AgentMesh(world, world, rank, torch.device("cpu"), "gloo")
    x = torch.as_tensor(ch["x"])
    c = x.shape[0] // world
    params = {key: torch.as_tensor(v) for key, v in ch["params"].items()}
    for name, chunk in CHUNKS.items():
        got, aux = Moe.moe_ffn(params, x[rank * c:(rank + 1) * c],
                               num_experts=ch["num_experts"],
                               top_k=ch["top_k"], capacity_factor=1.0,
                               token_chunk=chunk, pod=world_pod)
        out[f"chunk_{name}"] = dict(out=got.numpy(), aux=float(aux))

    # -- the wire options: pods against rows on the same draws ------------
    t0 = time.perf_counter()
    cfg, data = config("smollm"), inputs["cases"]["smollm"]
    tokens = torch.as_tensor(data["tokens"])
    for name, opts in WIRE.items():
        wcfg = InteractConfig(alpha=s["alpha"], beta=s["beta"],
                              hyper=BilevelHyper(**hyper_kwargs()), **opts)
        rows, _ = make_train_step(cfg, pm.ring, wcfg)(
            to_port(data["state"], cfg, pod=None), tokens)
        pods, _ = make_train_step(cfg, pm, wcfg, agent_mode="pods")(
            to_port(data["state"], cfg), tokens)
        out[f"wire_{name}"] = dict(rows=host(P.train_state_shards(rows, k,
                                                                  d)),
                                   pods=host(pods))
    out["seconds"]["wire"] = time.perf_counter() - t0

    # -- init: the shards are the whole state's slices, bit for bit --------
    whole = P.train_state_shards(init_train_state(cfg, 3, device="cpu"), k,
                                 d)
    mine = init_train_state(cfg, 3, mesh=pm)
    out["init_bitwise"] = all(
        torch.equal(a, b) for a, b in zip(pytree.tree_leaves(mine),
                                          pytree.tree_leaves(whole),
                                          strict=True)
        if isinstance(a, torch.Tensor))
    out["init_bytes"] = P.state_bytes(mine)

    # -- SVR-INTERACT from the reference's mid-run state -------------------
    t0 = time.perf_counter()
    svr = make_svr_train_step(cfg, pm, icfg, q=Q, agent_mode="pods")
    state = to_port(_load_when_written(Path(out_dir) / "svr_inputs.pkl"),
                    cfg)
    metrics = []
    for _ in range(SVR_STEPS):
        state, met = svr(state, tokens)
        metrics.append({key: float(v) for key, v in met.items()})
    out["svr"] = dict(state=host(state), metrics=metrics)
    out["seconds"]["svr"] = time.perf_counter() - t0
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    D.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
