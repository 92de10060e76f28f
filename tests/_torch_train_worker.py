"""One rank of the LM train-step checks in tests/test_torch_train.py and
tests/test_torch_train_moe_mamba.py.

    python tests/_torch_train_worker.py WORLD RANK PORT OUT_DIR [ARCH]

Every rank of a gloo group of WORLD processes (one agent a process, so
m = WORLD; ARCH names the reduced config, ``SETTINGS["arch"]`` when not
given) reads ``OUT_DIR/inputs.pkl`` (the JAX package's initial
``TrainState`` and the tokens, as numpy) and, once the test has written it,
``OUT_DIR/svr_inputs.pkl`` (a mid-run SVR-INTERACT state), carries its
agent's rows into the port (``train_state_from_numpy``), and runs the
port's entry points on them: ``SETTINGS["interact_steps"]`` INTERACT
steps from the initial state (``make_train_step``),
``SETTINGS["svr_steps"]`` SVR-INTERACT steps with refresh period
``SETTINGS["q"]`` from the mid-run state (``make_svr_train_step``), and
the eval step at the initial state with both attention impls.  Each
rank writes ``rank<r>.pkl``: its final states as numpy (the port's
layout: per-layer dicts, a leading agent dim of 1), the metrics of every
step and the eval values.
"""
from __future__ import annotations

import collections
import pickle
import sys
import time
from pathlib import Path

# the JAX test's settings (tests/test_distributed.py:68-76)
SETTINGS = dict(arch="smollm-360m", m=4, batch=4, seq=32, vocab_size=128,
                num_layers=2, alpha=0.05, beta=0.3, mu_g=0.5, neumann_k=2,
                lipschitz_g=4.0, ce_chunk=16, interact_steps=2, svr_steps=3,
                q=3)


def hyper_kwargs() -> dict:
    s = SETTINGS
    return dict(mu_g=s["mu_g"], neumann_k=s["neumann_k"],
                lipschitz_g=s["lipschitz_g"], ce_chunk=s["ce_chunk"],
                remat=False)


def _load_when_written(path: Path, timeout: float = 240.0):
    deadline = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} was not written in {timeout} s")
        time.sleep(0.05)
    return pickle.loads(path.read_bytes())


def main(world: int, rank: int, port: int, out_dir: str,
         arch: str = SETTINGS["arch"]) -> None:
    import dataclasses

    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.launch import distributed as D
    from repro_torch.train.bilevel_lm import BilevelHyper
    from repro_torch.train.step import (InteractConfig, make_eval_step,
                                        make_train_step)
    from repro_torch.train.svr_step import make_svr_train_step

    torch.set_num_threads(1)
    D.initialize(D.DistributedConfig(
        coordinator=f"127.0.0.1:{port}", num_processes=world,
        process_id=rank, wire="gloo", device="cpu", timeout_s=240))
    s = SETTINGS
    mesh = D.agent_mesh(world)
    with open(Path(out_dir) / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    cfg = get_config(arch).reduced(vocab_size=s["vocab_size"],
                                   num_layers=s["num_layers"],
                                   dtype="float32")
    to_port = lambda fields: train_state_from_numpy(
        collections.namedtuple("JState", list(fields))(**fields), cfg, "cpu",
        mesh.rank)
    state0 = to_port(inputs["state"])
    tokens = torch.as_tensor(inputs["tokens"])
    icfg = InteractConfig(alpha=s["alpha"], beta=s["beta"],
                          hyper=BilevelHyper(**hyper_kwargs()))
    host = lambda st: pytree.tree_map(
        lambda l: l.numpy() if isinstance(l, torch.Tensor) else l,
        st._asdict())
    out = {"metrics": {"interact": [], "svr": []}}

    step = make_train_step(cfg, mesh, icfg)
    state = state0
    for _ in range(s["interact_steps"]):
        state, metrics = step(state, tokens)
        out["metrics"]["interact"].append(
            {k: float(v) for k, v in metrics.items()})
    out["interact"] = host(state)

    svr = make_svr_train_step(cfg, mesh, icfg, q=s["q"])
    state = to_port(_load_when_written(Path(out_dir) / "svr_inputs.pkl"))
    for _ in range(s["svr_steps"]):
        state, metrics = svr(state, tokens)
        out["metrics"]["svr"].append(
            {k: float(v) for k, v in metrics.items()})
    out["svr"] = host(state)

    out["eval"] = {}
    for impl in ("reference", "cuda"):
        ecfg = dataclasses.replace(icfg, hyper=dataclasses.replace(
            icfg.hyper, attn_impl=impl))
        out["eval"][impl] = float(make_eval_step(cfg, mesh, ecfg)(state0,
                                                                  tokens))
    with open(Path(out_dir) / f"rank{mesh.rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    D.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         *sys.argv[5:6])
