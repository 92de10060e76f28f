"""End-to-end training driver: decentralized bilevel LM training.

Counterpart of ``repro.launch.train``: real INTERACT iterations, one
agent a process, the processes started on this host through the
localhost launcher's ``launch_workers``
(``repro_torch.launch.launch_local``) and joined in one
``torch.distributed`` group.  For the CPU pick the reduced config
(``--reduced``):

  PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
      --device cpu --wire gloo --steps 8 --agents 4 --per-agent-batch 4 \\
      --seq-len 64 --log-every 2 --ckpt-dir /tmp/ckpt --ckpt-every 4

The JAX driver's flags and defaults, and the port's: ``--device
{cuda,cpu}`` (default ``cuda``, which raises where there is no card),
``--wire {nccl,gloo}`` (default ``nccl``: a card a process; ``gloo`` on
the card stages every payload through host memory), ``--dtype
{float32,bfloat16}`` (the parameters' dtype; default the arch's, float32
with ``--reduced``), ``--out`` (rank 0's
JSON result: the logged metrics, each step's seconds, each process's
peak device memory and the digest of its final state) and ``--timeout``.
``--production-mesh`` (the 16 x 16 (data, model) mesh) raises: its
model axis (tensor parallelism) waits for ROADMAP Queue A item 10.  The
CLI has no pods flag, as the JAX driver has none: the pods layout is
reached through the API (``agent_mode="pods"``).

Checkpoints go through ``repro_torch.checkpoint``: each process writes
its agent's state to ``<ckpt-dir>/agent_<i>/step_<N>.npz`` every
``--ckpt-every`` steps; a rerun with the same directory resumes from the
newest step every agent holds (``restore_step(..., fallback=True)``),
so a larger ``--steps`` continues the run bit for bit.  The npz store
refuses bfloat16 leaves, so they are stored as their int16 bits and
viewed back on restore.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import tempfile
import time

from repro_torch.configs import ARCH_IDS

__all__ = ["main", "parse_args", "train"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--per-agent-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--alpha", type=float, default=0.02)
    ap.add_argument("--beta", type=float, default=0.5)
    ap.add_argument("--neumann-k", type=int, default=3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--wire", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--dtype", default=None, choices=("float32", "bfloat16"),
                    help="parameter dtype (default: the arch's; float32 "
                         "with --reduced)")
    ap.add_argument("--out", default=None,
                    help="JSON result path (default: a temp file)")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="wall-clock limit of the workers, seconds; also "
                         "the process group's collective timeout")
    # worker-only internals (the launcher starts this module with these)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--process-id", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--go", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _config(args):
    from repro_torch.launch.distributed import DistributedConfig
    return DistributedConfig(
        coordinator=args.coordinator, num_processes=args.agents,
        process_id=args.process_id, wire=args.wire, device=args.device,
        timeout_s=args.timeout)


def _storable(tree):
    """bfloat16 leaves as their int16 bits (the npz store refuses
    bfloat16); everything else as it is."""
    import torch
    from torch.utils import _pytree as pytree
    return pytree.tree_map(
        lambda l: l.view(torch.int16) if isinstance(l, torch.Tensor)
        and l.dtype == torch.bfloat16 else l, tree)


def _restore(agent_dir, step: int, state):
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.checkpoint import restore_step
    got = restore_step(agent_dir, step, _storable(state), fallback=True)
    return pytree.tree_map(
        lambda g, l: g.view(torch.bfloat16) if isinstance(l, torch.Tensor)
        and l.dtype == torch.bfloat16 else g, got, state)


def _digest(state) -> str:
    import numpy as np
    from torch.utils import _pytree as pytree
    h = hashlib.sha256()
    for leaf in pytree.tree_leaves(_storable(state)):
        if hasattr(leaf, "cpu"):
            h.update(np.ascontiguousarray(leaf.cpu().numpy()).tobytes())
    return h.hexdigest()


def _common_step(mesh, agent_dir):
    """The newest step whose checkpoint every agent holds, or None."""
    from repro_torch.checkpoint import valid_steps
    held = mesh.gather_object(valid_steps(agent_dir))
    common = set(held[0]).intersection(*map(set, held[1:]))
    return max(common) if common else None


def train(args, mesh) -> dict:
    """The training loop of one process (agent ``mesh.rank``); prints the
    JAX driver's log lines on rank 0 and returns the JSON result."""
    import torch

    from repro_torch.checkpoint import save_step
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenTaskStream
    from repro_torch.device import synchronize
    from repro_torch.train.bilevel_lm import BilevelHyper
    from repro_torch.train.step import (InteractConfig, init_train_state,
                                        make_train_step)

    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(vocab_size=1024, dtype=args.dtype or "float32")
    elif args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    m = mesh.num_agents
    say(f"mesh {{'data': {m}}} ({mesh.wire}, {mesh.device.type}); {m} "
        f"agents; arch {cfg.name} ({'reduced' if args.reduced else 'full'}, "
        f"{cfg.dtype})", flush=True)

    icfg = InteractConfig(
        alpha=args.alpha, beta=args.beta,
        hyper=BilevelHyper(mu_g=0.1, neumann_k=args.neumann_k,
                           lipschitz_g=2.0, ce_chunk=min(512, args.seq_len),
                           remat=not args.reduced))
    state = init_train_state(cfg, 0, device=mesh.device)

    start = 0
    agent_dir = None
    if args.ckpt_dir:
        agent_dir = os.path.join(args.ckpt_dir, f"agent_{mesh.rank:03d}")
        last = _common_step(mesh, agent_dir)
        if last is not None:
            say(f"restoring step {last} from {args.ckpt_dir}", flush=True)
            state = _restore(agent_dir, last, state)
            steps = mesh.gather_object(state.t)
            if len(set(steps)) != 1:
                raise RuntimeError(f"the agents restored different steps "
                                   f"{steps}")
            start = state.t

    stream = TokenTaskStream(vocab_size=cfg.vocab_size, num_agents=m, seed=7)
    step_fn = make_train_step(cfg, mesh, icfg)
    log, step_s = [], []
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    t0 = time.time()
    for t in range(start, args.steps):
        t_step = time.perf_counter()
        tokens = stream.agent_batch(mesh.rank, t, args.per_agent_batch,
                                    args.seq_len, device=mesh.device)[None]
        state, metrics = step_fn(state, tokens)
        synchronize(mesh.device)
        step_s.append(time.perf_counter() - t_step)
        if (t + 1) % args.log_every == 0:
            ce = float(metrics["outer_ce"])
            gn = float(metrics["grad_norm"])
            dt = (time.time() - t0) / args.log_every
            say(f"step {t + 1:5d}  outer_ce {ce:.4f}  "
                f"tracked_grad_norm {gn:.3e}  {dt:.2f}s/step", flush=True)
            log.append({"step": t + 1, "outer_ce": ce, "grad_norm": gn,
                        "s_per_step": dt})
            t0 = time.time()
        if agent_dir and (t + 1) % args.ckpt_every == 0:
            save_step(agent_dir, t + 1, _storable(state))
            say(f"checkpointed step {t + 1}", flush=True)

    peak = (torch.cuda.max_memory_allocated(mesh.device)
            if mesh.device.type == "cuda" else None)
    say("done.", flush=True)
    return {"arch": cfg.name, "reduced": bool(args.reduced),
            "dtype": cfg.dtype, "agents": m,
            "wire": mesh.wire, "device": str(mesh.device), "start": start,
            "steps": args.steps, "log": log,
            "step_seconds": mesh.gather_object(step_s),
            "peak_memory_bytes": mesh.gather_object(peak),
            "rank_digests": mesh.gather_object(_digest(state))}


def worker(args) -> None:
    import torch

    from repro_torch.launch import distributed as D
    from repro_torch.launch.launch_local import _await_go

    if args.go is not None:
        _await_go(args.go, args.timeout)
    if args.device == "cpu":
        # the processes share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.agents))
    D.initialize(_config(args))
    result = train(args, D.agent_mesh(args.agents))
    if args.process_id == 0 and args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    D.shutdown()


def _check(args) -> None:
    """Refuse, before starting anything, what the arguments rule out."""
    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh is the 16 x 16 (data, model) mesh: its model "
            "axis of 16 shards each layer over processes (tensor "
            "parallelism), which the port does not run; it waits for "
            "ROADMAP Queue A item 10.  The port runs one agent a process "
            "here (--agents), or an agent a pod of processes through the "
            "API (agent_mode='pods', launch/mesh.py)")
    if args.agents < 1:
        raise SystemExit(f"--agents {args.agents}: at least one agent")
    if args.device == "cpu" and args.wire == "nccl":
        raise SystemExit("NCCL moves CUDA tensors only: pass --wire gloo "
                         "with --device cpu")


def _prepare(args) -> None:
    """The launcher's checks that need torch: a card (and a card a
    process for NCCL) unless ``--device cpu``."""
    from repro_torch.launch.distributed import resolve_wire
    resolve_wire(_config(args))


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.worker:
        worker(args)
        return 0
    _check(args)
    from repro_torch.launch.launch_local import launch_workers
    out = args.out or os.path.join(tempfile.mkdtemp(prefix="train_"),
                                   "result.json")
    failed = launch_workers(
        "repro_torch.launch.train",
        list(argv if argv is not None else sys.argv[1:]), args.agents, out,
        args.timeout, prepare=lambda: _prepare(args))
    if failed:
        for pid, rc in failed:
            print(f"worker {pid} exited {rc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
