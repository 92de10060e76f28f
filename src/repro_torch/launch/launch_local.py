"""Localhost multi-process launcher for the Section-6 mesh runner.

Counterpart of ``scripts/launch_local.py``.  Spawns N worker processes of
this module, wires them into one ``torch.distributed`` group and runs
``repro_torch.launch.distributed.run_section6`` in lockstep:

    PYTHONPATH=src python -m repro_torch.launch.launch_local \\
        --device cpu --wire gloo --processes 2 --agents 8 --steps 30 \\
        --backend allgather --out result.json

The flags are the JAX launcher's, and three more: ``--device {cuda,cpu}``
(default ``cuda``: rank r on card r % cards; it raises where there is no
card), ``--wire {nccl,gloo}`` (default ``nccl``, which needs a card of
its own for each process and raises otherwise; ``gloo`` on the card
stages every payload through host memory, and every result says
``gloo-staged``), and the instance's widths ``--d-in``, ``--hidden`` and
``--classes`` (the JAX runner's defaults).  A process here holds one
device, so ``--devices-per-process`` takes only 1; the agents are spread
over the processes (``--agents`` a multiple of ``--processes``).

Process 0 writes the JSON result (final eq.-11 metric, trace, measured
and priced wire bytes, round latency, digests, kernel launches); the
launcher prints it.  When a worker exits non-zero the launcher kills the
others and exits 1, as it does when ``--timeout`` passes.
``--skip-init`` runs one process with no process group (an
``AgentMesh.local``: nothing crosses a wire), the baseline of a
one-process group.

Start-up.  Importing torch takes seconds, so the launcher starts the
workers first and makes its own checks while they import it: the
device and the wire (``resolve_wire``: a card, a card a rank for
NCCL), then, on the card, the one build of the consensus kernels.  A
worker waits for the launcher's go (a file beside ``--out``) before it
joins the group, so no worker loads a kernel before the build, and a
failed check kills the waiting workers and raises.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[2]

# the variables repro_torch.launch.distributed reads
ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--devices-per-process", type=int, default=1)
    ap.add_argument("--agents", type=int, default=8)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--record-every", type=int, default=10)
    ap.add_argument("--backend", default="allgather",
                    choices=("allgather", "ppermute"))
    ap.add_argument("--compression", default="none",
                    choices=("none", "int8", "sign1bit"))
    ap.add_argument("--compress-after", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-per-agent", type=int, default=80)
    ap.add_argument("--d-in", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=8)
    ap.add_argument("--classes", type=int, default=3)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--beta", type=float, default=0.1)
    ap.add_argument("--metric-inner-steps", type=int, default=120)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--wire", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--out", default=None,
                    help="JSON result path (default: temp file, printed)")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="wall-clock limit of the workers, seconds; also "
                         "the process group's collective timeout")
    ap.add_argument("--skip-init", action="store_true",
                    help="one process with no process group (requires "
                         "--processes 1)")
    # worker-only internals (the launcher spawns itself with these)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--process-id", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--go", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _config(args):
    from repro_torch.launch.distributed import DistributedConfig
    return DistributedConfig(
        coordinator=args.coordinator,
        num_processes=args.processes, process_id=args.process_id,
        wire=args.wire, device=args.device, timeout_s=args.timeout)


def _await_go(path: str, timeout: float) -> None:
    """Block until the launcher creates ``path`` (its checks passed and
    the kernels are built)."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no go from the launcher in {timeout} s")
        time.sleep(0.02)


def worker(args) -> None:
    import torch

    from repro_torch.launch import distributed as D
    from repro_torch.sharding.collectives import AgentMesh

    if args.go is not None:
        _await_go(args.go, args.timeout)

    if args.device == "cpu":
        # the processes share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // args.processes))
    mesh = None
    if args.skip_init:
        device, _ = D.resolve_wire(_config(args))
        mesh = AgentMesh.local(args.agents, device)
    else:
        D.initialize(_config(args))
    compression = None
    if args.compression != "none":
        from repro_torch.consensus import CompressionConfig
        compression = CompressionConfig(kind=args.compression,
                                        compress_after=args.compress_after)
    result = D.run_section6(
        num_agents=args.agents, num_steps=args.steps,
        record_every=args.record_every, backend=args.backend,
        compression=compression, seed=args.seed,
        n_per_agent=args.n_per_agent, d_in=args.d_in, hidden=args.hidden,
        classes=args.classes, alpha=args.alpha, beta=args.beta,
        metric_inner_steps=args.metric_inner_steps, mesh=mesh)
    result["skip_init"] = bool(args.skip_init)
    if args.process_id == 0:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    D.shutdown()


def _check(args) -> None:
    """Refuse, before spawning anything, what the arguments rule out."""
    if args.skip_init and args.processes != 1:
        raise SystemExit("--skip-init is the single-process baseline: "
                         "pass --processes 1 with it")
    if args.devices_per_process != 1:
        raise SystemExit(
            "each process of the port holds one device: pass "
            "--devices-per-process 1 and spread the agents over "
            "--processes instead")
    if args.processes < 1 or args.agents % args.processes:
        raise SystemExit(f"--processes {args.processes} does not divide "
                         f"--agents {args.agents}")
    if args.device == "cpu" and args.wire == "nccl":
        raise SystemExit("NCCL moves CUDA tensors only: pass --wire gloo "
                         "with --device cpu")


def _prepare(args) -> None:
    """The launcher's checks that need torch, and the build: run while
    the workers import torch."""
    from repro_torch.launch.distributed import resolve_wire
    resolve_wire(_config(args))
    if args.device == "cuda" and args.backend == "allgather":
        # one build for every worker, before any of them loads a kernel
        from repro_torch.kernels.build import build
        from repro_torch.kernels.consensus_step.ops import SOURCE
        build(SOURCE)


def _wait(procs, timeout: float) -> list[tuple[int, int]]:
    """Wait for every worker; at the first non-zero exit, or at the
    deadline, kill the rest.  Returns the failed (rank, code) pairs."""
    deadline = time.monotonic() + timeout
    failed = []
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes)
                      if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                return failed
            if time.monotonic() > deadline:
                return [(r, "timeout") for r, c in enumerate(codes)
                        if c is None]
            time.sleep(0.1)
    finally:
        _kill(procs)


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.worker:
        worker(args)
        return 0
    _check(args)
    out = args.out or os.path.join(tempfile.mkdtemp(prefix="launch_local_"),
                                   "result.json")
    go = f"{out}.go"
    if os.path.exists(go):
        os.remove(go)
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(SRC) + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else str(SRC))
    env[ENV_COORDINATOR] = coordinator
    env[ENV_NUM_PROCESSES] = str(args.processes)
    passthrough = [a for a in (argv if argv is not None else sys.argv[1:])
                   if a != "--worker"]
    procs = []
    for pid in range(args.processes):
        wenv = dict(env, **{ENV_PROCESS_ID: str(pid)})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.launch_local",
             *passthrough, "--out", out, "--worker", "--process-id",
             str(pid), "--coordinator", coordinator, "--go", go], env=wenv))
    try:
        _prepare(args)
    except BaseException:
        _kill(procs)
        raise
    with open(go, "w"):
        pass
    failed = _wait(procs, args.timeout)
    os.remove(go)
    if failed:
        for pid, rc in failed:
            print(f"worker {pid} exited {rc}", file=sys.stderr)
        return 1
    with open(out) as f:
        result = json.load(f)
    print(json.dumps(result, indent=1))
    if args.out is None:
        print(f"\n(result written to {out})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
