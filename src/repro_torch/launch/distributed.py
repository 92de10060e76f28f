"""Multi-process path: a ``torch.distributed`` group and the Section-6 run.

Counterpart of ``repro.launch.distributed``.  The single-process solvers
hold every agent in one process; here the agents are spread over the
ranks of a process group, each rank holding a contiguous block of them
(``AgentMesh``), and the mesh consensus backends (``allgather``,
``ppermute``) mix across ranks:

* ``initialize`` / ``initialize_from_env``: ``init_process_group`` for
  this process (idempotent), from a ``DistributedConfig`` or from the
  ``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID``
  variables the localhost launcher exports
  (``python -m repro_torch.launch.launch_local``).  The device is the
  CUDA card unless ``device="cpu"`` is asked for; rank r takes ``cuda:(r
  % device_count)``.  The wire is chosen by the caller and never
  switched: ``nccl`` (a card of its own for each rank; it raises when
  two ranks would share one, which NCCL refuses) or ``gloo`` (on the CPU,
  or, on the card, each payload staged through host memory: labelled
  ``gloo-staged`` in every result).  The group's timeout bounds every
  collective, so a rank that dies cannot hang the others for ever.
* ``agent_mesh`` — this process's ``AgentMesh`` over the initialised
  group: m / world agents a rank, from ``rank * m / world``.
* ``pods_mesh`` — this process's ``PodsMesh`` over the initialised group
  laid out as a (pod, data, model) ``ProcessMesh``
  (``repro_torch.launch.mesh``): m pods of k ranks,
  an agent a pod, the train steps' ``agent_mode="pods"``.  Every rank
  makes every subgroup, in one order: the k rings (the ranks of one data
  index across the pods), then the m pods.  A model axis above 1 raises.
* ``run_section6`` — the paper's Section-6 instance stepped by the
  registry INTERACT solver on every rank's rows, in lockstep, with the
  eq.-11 metric recorded between chunks on the gathered iterates and a
  ``CommsLedger`` measuring the bytes the run shipped, reconciled against
  the broadcast price (``allgather``) and the per-link price
  (``ppermute``).

Every process runs the same ``run_section6`` call with the same
arguments: each builds the whole host instance from the seed (or from
``setup``) and keeps its rows.  Stepping is eager.
"""
from __future__ import annotations

import dataclasses
import datetime
import gc
import hashlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.sharding.collectives import AgentMesh, PodsMesh, gather_tree

__all__ = [
    "AgentMesh",
    "DistributedConfig",
    "PodsMesh",
    "agent_mesh",
    "eq11_metric",
    "gather_tree",
    "initialize",
    "initialize_from_env",
    "pods_mesh",
    "run_section6",
    "shard_host_tree",
    "shutdown",
]

ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"

WIRES = ("nccl", "gloo")

# the initialised process: its device and its wire's label
_STATE: dict = {}


@dataclasses.dataclass
class DistributedConfig:
    """Where this process sits in the multi-process run.

    ``coordinator`` is rank 0's ``host:port``, which ``initialize``
    needs (no fixed port: two runs on one host would collide; the
    launcher picks a free one); ``wire`` is the process group's backend,
    ``"nccl"`` or ``"gloo"``; ``device`` is ``"cuda"`` (the default,
    ``None``: the card) or ``"cpu"``; ``timeout_s`` bounds the group's
    set-up and each collective.
    """

    coordinator: str | None = None
    num_processes: int = 1
    process_id: int = 0
    wire: str = "nccl"
    device: str | None = None
    timeout_s: float = 300.0


def resolve_wire(config: DistributedConfig) -> tuple[torch.device, str]:
    """``(device, wire label)`` of ``config``'s process, or the reason it
    cannot run: no card, NCCL on the CPU, or more NCCL ranks than cards."""
    if config.wire not in WIRES:
        raise ValueError(f"unknown wire {config.wire!r}; choose from {WIRES}")
    n = int(config.num_processes)
    if config.device in (None, "cuda"):
        # counted through NVML where it can: the launcher checks before
        # it spawns, without initialising CUDA in its own process
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (--device "
                "cpu, with --wire gloo) to run the processes on the CPU")
        if config.wire == "nccl" and n > count:
            raise ValueError(
                f"--wire nccl needs a card of its own for each of the {n} "
                f"processes and this host has {count}: NCCL refuses two "
                f"ranks on one card.  Launch at most {count} processes, or "
                "pass --wire gloo to stage each payload through host memory")
        device = torch.device("cuda", int(config.process_id) % count)
        return device, "nccl" if config.wire == "nccl" else "gloo-staged"
    if config.device == "cpu":
        if config.wire == "nccl":
            raise ValueError("NCCL moves CUDA tensors only: pass --wire gloo "
                             "with --device cpu")
        return torch.device("cpu"), "gloo"
    raise ValueError(f"unknown device {config.device!r}; use 'cuda' or 'cpu'")


def initialize(config: DistributedConfig) -> bool:
    """``init_process_group`` for this process (idempotent); returns True
    once the group is up.  Raises where ``resolve_wire`` does, and
    without a coordinator."""
    if _STATE:
        return True
    device, label = resolve_wire(config)
    if not config.coordinator:
        raise ValueError("DistributedConfig.coordinator is not set: pass "
                         "rank 0's host:port (any free port)")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend=config.wire, init_method=f"tcp://{config.coordinator}",
        world_size=int(config.num_processes), rank=int(config.process_id),
        timeout=datetime.timedelta(seconds=float(config.timeout_s)))
    _STATE.update(device=device, wire=label)
    return True


def initialize_from_env(wire: str = "nccl", device: str | None = None,
                        timeout_s: float = 300.0) -> bool:
    """Initialise from the ``REPRO_*`` variables; False without them."""
    coord = os.environ.get(ENV_COORDINATOR)
    nproc = int(os.environ.get(ENV_NUM_PROCESSES, "0") or 0)
    if coord is None or nproc < 1:
        return False
    return initialize(DistributedConfig(
        coordinator=coord, num_processes=nproc,
        process_id=int(os.environ.get(ENV_PROCESS_ID, "0")), wire=wire,
        device=device, timeout_s=timeout_s))


def shutdown() -> None:
    """Tear the process group down (idempotent)."""
    if _STATE:
        dist.destroy_process_group()
        _STATE.clear()


def agent_mesh(num_agents: int) -> AgentMesh:
    """This process's ``AgentMesh`` of ``num_agents`` agents over the
    initialised group.  The world size must divide m; raises an
    actionable error otherwise."""
    if not _STATE:
        raise RuntimeError(
            "no process group: call repro_torch.launch.distributed."
            "initialize first (python -m repro_torch.launch.launch_local "
            "does), or build an AgentMesh.local for one process")
    n, m = dist.get_world_size(), int(num_agents)
    if m < 1 or m % n:
        raise ValueError(
            f"num_agents={m} does not divide over the {n} processes: pick "
            f"m from the multiples of {n}, or relaunch with --processes "
            f"set to a divisor of m (python -m repro_torch.launch."
            f"launch_local)")
    return AgentMesh(m, n, dist.get_rank(), _STATE["device"], _STATE["wire"])


def pods_mesh(mesh) -> PodsMesh:
    """This process's ``PodsMesh`` over the initialised group.

    ``mesh`` is a ``ProcessMesh`` (``repro_torch.launch.mesh.
    make_production_mesh``) with a ``pod`` axis (m agents), a ``data``
    axis (k ranks a pod) and, optionally, a ``model`` axis of 1.  It must
    hold the whole group.  The subgroups are made once a shape.
    """
    if not _STATE:
        raise RuntimeError(
            "no process group: call repro_torch.launch.distributed."
            "initialize first (launch_local.launch_workers starts the "
            "processes)")
    dims = mesh.shape
    if "pod" not in dims or "data" not in dims:
        raise ValueError(f"agent_mode='pods' needs a mesh with 'pod' and "
                         f"'data' axes, got {mesh.axis_names}")
    if dims.get("model", 1) != 1:
        raise NotImplementedError(
            f"a model axis of {dims['model']} shards each layer over "
            "processes (tensor parallelism), which the port does not run: "
            "it waits for ROADMAP Queue A item 10; pass a model axis of 1")
    world = dist.get_world_size()
    if mesh.size != world:
        raise ValueError(f"the mesh {mesh.dims} holds {mesh.size} "
                         f"processes, the group {world}")
    m, k = dims["pod"], dims["data"]
    key = ("pods", mesh.axis_names, mesh.dims)
    if key not in _STATE:
        at = lambda p, d: mesh.rank_of(
            **{"pod": p, "data": d, **({"model": 0} if "model" in dims
                                       else {})})
        rings = [tuple(at(p, d) for p in range(m)) for d in range(k)]
        pods = [tuple(at(p, d) for d in range(k)) for p in range(m)]
        _STATE[key] = [(ranks, dist.new_group(list(ranks)))
                       for ranks in rings + pods]
    coords = mesh.coords(dist.get_rank())
    ring_ranks, ring = _STATE[key][coords["data"]]
    pod_ranks, pod = _STATE[key][k + coords["pod"]]
    dev, wire = _STATE["device"], _STATE["wire"]
    return PodsMesh(
        ring=AgentMesh(m, m, coords["pod"], dev, wire, ring, ring_ranks),
        pod=AgentMesh(k, k, coords["data"], dev, wire, pod, pod_ranks))


def shard_host_tree(mesh: AgentMesh, tree, num_agents: int):
    """Host tree (numpy or tensors) -> this process's tensors on
    ``mesh.device``: leaves with a leading agent axis of ``num_agents``
    keep the process's rows, every other leaf whole."""
    row0, k = mesh.row0, mesh.local_agents

    def put(leaf):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
            np.asarray(leaf))
        if t.dim() and t.shape[0] == num_agents:
            t = t[row0:row0 + k]
        return t.to(mesh.device).contiguous()

    return pytree.tree_map(put, tree)


def eq11_metric(problem, hg_cfg, data, inner_steps: int, inner_lr: float):
    """The eq.-11 metric of every agent's ``(x, y)`` against ``data`` as
    a host call ``metric(x, y) -> float``.

    On the card one CUDA graph of it, captured at the first call (after
    an eager warm-up on a side stream) and replayed with the iterates
    copied into its input buffers: the graph holds the eager metric's
    kernels in its order, so it gives the eager value bit for bit, in
    tens of milliseconds where the eager metric's host dispatch takes
    seconds (the JAX package compiles it).  Later calls take iterates of
    the first call's shapes and strides.  On the CPU it runs eagerly.
    """
    from repro_torch.core import convergence_metric

    def value(x, y):
        return convergence_metric(problem, hg_cfg, x, y, inner_steps,
                                  inner_lr, data).total

    held = {}

    def metric(x, y) -> float:
        if data.inner_x.device.type != "cuda":
            return float(value(x, y))
        if not held:
            static = pytree.tree_map(torch.clone, (x, y))
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                value(*static)
            torch.cuda.current_stream().wait_stream(side)
            gc.collect()    # no dead graph may be freed mid-capture
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = value(*static)
            held.update(graph=graph, static=static, out=out)
        for dst, src in zip(pytree.tree_leaves(held["static"]),
                            pytree.tree_leaves((x, y)), strict=True):
            dst.copy_(src)
        held["graph"].replay()
        return float(held["out"])

    return metric


def _digest(host_tree) -> str:
    h = hashlib.sha256()
    for leaf in pytree.tree_leaves(host_tree):
        h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()


def _section6_instance(mesh: AgentMesh, m: int, setup, seed: int,
                       n_per_agent: int, d_in: int, hidden: int,
                       classes: int):
    """``(problem, x0, y0, data)`` on ``mesh.device``, the whole data:
    the port's ``default_setup`` from the seed, or the handed-over host
    instance ``setup = (x0, y0, data)`` (numpy)."""
    from repro_torch.convert import agent_data_from_numpy, tree_from_numpy
    from repro_torch.core import MLPMetaProblem
    from repro_torch.solvers.api import default_setup
    if setup is None:
        return default_setup(seed, num_agents=m, n_per_agent=n_per_agent,
                             d_in=d_in, hidden=hidden, classes=classes,
                             device=mesh.device)
    x0, y0, data = setup
    data = agent_data_from_numpy(data, mesh.device)
    if data.inner_x.shape[0] != m:
        raise ValueError(f"setup carries {data.inner_x.shape[0]} agents, "
                         f"not num_agents={m}")
    return (MLPMetaProblem(mu_g=0.5, lipschitz_g=4.0),
            tree_from_numpy(x0, mesh.device),
            tree_from_numpy(y0, mesh.device), data)


def run_section6(*, num_agents: int = 8, num_steps: int = 30,
                 record_every: int = 10, backend: str = "allgather",
                 compression=None, communication_interval: int = 1,
                 seed: int = 0, n_per_agent: int = 80, d_in: int = 8,
                 hidden: int = 8, classes: int = 3,
                 alpha: float = 0.1, beta: float = 0.1,
                 metric_inner_steps: int = 120,
                 metric_inner_lr: float = 0.5,
                 latency_reps: int = 5, setup=None,
                 algo: str = "interact", mesh: AgentMesh | None = None
                 ) -> dict:
    """Section-6 INTERACT across the process group, measured end to end.

    Builds the instance (``setup = (x0, y0, data)`` as numpy, or the
    port's ``default_setup`` from ``seed``) and the registry solver on
    every process, keeps each process's rows of the state and the data
    (``mesh``, by default ``agent_mesh(num_agents)``), steps eagerly in
    ``record_every`` chunks, and records the eq.-11 metric between
    chunks on the gathered iterates against the whole data (computed on
    rank 0 and sent to the others), the computation the single-process
    run records.  ``algo`` picks another registry solver.

    The metric is ``eq11_metric``'s: one captured graph on the card.

    A ``CommsLedger`` is attached before stepping: ``measured_wire_bytes``
    is what the run's combines shipped, ``priced_wire_bytes`` the
    broadcast model (``cumulative_wire_bytes``) and
    ``per_link_priced_bytes`` the ``ppermute`` unicast model.

    Returns a JSON-ready dict, the same on every process apart from
    ``round_latency_us`` (this process's own timing).  Beyond the JAX
    package's keys: ``algo``, ``wire``, ``device``, ``agents_per_process``,
    ``rounds_per_mix``, ``us_per_step`` (the slowest process's eager
    stepping, metrics excluded), ``setup_s`` and ``wall_s`` (the slowest
    process's time to its initial state and for the whole call),
    ``rank_digests`` (each process's digest
    of the gathered final x) and ``kernel_launches`` (each process's
    consensus kernel launches during the call, the row-block ones apart:
    ``allgather`` launches ``consensus_step`` once a step and
    ``consensus_mix`` for the round-latency mixes).
    """
    from repro_torch.consensus import (CompressionConfig, attach_ledger,
                                       cumulative_wire_bytes, time_round_us)
    from repro_torch.device import synchronize
    from repro_torch.kernels.consensus_step import ops
    from repro_torch.solvers import SolverConfig, make_solver
    from repro_torch.solvers.api import _chunks

    if backend not in ("allgather", "ppermute"):
        raise ValueError(
            f"the mesh runner drives the process-group backends "
            f"('allgather', 'ppermute'), got {backend!r}")
    t_call = time.perf_counter()
    m = int(num_agents)
    mesh = agent_mesh(m) if mesh is None else mesh
    problem, x0, y0, data = _section6_instance(
        mesh, m, setup, seed, n_per_agent, d_in, hidden, classes)
    local = shard_host_tree(mesh, data, m)

    config = SolverConfig(
        algo=algo, alpha=alpha, beta=beta, num_agents=m, backend=backend,
        backend_opts={"mesh": mesh},
        compression=compression or CompressionConfig(),
        communication_interval=communication_interval, seed=seed)
    solver = make_solver(config)
    state = solver.init(problem, None, x0, y0, local)
    engine = solver._engine
    ledger = attach_ledger(engine)
    synchronize(mesh.device)
    setup_s = time.perf_counter() - t_call
    eq11 = eq11_metric(problem, solver._hg_cfg, data, metric_inner_steps,
                       metric_inner_lr)

    def metric(st) -> float:
        full = gather_tree(mesh, (st.x, st.y))
        return mesh.broadcast_object(eq11(*full) if mesh.rank == 0
                                     else None)

    counted = ("consensus_step", "consensus_mix")
    before = ({k: ops.LAUNCHES[k] for k in counted},
              {k: ops.ROW_LAUNCHES[k] for k in counted})
    trace, took = [], 0.0
    for length in _chunks(num_steps, record_every):
        trace.append(metric(state))
        synchronize(mesh.device)
        t0 = time.perf_counter()
        state = solver.run(state, local, length)
        synchronize(mesh.device)
        took += time.perf_counter() - t0
    final_metric = metric(state)
    trace.append(final_metric)
    ledger.observe_latency(time_round_us(engine.mix, state.x,
                                         reps=latency_reps))
    launches = {k: ops.LAUNCHES[k] - before[0][k] for k in counted}
    launches.update({f"{k}_rows": ops.ROW_LAUNCHES[k] - before[1][k]
                     for k in counted})
    host_x = pytree.tree_map(lambda t: t.cpu().numpy(),
                             gather_tree(mesh, state.x))

    ledger.commit_steps(num_steps)
    payload_entries = sum(int(l.numel()) for l in pytree.tree_leaves(x0))
    priced = cumulative_wire_bytes(
        engine.compression, payload_entries, num_steps,
        comms_per_step=solver.communications_per_step,
        communication_interval=communication_interval)[-1]
    per_agent_payload = pytree.tree_map(lambda l: l[0], state.x)
    per_link = (solver.communications_per_step * num_steps
                * engine.bytes_on_wire(per_agent_payload))
    digest = _digest(host_x)
    # a CPU process is a device of its own, as each JAX process's is
    devices = mesh.gather_object(str(mesh.device) if mesh.device.type ==
                                 "cuda" else f"cpu:{mesh.rank}")

    return {
        "backend": backend,
        "algo": algo,
        "num_agents": m,
        "num_processes": mesh.world_size,
        "num_devices": len(set(devices)),
        "mesh_shape": {"data": m},
        "agents_per_process": mesh.local_agents,
        "wire": mesh.wire,
        "device": str(mesh.device),
        "num_steps": num_steps,
        "compression": engine.compression.kind,
        "rounds_per_mix": getattr(engine, "rounds_per_mix", None),
        "final_metric": final_metric,
        "trace": trace,
        "digest": digest,
        "rank_digests": mesh.gather_object(digest),
        "measured_wire_bytes": ledger.measured_wire_bytes,
        "priced_wire_bytes": float(priced),
        "per_link_priced_bytes": float(per_link),
        "round_latency_us": ledger.round_latency_us,
        "us_per_step": 1e6 * max(mesh.gather_object(took))
        / max(num_steps, 1),
        "setup_s": max(mesh.gather_object(setup_s)),
        "wall_s": max(mesh.gather_object(time.perf_counter() - t_call)),
        "kernel_launches": mesh.gather_object(launches),
        "ledger": ledger.summary(),
    }
