"""Engine-side topology runtimes: the round's matrix on the device.

Counterpart of ``repro.topology.runtime`` for the ``dense`` and ``cuda``
backends.  An engine with a time-varying topology carries one of these
on ``engine.topology``; ``ConsensusEngine.topology_matrix(t, tree)``
hands the round's matrix to the combine as a per-call operand.

    StreamTopology    the realized (T, m, m) stream on the device and one
                      static (m, m) round buffer.  ``load(t)`` copies
                      ``stream[t % T]`` into the buffer; the combine
                      reads the buffer.  A captured CUDA graph holds the
                      buffer's address, so the stepper loads each step's
                      matrix before its replay, as it copies the draws;
                      indexing the stream inside a capture would bake one
                      slice into the graph, so that raises.
    AdaptiveTopology  the matrix computed on the device from the iterates
                      each step (``adaptive_mixing``); inside a graph it
                      is part of the graph.

On the ``ppermute`` backend, which has no matrix, a stream runs as
``PermuteStreamTopology``: per-step weights on the base schedule's
offsets, loaded into a static ``PermuteWeights`` round buffer the same
way.  The ``allgather`` backend holds the full matrix and takes the
round's from a ``StreamTopology``.

A sweep group whose experiments realize different streams (another
failure rate or stream seed each) holds them in one
``GroupStreamTopology``: (E, T, m, m) on the device and a (B, m, m)
round buffer that ``load(t)`` fills for the whole group before each
step; inside the group's vmapped step each experiment's engine reads
its slice of it through a ``RoundTopology``.

``attach_topology`` installs the runtime ``SolverBase.build`` asks for.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.topology.process import (
    TopologyProcessConfig,
    TopologyStream,
    adjacency_of,
    make_topology_process,
    realize_stream,
)

__all__ = [
    "AdaptiveTopology",
    "GroupStreamTopology",
    "PermuteStreamTopology",
    "RoundTopology",
    "StreamTopology",
    "adaptive_mixing",
    "agents_matrix",
    "attach_topology",
    "stream_of",
]


def agents_matrix(tree) -> torch.Tensor:
    """A per-agent pytree as (m, D) float32: the similarity input."""
    leaves = pytree.tree_leaves(tree)
    m = leaves[0].shape[0]
    return torch.cat([l.reshape(m, -1).to(torch.float32) for l in leaves],
                     dim=1)


def adaptive_mixing(x2d: torch.Tensor, adjacency: torch.Tensor,
                    tau: float) -> torch.Tensor:
    """Similarity-reweighted Metropolis matrix (Dada-style).

    ``s_ij = adj_ij * exp(-||x_i - x_j||^2 / tau)`` takes the degree's
    place in the Metropolis rule: ``W_ij = s_ij / (1 + max(r_i, r_j))``
    with ``r_i = sum_j s_ij``, diagonal ``1 - sum_j W_ij``: symmetric,
    rows summing to 1, nonnegative.
    """
    sq = torch.sum(x2d * x2d, dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (x2d @ x2d.T),
                     min=0.0)
    s = adjacency * torch.exp(-d2 / tau)
    r = torch.sum(s, dim=1)
    w = s / (1.0 + torch.maximum(r[:, None], r[None, :]))
    return w + torch.diag(1.0 - torch.sum(w, dim=1))


class StreamTopology:
    """A realized stream on the device, read through a round buffer."""

    def __init__(self, matrices, device: torch.device | str):
        self.matrices = torch.as_tensor(np.asarray(matrices),
                                        dtype=torch.float32, device=device)
        self.period = int(self.matrices.shape[0])
        self.round = self.matrices[0].clone()
        self.loaded: int | None = None

    def load(self, t: int) -> None:
        """Copy step ``t``'s matrix into the round buffer."""
        self.round.copy_(self.matrices[int(t) % self.period])
        self.loaded = int(t)

    def matrix_at(self, t, tree=None) -> torch.Tensor:
        del tree
        if int(t) != self.loaded:
            if self.round.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"step {t}'s topology matrix was not loaded before the "
                    "capture: call engine.load_round(t) outside the graph "
                    "(a slice taken inside it would replay every step)")
            self.load(t)
        return self.round


class AdaptiveTopology:
    """State-dependent matrix: computed from the iterates each step."""

    def __init__(self, adjacency, tau: float, device: torch.device | str):
        if isinstance(adjacency, torch.Tensor):   # one per experiment, too
            self.adjacency = adjacency.to(device=device, dtype=torch.float32)
        else:
            self.adjacency = torch.as_tensor(np.asarray(adjacency),
                                             dtype=torch.float32,
                                             device=device)
        self.tau = float(tau)

    def load(self, t: int) -> None:
        """Nothing to load: the matrix comes from the iterates."""

    def matrix_at(self, t, tree=None) -> torch.Tensor:
        del t
        if tree is None:
            raise ValueError(
                "the adaptive topology computes its matrix from the "
                "iterates; mix through step1_step3 / mix_ef, or pass "
                "matrix= yourself")
        return adaptive_mixing(agents_matrix(tree), self.adjacency,
                               self.tau)


class PermuteStreamTopology:
    """Per-step weights on the base schedule's shared offsets (ppermute).

    Holds ``weights[t, k, i] = M_t[i, (i + offsets[k]) % m]``, the
    per-step diagonals and the matrices of the realized stream on the
    device; ``load(t)`` copies step ``t % T``'s into one static
    ``PermuteWeights`` round buffer, which ``matrix_at`` returns.  A
    stream with weight on an edge outside the base offsets raises: the
    rounds are the schedule's, only their weights vary.
    """

    def __init__(self, schedule, matrices, device: torch.device | str):
        from repro_torch.sharding.collectives import PermuteWeights
        mats = np.asarray(matrices, dtype=np.float64)
        m = schedule.num_agents
        if mats.shape[1:] != (m, m):
            raise ValueError(
                f"stream is {mats.shape[1:]} but the schedule mixes "
                f"{m} agents")
        idx = np.arange(m)
        covered = np.zeros((m, m), dtype=bool)
        np.fill_diagonal(covered, True)
        for o in schedule.offsets:
            covered[idx, (idx + o) % m] = True
        stray = np.abs(mats[:, ~covered]).max(initial=0.0)
        if stray > 1e-12:
            raise ValueError(
                "realized topology stream places weight on edges outside "
                "the base schedule's offsets: a time-varying ppermute "
                "shares the base offset schedule and can only drop or "
                "reweight its edges")
        weights = (np.stack([mats[:, idx, (idx + o) % m]
                             for o in schedule.offsets], axis=1)
                   if schedule.offsets else np.zeros((mats.shape[0], 0, m)))
        as_f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                           device=device)
        self.offsets = schedule.offsets
        self.stream = PermuteWeights(
            weights=as_f32(weights),
            self_weights=as_f32(np.diagonal(mats, axis1=1, axis2=2).copy()),
            matrix=as_f32(mats))
        self.period = int(mats.shape[0])
        self.round = PermuteWeights(*(f[0].clone() for f in self.stream))
        self.loaded: int | None = None

    def load(self, t: int) -> None:
        """Copy step ``t``'s weights into the round buffer."""
        for buf, f in zip(self.round, self.stream):
            buf.copy_(f[int(t) % self.period])
        self.loaded = int(t)

    def matrix_at(self, t, tree=None):
        del tree
        if int(t) != self.loaded:
            self.load(t)
        return self.round


class RoundTopology:
    """One experiment's round matrix inside a sweep group's vmapped step:
    its slice of the group's round buffer, loaded before the step."""

    def __init__(self, round_matrix: torch.Tensor):
        self.round = round_matrix

    def load(self, t: int) -> None:
        """Nothing to load: the group loads the buffer."""

    def matrix_at(self, t, tree=None) -> torch.Tensor:
        del t, tree
        return self.round


class GroupStreamTopology:
    """The realized streams of a sweep group's experiments, one each.

    ``matrices`` is every experiment's (T, m, m) stream, stacked on the
    device; ``round`` the (B, m, m) buffer of the experiments ``rows``
    names (all of them for the group, one for a sequential replay of a
    single row, ``select``), which ``load(t)`` fills with their
    ``stream[t % T]`` on the device.
    """

    def __init__(self, matrices, device: torch.device | str,
                 rows: list[int] | None = None):
        self.matrices = torch.as_tensor(np.stack(matrices),
                                        dtype=torch.float32, device=device)
        self.period = int(self.matrices.shape[1])
        rows = list(range(self.matrices.shape[0])) if rows is None else rows
        self.round = torch.empty((len(rows),) + self.matrices.shape[2:],
                                 dtype=torch.float32, device=device)
        self.select(rows)

    def select(self, rows: list[int]) -> None:
        """Load the experiments ``rows`` from the next ``load`` on."""
        if len(rows) != self.round.shape[0]:
            raise ValueError(f"the round buffer holds {self.round.shape[0]}"
                             f" experiments, not {len(rows)}")
        self.index = torch.as_tensor(list(rows), device=self.round.device)

    def load(self, t: int) -> None:
        """Copy step ``t``'s matrices into the round buffer."""
        self.round.copy_(self.matrices[self.index, int(t) % self.period])


def attach_topology(engine, config: TopologyProcessConfig, mixing,
                    seed: int):
    """Install the runtime matching ``config`` on a built engine, on the
    engine's device.

    Nothing for the static process (the fixed-matrix path bit for bit).
    A stream process also leaves the realized host-side
    ``TopologyStream`` on ``engine.topology_stream`` for accounting.
    ``seed`` is the fallback (``SolverConfig.seed``) when the process
    config carries none.
    """
    if config.is_static:
        return engine
    device = engine.matrix.device
    if make_topology_process(config).state_dependent:
        if engine.local_rows is not None:
            raise ValueError(
                "the adaptive topology needs the full similarity matrix "
                f"per step, which the {engine.name} backend's agent slice "
                "cannot compute; use the dense or cuda backend")
        engine.topology = AdaptiveTopology(adjacency_of(mixing), config.tau,
                                           device)
        return engine
    stream = realize_stream(config, mixing, config.resolve_seed(seed))
    engine.topology_stream = stream
    if engine.name == "ppermute":
        engine.topology = PermuteStreamTopology(engine.schedule,
                                                stream.matrices, device)
    else:
        engine.topology = StreamTopology(stream.matrices, device)
    return engine


def stream_of(engine) -> TopologyStream | None:
    """The host-side realized stream attached by ``attach_topology``."""
    return engine.topology_stream
