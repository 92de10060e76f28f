"""Time-varying topologies: mixing matrices as a per-step process.

Counterpart of ``repro.topology.process``, numpy only, so a stream
realized here is bit for bit the reference's.  A ``TopologyProcess``
realizes a ``(T, m, m)`` matrix stream (and a per-step active-edge mask)
from the base ``MixingSpec``; the engines take ``stream[t % T]`` as the
round's matrix (``repro_torch.topology.runtime``).

Registered processes (``@register_topology_process``):

    static         the base matrix every round: as a solver option it
                   attaches nothing, the fixed-matrix path bit for bit.
    link-failure   per-edge symmetric Bernoulli(p) drops; a dead link's
                   weight folds onto both endpoints' self weights, so
                   the matrix stays symmetric, doubly stochastic and
                   nonnegative.  ``p = 0`` reproduces the base matrix.
    straggler      each agent skips the round with probability p; its
                   links fold to self weight by the same rule.
    random-gossip  a random maximal matching of the base edges a round;
                   matched pairs average, everyone else holds.
    adaptive       similarity-reweighted Metropolis weights from the
                   iterates: state-dependent, no stream; the engines
                   compute the matrix on the device each step.

Step t of a stream depends only on ``(seed, t)``
(``np.random.default_rng([seed, t])``), so one seed realizes the same
schedule on every backend and for every stream length.
``stream_wire_bytes`` prices each round per active link.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.consensus.compress import CompressionConfig, make_compressor
from repro_torch.core.consensus import MixingSpec, second_eigenvalue

__all__ = [
    "TopologyProcessConfig",
    "TopologyStream",
    "adjacency_of",
    "available_topology_processes",
    "make_topology_process",
    "masked_mixing",
    "realize_stream",
    "register_topology_process",
    "stream_wire_bytes",
]

_EDGE_TOL = 1e-12


@dataclasses.dataclass(frozen=True)
class TopologyProcessConfig:
    """Declarative time-varying topology carried by ``SolverConfig``.

    Attributes:
      kind: "static" | "link-failure" | "straggler" | "random-gossip" |
        "adaptive" (see ``available_topology_processes()``).
      p: the per-round drop probability (link-failure: per edge;
        straggler: per agent).  Ignored by the others.
      period: realized stream length T; round t takes ``t % T``.
      tau: adaptive similarity temperature (``exp(-||x_i - x_j||^2 /
        tau)``).
      seed: stream seed; ``None`` takes ``SolverConfig.seed``.
    """

    kind: str = "static"
    p: float = 0.0
    period: int = 64
    tau: float = 1.0
    seed: int | None = None

    def __post_init__(self):
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"topology process p must be in [0, 1], "
                             f"got {self.p}")
        if self.period < 1:
            raise ValueError(f"topology period must be >= 1, got "
                             f"{self.period}")
        if self.tau <= 0.0:
            raise ValueError(f"adaptive tau must be > 0, got {self.tau}")

    @property
    def is_static(self) -> bool:
        return self.kind == "static"

    @property
    def state_dependent(self) -> bool:
        """Matrix computed from the iterates each step (no stream)."""
        return make_topology_process(self).state_dependent

    def structural_key(self) -> tuple:
        """What ``SolverConfig.static_key`` keys on: the kind, the period
        and tau.  ``p`` and the seed change only the stream's values,
        which a sweep group takes as a per-experiment operand, so a
        failure-rate grid of one algorithm is one group."""
        return (self.kind, self.period, self.tau)

    def resolve_seed(self, fallback: int) -> int:
        return fallback if self.seed is None else self.seed


@dataclasses.dataclass(frozen=True)
class TopologyStream:
    """A realized matrix process: ``(T, m, m)`` matrices + edge mask.

    Attributes:
      matrices:  (T, m, m) float64, each symmetric, doubly stochastic and
        nonnegative.
      edge_mask: (T, m, m) bool, the round's active links (off-diagonal,
        symmetric); an inactive link ships zero bytes.
    """

    matrices: np.ndarray
    edge_mask: np.ndarray

    @property
    def num_steps(self) -> int:
        return int(self.matrices.shape[0])

    @property
    def num_agents(self) -> int:
        return int(self.matrices.shape[1])

    def spectral_gaps(self) -> np.ndarray:
        """Per-step ``1 - lambda`` of each realized matrix (lambda =
        max{|lambda_2|, |lambda_m|}, the paper's mixing rate)."""
        return np.asarray([1.0 - second_eigenvalue(mat)
                           for mat in self.matrices])

    @property
    def mean_spectral_gap(self) -> float:
        """Mean spectral gap of the realized matrices."""
        return float(self.spectral_gaps().mean())

    def active_out_degree(self) -> np.ndarray:
        """(T, m) directed links each agent serves a round."""
        return self.edge_mask.sum(axis=2)

    def padded(self, pad_to: int) -> "TopologyStream":
        """Every matrix ghost-padded to ``pad_to`` agents with identity
        rows, as ``repro_torch.core.consensus.pad_mixing`` pads one; ghost
        links are never active."""
        T, m = self.matrices.shape[:2]
        if pad_to < m:
            raise ValueError(f"cannot pad {m} agents down to {pad_to}")
        mats = np.tile(np.eye(pad_to), (T, 1, 1))
        mats[:, :m, :m] = self.matrices
        mask = np.zeros((T, pad_to, pad_to), dtype=bool)
        mask[:, :m, :m] = self.edge_mask
        return TopologyStream(matrices=mats, edge_mask=mask)


def adjacency_of(mixing: MixingSpec | np.ndarray,
                 tol: float = _EDGE_TOL) -> np.ndarray:
    """The base graph's 0/1 adjacency: off-diagonal nonzero weights."""
    mat = np.asarray(getattr(mixing, "matrix", mixing), dtype=np.float64)
    adj = (np.abs(mat) > tol).astype(np.float64)
    np.fill_diagonal(adj, 0.0)
    return adj


def masked_mixing(base: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """The doubly-stochastic self-loop repair rule.

    Zero the off-diagonal entries where the symmetric mask ``keep`` is
    False and fold the dropped mass onto the diagonal: ``M'[i, i] =
    M[i, i] + sum_j dropped M[i, j]``.  With nothing dropped the diagonal
    is the original plus an exact 0.0, so the base matrix comes back bit
    for bit.
    """
    base = np.asarray(base, dtype=np.float64)
    keep = np.asarray(keep, dtype=bool)
    off = base.copy()
    np.fill_diagonal(off, 0.0)
    dropped = np.where(keep, 0.0, off)
    out = np.where(keep, off, 0.0)
    np.fill_diagonal(out, np.diagonal(base) + dropped.sum(axis=1))
    return out


def _step_rng(seed: int, t: int) -> np.random.Generator:
    """Step t's generator: depends only on (seed, t), never on T."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, int(t)])


_PROCESSES: dict[str, type] = {}


def register_topology_process(name: str) -> Callable[[type], type]:
    """Class decorator: register a ``TopologyProcess`` under ``name``."""

    def deco(cls: type) -> type:
        existing = _PROCESSES.get(name)
        if existing is not None and existing is not cls:
            raise ValueError(f"topology process {name!r} already "
                             f"registered ({existing.__name__})")
        _PROCESSES[name] = cls
        cls.name = name
        return cls

    return deco


def available_topology_processes() -> tuple[str, ...]:
    """Registered process names, sorted."""
    return tuple(sorted(_PROCESSES))


def make_topology_process(config: TopologyProcessConfig):
    """Instantiate the registered process for ``config.kind``."""
    try:
        cls = _PROCESSES[config.kind]
    except KeyError:
        raise ValueError(
            f"unknown topology process {config.kind!r}; "
            f"choose from {available_topology_processes()}") from None
    return cls(config)


class TopologyProcess:
    """Base class: realize a matrix stream from the base ``MixingSpec``.

    ``state_dependent`` processes compute the matrix from the iterates
    instead and cannot ``realize``.
    """

    state_dependent = False

    def __init__(self, config: TopologyProcessConfig):
        self.config = config

    def _step_matrix(self, base: np.ndarray, adj: np.ndarray,
                     rng: np.random.Generator
                     ) -> tuple[np.ndarray, np.ndarray]:
        """One round: ``(matrix, edge_keep_mask)``; both (m, m)."""
        raise NotImplementedError

    def realize(self, mixing: MixingSpec | np.ndarray, seed: int,
                num_steps: int | None = None) -> TopologyStream:
        """The ``(T, m, m)`` stream; ``T = num_steps or config.period``."""
        if self.state_dependent:
            raise ValueError(
                f"topology process {self.name!r} is state-dependent: the "
                "matrix is computed from the iterates each step and has "
                "no precomputable stream")
        base = np.asarray(getattr(mixing, "matrix", mixing),
                          dtype=np.float64)
        adj = adjacency_of(base)
        T = int(num_steps) if num_steps is not None else self.config.period
        mats = np.empty((T,) + base.shape)
        mask = np.empty((T,) + base.shape, dtype=bool)
        for t in range(T):
            mats[t], keep = self._step_matrix(base, adj, _step_rng(seed, t))
            mask[t] = keep & (adj > 0)
            np.fill_diagonal(mask[t], False)
        return TopologyStream(matrices=mats, edge_mask=mask)


@register_topology_process("static")
class StaticProcess(TopologyProcess):
    """The fixed-matrix baseline: every round is the base matrix."""

    def _step_matrix(self, base, adj, rng):
        return base.copy(), adj > 0


@register_topology_process("link-failure")
class LinkFailureProcess(TopologyProcess):
    """Per-edge symmetric Bernoulli(p) drops + self-loop repair."""

    def _step_matrix(self, base, adj, rng):
        m = base.shape[0]
        # symmetric draw: one Bernoulli per undirected edge
        up = rng.random((m, m)) >= self.config.p
        keep = np.triu(up, k=1)
        keep = keep | keep.T
        return masked_mixing(base, keep), keep


@register_topology_process("straggler")
class StragglerProcess(TopologyProcess):
    """Agents skip a round with probability p; links fold to self."""

    def _step_matrix(self, base, adj, rng):
        active = rng.random(base.shape[0]) >= self.config.p
        keep = np.outer(active, active)
        return masked_mixing(base, keep), keep


@register_topology_process("random-gossip")
class RandomGossipProcess(TopologyProcess):
    """A random maximal matching of the base edges a round: matched
    pairs average (weights 1/2), unmatched agents hold."""

    def _step_matrix(self, base, adj, rng):
        m = base.shape[0]
        edges = np.argwhere(np.triu(adj, k=1) > 0)
        rng.shuffle(edges)
        mat = np.eye(m)
        keep = np.zeros((m, m), dtype=bool)
        used = np.zeros(m, dtype=bool)
        for i, j in edges:
            if used[i] or used[j]:
                continue
            used[i] = used[j] = True
            mat[i, i] = mat[j, j] = 0.5
            mat[i, j] = mat[j, i] = 0.5
            keep[i, j] = keep[j, i] = True
        return mat, keep


@register_topology_process("adaptive")
class AdaptiveProcess(TopologyProcess):
    """Similarity-reweighted Metropolis weights, state-dependent (no
    stream): ``repro_torch.topology.runtime.adaptive_mixing``."""

    state_dependent = True


def realize_stream(config: TopologyProcessConfig,
                   mixing: MixingSpec | np.ndarray, seed: int,
                   num_steps: int | None = None) -> TopologyStream:
    """Realize ``config``'s stream over ``mixing`` (seed already
    resolved: pass ``config.resolve_seed(solver_seed)``)."""
    return make_topology_process(config).realize(mixing, seed, num_steps)


def stream_wire_bytes(stream: TopologyStream,
                      compression: CompressionConfig | None,
                      size: int, num_steps: int,
                      comms_per_step: int = 2,
                      communication_interval: int = 1) -> list[int]:
    """Network-total cumulative wire bytes after 0..num_steps steps,
    priced per active link of ``edge_mask[t % T]`` (a dropped link costs
    nothing), with the warm-up and interval schedules of
    ``cumulative_wire_bytes``.  ``size`` is the per-payload entry count.
    This is the unicast model; ``SolveResult.bytes_per_round`` is the
    broadcast one (one payload an agent a round)."""
    compression = compression or CompressionConfig()
    compressor = make_compressor(compression)
    full = 4 * size
    packed = compressor.bytes_on_wire(size)
    links = stream.edge_mask.sum(axis=(1, 2))       # directed, per round
    T = stream.num_steps
    out, total = [0], 0
    for t in range(num_steps):
        if t % communication_interval == 0:
            per_payload = (full if t < compression.compress_after
                           else packed)
            total += int(comms_per_step * per_payload * links[t % T])
        out.append(total)
    return out
