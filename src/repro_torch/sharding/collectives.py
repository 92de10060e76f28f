"""Sparse consensus over a process group: any mixing matrix as permutes.

Counterpart of ``repro.sharding.collectives``.  There the agents sit on a
device-mesh axis inside ``shard_map``; here they sit on the ranks of a
``torch.distributed`` process group, held by an ``AgentMesh``: rank r
holds the contiguous agents ``r * k .. r * k + k - 1`` (k = m / world),
and an agent's index is its rank when k = 1.

The combine ``x_i <- sum_j M_ij x_j`` is realised without the (m, m)
matrix: any matrix is decomposed into per-*offset* rounds
(``permute_schedule``).  For offset o agent j receives the payload of
agent (j + o) mod m, one ``dist.batch_isend_irecv`` round (a cyclic shift
is always a permutation), and scales it by its own row weight ``M[j, (j +
o) mod m]``.  The wire costs one payload a leaf per offset, so structured
graphs stay cheap (ring 2, torus 4-5) and a dense Erdős–Rényi sample may
approach m - 1 rounds; ``impl="psum"`` realises the same matrix as one
``all_reduce`` of an m-row contribution instead.  The engine never
switches between them on its own.

Options carried by the schedule's engine rather than per call:

* int8 compression (``compress="int8"``): one per-tensor scale, the
  outgoing payload quantised once a round and sent as (q, scale).
* local-DP noise (``dp_sigma``): Gaussian noise on the *outgoing* payload
  only; the agent's own term mixes its clean value.  The noise is drawn
  on the host from numpy, ``default_rng([seed, DP_TAG, leaf, slot, t])``
  for the round's ``dp_key = (seed, t)``, not from ``jax.random``, so it
  can be replayed; leaves and slots draw independently, so a neighbour
  cannot difference two leaves to cancel it.

The wire.  ``AgentMesh`` does the collectives: NCCL on CUDA tensors,
gloo on CPU tensors, or, chosen explicitly, gloo on CUDA tensors staged
through host memory (device to host, the collective, host to device),
labelled ``gloo-staged``.  A mesh of one process with no process group
(``AgentMesh.local``) ships nothing: its gather is the identity.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

__all__ = [
    "AgentMesh", "DP_TAG", "PermuteSchedule", "PermuteWeights",
    "dequantize_int8", "dp_noise", "gather_tree",
    "permute_mix_leaf", "permute_mix_tree", "permute_schedule",
    "quantize_int8", "ring_mix_leaf", "ring_mix_tree",
]

# entropy tag of the local-DP noise generators (ASCII "dpno"); see the
# Byzantine layer's tags for why a tag leads the stream's words
DP_TAG = 0x64706E6F

# torch >= 2.13 names the collective all_gather_single
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


@dataclasses.dataclass(frozen=True, eq=False)
class AgentMesh:
    """Where this process sits among the agents.

    Attributes:
      num_agents: m.
      world_size: processes in the group; it divides m.
      rank:       this process's rank.
      device:     the device this process's rows live on.
      wire:       ``"nccl"``, ``"gloo"``, ``"gloo-staged"`` (gloo on CUDA
                  tensors through host memory) or ``"local"`` (one process,
                  no group: nothing crosses a wire).

    The collectives run on the default process group.
    """

    num_agents: int
    world_size: int
    rank: int
    device: torch.device
    wire: str

    @classmethod
    def local(cls, num_agents: int, device: torch.device | str
              ) -> "AgentMesh":
        """All m agents in this one process, with no process group."""
        return cls(int(num_agents), 1, 0, torch.device(device), "local")

    @property
    def local_agents(self) -> int:
        """k = m / world: the agents this process holds."""
        return self.num_agents // self.world_size

    @property
    def row0(self) -> int:
        """The global slot of this process's first agent."""
        return self.rank * self.local_agents

    # -- the wire -----------------------------------------------------------

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the collective takes it: on the host when staged."""
        return t.cpu() if self.wire == "gloo-staged" else t

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.wire == "gloo-staged" else t

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every process's (k, ...) ``x`` stacked in rank order: (m, ...)."""
        if self.wire == "local":
            return x.clone()
        src = self._out(x.contiguous())
        out = src.new_empty((self.world_size * src.shape[0],)
                            + tuple(src.shape[1:]))
        _ALL_GATHER(out, src)
        return self._back(out)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over processes of ``x`` (a new tensor)."""
        if self.wire == "local":
            return x.clone()
        buf = self._out(x.contiguous().clone())
        dist.all_reduce(buf)
        return self._back(buf)

    def permute(self, tensors: list[torch.Tensor], offset: int
                ) -> list[torch.Tensor]:
        """One cyclic-shift round: rank j receives rank (j + offset) mod
        world's ``tensors`` (one ``batch_isend_irecv`` of all of them)."""
        if self.wire == "local":
            return [t.clone() for t in tensors]
        src = [self._out(t.contiguous()) for t in tensors]
        bufs = [torch.empty_like(t) for t in src]
        to = (self.rank - offset) % self.world_size
        frm = (self.rank + offset) % self.world_size
        ops = [dist.P2POp(dist.isend, t, to) for t in src]
        ops += [dist.P2POp(dist.irecv, b, frm) for b in bufs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [self._back(b) for b in bufs]

    def gather_object(self, obj) -> list:
        """Every process's ``obj``, in rank order, on every process."""
        if self.wire == "local":
            return [obj]
        out = [None] * self.world_size
        dist.all_gather_object(out, obj)
        return out

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s ``obj`` on every process."""
        if self.wire == "local":
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src)
        return box[0]


def gather_tree(mesh: AgentMesh, tree):
    """Every agent's leaves, (m, ...) and contiguous on every process,
    from this process's (k, ...) ones: one all-gather of the rows, the
    leaves concatenated in float32 (each comes back in its own dtype)."""
    leaves, spec = pytree.tree_flatten(tree)
    k = leaves[0].shape[0]
    rows = torch.cat([l.reshape(k, -1).to(torch.float32) for l in leaves],
                     dim=1)
    table = mesh.all_gather(rows)
    parts = torch.split(table, [l[0].numel() for l in leaves], dim=1)
    return pytree.tree_unflatten(
        [p.reshape((table.shape[0],) + tuple(l.shape[1:])).to(l.dtype)
         .contiguous() for p, l in zip(parts, leaves)], spec)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantisation: one float32 scale, max|x| /
    127 (at least 1e-12), the rounded quotient clipped to [-127, 127]."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(x32.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@dataclasses.dataclass(frozen=True)
class PermuteSchedule:
    """A mixing matrix decomposed into cyclic-shift permute rounds.

    Attributes:
      num_agents:   m.
      offsets:      ring offsets o with any nonzero weight; one permute
                    round (a cyclic shift by o) is issued per entry.
      weights:      (n_offsets, m): ``weights[k, i] = M[i, (i +
                    offsets[k]) % m]``, the weight agent i applies to what
                    it receives in round k (zero where there is no edge).
      self_weights: (m,): the diagonal ``M[i, i]``.
      matrix:       (m, m) float64, the matrix itself.
    """

    num_agents: int
    offsets: tuple[int, ...]
    weights: np.ndarray
    self_weights: np.ndarray
    matrix: np.ndarray

    @property
    def rounds_per_mix(self) -> int:
        """Permute rounds per consensus combine (the wire-cost factor)."""
        return len(self.offsets)


class PermuteWeights(NamedTuple):
    """One round's weights on the *shared* offset schedule: a time-varying
    topology keeps the base schedule's offsets (one round an offset) and
    varies only the weights; a dropped edge is a zero weight.  Passed as
    the ``override`` of ``permute_mix_leaf`` / ``permute_mix_tree``.

    Attributes:
      weights:      (n_offsets, m) float32, replaces ``schedule.weights``.
      self_weights: (m,) float32, replaces ``schedule.self_weights``.
      matrix:       (m, m) float32, replaces ``schedule.matrix`` (psum).
    """

    weights: torch.Tensor
    self_weights: torch.Tensor
    matrix: torch.Tensor


def permute_schedule(mixing, tol: float = 1e-12) -> PermuteSchedule:
    """Decompose any mixing matrix into permute rounds.

    ``mixing`` is a ``MixingSpec`` or an (m, m) matrix.  Offsets whose
    weights are all within ``tol`` of 0 are dropped, so offset-structured
    graphs pay few rounds (ring 2, torus 4-5).
    """
    mat = np.asarray(getattr(mixing, "matrix", mixing), dtype=np.float64)
    m = mat.shape[0]
    idx = np.arange(m)
    offsets, weights = [], []
    for o in range(1, m):
        w = mat[idx, (idx + o) % m]
        if np.max(np.abs(w)) > tol:
            offsets.append(o)
            weights.append(w)
    return PermuteSchedule(
        num_agents=m,
        offsets=tuple(offsets),
        weights=(np.stack(weights) if weights else np.zeros((0, m))),
        self_weights=np.diag(mat).copy(),
        matrix=mat,
    )


def dp_noise(dp_key, leaf_index: int, slot: int, shape) -> np.ndarray:
    """The local-DP noise of ``slot``'s leaf ``leaf_index`` for the round
    ``dp_key = (seed, t)``: float32 standard normals of ``shape``."""
    seed, t = (int(v) for v in dp_key)
    rng = np.random.default_rng([seed, DP_TAG, int(leaf_index), int(slot),
                                 t])
    return rng.standard_normal(tuple(shape), dtype=np.float32)


def _outgoing_payload(x, slot: int, dp_sigma: float, dp_key,
                      leaf_index: int = 0):
    """What agent ``slot`` shares of its (1, ...) leaf: the leaf, or with
    ``dp_sigma > 0`` the leaf plus ``dp_sigma`` times its noise.

    ``dp_sigma > 0`` without a ``dp_key`` raises: a caller that wants a
    clean combine passes ``dp_sigma=0`` itself; skipping the noise
    quietly would be a privacy loss."""
    if dp_sigma > 0.0:
        if dp_key is None:
            raise ValueError("dp_sigma requires dp_key")
        noise = torch.from_numpy(
            dp_noise(dp_key, leaf_index, slot, x.shape)).to(x.device)
        return (x.to(torch.float32) + dp_sigma * noise).to(x.dtype)
    return x


def _self_weights(schedule: PermuteSchedule, override, device):
    if override is not None:
        return override.self_weights
    return torch.as_tensor(schedule.self_weights, dtype=torch.float32,
                           device=device)


def _ppermute_mix(x, mesh: AgentMesh, schedule: PermuteSchedule, i: int,
                  compress, dp_sigma, dp_key, leaf_index=0, payload=None,
                  override=None):
    """Per-offset cyclic-shift rounds: the wire-frugal realisation.

    ``payload`` (when given) replaces ``x`` as the outgoing value (the
    engine's error-feedback layer hands in the compressed payload, so the
    legacy ``compress`` quantisation is skipped for it).  The accumulator
    is seeded with the *clean* local x either way.  ``override`` (a
    ``PermuteWeights``) replaces the schedule's weights for this round.
    """
    self_w = _self_weights(schedule, override, x.device)[i]
    acc = self_w * x.to(torch.float32)
    if not schedule.offsets:
        return acc.to(x.dtype)

    payload = _outgoing_payload(x if payload is None else payload, i,
                                dp_sigma, dp_key, leaf_index)
    if compress == "int8":
        q, scale = quantize_int8(payload)
        sent = [q, scale.reshape(1)]
    else:
        sent = [payload]

    weights = (override.weights if override is not None
               else torch.as_tensor(schedule.weights, dtype=torch.float32,
                                    device=x.device))
    for k, o in enumerate(schedule.offsets):
        # agent j receives the payload of agent (j + o) mod m
        got = mesh.permute(sent, o)
        recv = (dequantize_int8(got[0], got[1][0]) if compress == "int8"
                else got[0])
        acc = acc + weights[k, i] * recv.to(torch.float32)
    return acc.to(x.dtype)


def _psum_mix(x, mesh: AgentMesh, schedule: PermuteSchedule, i: int,
              compress, dp_sigma, dp_key, leaf_index=0, payload=None,
              override=None):
    """All-reduce realisation: agent j contributes ``M[:, j] (x) sent_j``
    and every agent keeps its own row of the sum, then swaps the shared
    payload's self term for its clean value: ``mix(payload) + M_ii (x -
    payload)``, the same matrix as the permute rounds."""
    payload = _outgoing_payload(x if payload is None else payload, i,
                                dp_sigma, dp_key, leaf_index)
    if compress == "int8":
        sent = dequantize_int8(*quantize_int8(payload))
    else:
        sent = payload.to(torch.float32)

    m = schedule.num_agents
    mat = (override.matrix if override is not None
           else torch.as_tensor(schedule.matrix, dtype=torch.float32,
                                device=x.device))
    col = mat[:, i].reshape((m,) + (1,) * x.dim())
    mixed = mesh.all_reduce(col * sent[None])[i]
    self_w = _self_weights(schedule, override, x.device)[i]
    mixed = mixed + self_w * (x.to(torch.float32) - sent)
    return mixed.to(x.dtype)


def permute_mix_leaf(x: torch.Tensor, mesh: AgentMesh,
                     schedule: PermuteSchedule, compress: str | None = None,
                     dp_sigma: float = 0.0, dp_key=None,
                     impl: str = "ppermute", leaf_index: int = 0,
                     payload: torch.Tensor | None = None,
                     override: PermuteWeights | None = None) -> torch.Tensor:
    """One consensus combine of this process's (1, ...) leaf.

    ``compress="int8"`` sends int8 payloads and a scale; ``dp_sigma > 0``
    with ``dp_key = (seed, t)`` noises the outgoing payload (the local
    copy mixes clean); ``impl`` is ``"ppermute"`` (per-offset rounds) or
    ``"psum"`` (one all-reduce); ``payload`` overrides the outgoing value;
    ``override`` is the round's ``PermuteWeights``.  Needs one agent a
    process (the agent's index is the rank).
    """
    if mesh.num_agents != schedule.num_agents:
        raise ValueError(
            f"schedule built for m={schedule.num_agents} but the mesh holds "
            f"{mesh.num_agents} agents")
    if mesh.local_agents != 1:
        raise ValueError(
            f"permute rounds need one agent a process; this mesh puts "
            f"{mesh.local_agents} agents on each of its {mesh.world_size} "
            "processes (use the allgather backend, or launch one process "
            "an agent)")
    mix = _psum_mix if impl == "psum" else _ppermute_mix
    return mix(x, mesh, schedule, mesh.row0, compress, dp_sigma, dp_key,
               leaf_index, payload, override)


def permute_mix_tree(tree, mesh: AgentMesh, schedule: PermuteSchedule,
                     compress: str | None = None, dp_sigma: float = 0.0,
                     dp_key=None, impl: str = "ppermute", payload_tree=None,
                     override: PermuteWeights | None = None):
    """``permute_mix_leaf`` on every leaf, each its own payload and noise
    stream (``leaf_index`` in leaf order)."""
    leaves, spec = pytree.tree_flatten(tree)
    payloads = (pytree.tree_leaves(payload_tree) if payload_tree is not None
                else [None] * len(leaves))
    mixed = [permute_mix_leaf(leaf, mesh, schedule, compress=compress,
                              dp_sigma=dp_sigma, dp_key=dp_key, impl=impl,
                              leaf_index=k, payload=pl, override=override)
             for k, (leaf, pl) in enumerate(zip(leaves, payloads))]
    return pytree.tree_unflatten(mixed, spec)


def ring_mix_leaf(x: torch.Tensor, mesh: AgentMesh, self_weight: float,
                  compress: str | None = None, dp_sigma: float = 0.0,
                  dp_key=None, leaf_index: int = 0) -> torch.Tensor:
    """Ring special case: the schedule of ``ring_mixing(m, self_weight)``."""
    from repro_torch.core.consensus import ring_mixing
    schedule = permute_schedule(ring_mixing(mesh.num_agents,
                                            self_weight=self_weight))
    return permute_mix_leaf(x, mesh, schedule, compress=compress,
                            dp_sigma=dp_sigma, dp_key=dp_key,
                            leaf_index=leaf_index)


def ring_mix_tree(tree, mesh: AgentMesh, self_weight: float,
                  compress: str | None = None, dp_sigma: float = 0.0,
                  dp_key=None):
    leaves, spec = pytree.tree_flatten(tree)
    mixed = [ring_mix_leaf(leaf, mesh, self_weight, compress=compress,
                           dp_sigma=dp_sigma, dp_key=dp_key, leaf_index=k)
             for k, leaf in enumerate(leaves)]
    return pytree.tree_unflatten(mixed, spec)
