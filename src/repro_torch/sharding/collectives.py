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
switches between them on its own.  A tree's plain rounds (no int8, no
noise, no substituted payload) ship consecutive leaves of one dtype
laid end to end, up to ``PERMUTE_BUCKET_BYTES`` a round: the same bytes
and each element's same sums in far fewer rounds for a tree of hundreds
of leaves (an LM backbone), where each round costs a host round trip on
the staged wire.

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

Groups.  An ``AgentMesh`` runs on the default group, or on an explicit
subgroup (``group``, with ``group_ranks`` the global rank of each of its
ranks: a permute's peers are global ranks).  The pods layout
(``PodsMesh``) gives each process two: its *ring*, the ranks with its
data index across the pods (one agent each: the permutes and the
metrics), and its *pod*, the k ranks of its agent (the gathers,
reduce-scatters and all-reduces of the agent's shards).  With the int8
wire or local-DP noise a sharded leaf's mix needs the whole leaf's
scale and noise: ``PodShards`` tells the permute rounds each leaf's
whole shape and split (the scale is the pod's all-reduced max, the noise
is drawn at the whole shape and sliced).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.sharding.partition import leaf_paths

__all__ = [
    "AgentMesh", "DP_TAG", "PERMUTE_BUCKET_BYTES", "PermuteSchedule",
    "PermuteWeights", "PodShards", "PodsMesh",
    "dequantize_int8", "dp_noise", "gather_tree",
    "permute_mix_leaf", "permute_mix_tree", "permute_schedule",
    "quantize_int8", "ring_mix_leaf", "ring_mix_tree",
]

# entropy tag of the local-DP noise generators (ASCII "dpno"); see the
# Byzantine layer's tags for why a tag leads the stream's words
DP_TAG = 0x64706E6F

# the most bytes a plain permute round of a tree ships (a larger leaf
# ships alone)
PERMUTE_BUCKET_BYTES = 64 << 20

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
      group:      the process group of the collectives (None: the default
                  group); ``world_size`` and ``rank`` are within it.
      group_ranks: the global rank of each of its ranks (None: the
                  identity).
    """

    num_agents: int
    world_size: int
    rank: int
    device: torch.device
    wire: str
    group: object = None
    group_ranks: tuple[int, ...] | None = None

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

    def global_rank(self, rank: int) -> int:
        """The global rank of this mesh's rank ``rank``."""
        return rank if self.group_ranks is None else self.group_ranks[rank]

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
        _ALL_GATHER(out, src, group=self.group)
        return self._back(out)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (``op="max"``: the max) over processes of ``x`` (a new
        tensor)."""
        if self.wire == "local":
            return x.clone()
        buf = self._out(x.contiguous().clone())
        dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group)
        return self._back(buf)

    def reduce_scatter_mean(self, x: torch.Tensor) -> torch.Tensor:
        """Row ``rank`` of the mean over processes of ``x`` (world, ...),
        summed in float32 and returned in ``x``'s dtype: an all-reduce of
        the whole stack, of which the row is kept, so each process moves
        ``world`` rows of float32."""
        if self.wire == "local":
            return x[0].clone()
        buf = x.to("cpu" if self.wire == "gloo-staged" else x.device,
                   torch.float32, copy=True).contiguous()
        dist.all_reduce(buf, group=self.group)
        return buf[self.rank].div_(self.world_size).to(self.device, x.dtype)

    def permute(self, tensors: list[torch.Tensor], offset: int
                ) -> list[torch.Tensor]:
        """One cyclic-shift round: rank j receives rank (j + offset) mod
        world's ``tensors`` (one ``batch_isend_irecv`` of all of them)."""
        if self.wire == "local":
            return [t.clone() for t in tensors]
        src = [self._out(t.contiguous()) for t in tensors]
        bufs = [torch.empty_like(t) for t in src]
        to = self.global_rank((self.rank - offset) % self.world_size)
        frm = self.global_rank((self.rank + offset) % self.world_size)
        ops = [dist.P2POp(dist.isend, t, to, self.group) for t in src]
        ops += [dist.P2POp(dist.irecv, b, frm, self.group) for b in bufs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [self._back(b) for b in bufs]

    def gather_object(self, obj) -> list:
        """Every process's ``obj``, in rank order, on every process."""
        if self.wire == "local":
            return [obj]
        out = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s ``obj`` on every process."""
        if self.wire == "local":
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self.global_rank(src),
                                   group=self.group)
        return box[0]


@dataclasses.dataclass(frozen=True, eq=False)
class PodsMesh:
    """Where this process sits in the pods layout: m agents, each a pod of
    k processes that shards the agent's state over its ``data`` axis.

    Attributes:
      ring: this process's ring, an ``AgentMesh`` of the m ranks with its
            data index (one agent a process; its rank is the agent).
      pod:  this process's pod, an ``AgentMesh`` of its agent's k ranks
            (its rank is the data index).
    """

    ring: AgentMesh
    pod: AgentMesh

    @property
    def agent(self) -> int:
        return self.ring.rank

    @property
    def pod_size(self) -> int:
        return self.pod.world_size

    @property
    def data_index(self) -> int:
        return self.pod.rank

    @property
    def device(self) -> torch.device:
        return self.ring.device

    @property
    def wire(self) -> str:
        return self.ring.wire


class PodShards(NamedTuple):
    """How a backbone tree's leaves split over a pod, by key path
    (``sharding.partition.leaf_paths``): ``dims[path]`` is the dim of the
    leaf's (1, ...) form that the pod shards (None: whole on every rank),
    ``shapes[path]`` its whole (1, ...) shape."""

    pod: AgentMesh
    dims: dict
    shapes: dict

    def leaves(self, tree) -> list:
        """Per leaf of ``tree``: ``(pod, whole shape, dim)``, or None for
        a leaf kept whole."""
        return [None if self.dims[p] is None
                else (self.pod, self.shapes[p], self.dims[p])
                for p in leaf_paths(tree)]


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


def quantize_int8(x: torch.Tensor, pod: AgentMesh | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantisation: one float32 scale, max|x| /
    127 (at least 1e-12), the rounded quotient clipped to [-127, 127].
    ``x`` a shard of a leaf split over ``pod``: the whole leaf's max."""
    x32 = x.to(torch.float32)
    amax = x32.abs().max()
    if pod is not None:
        amax = pod.all_reduce(amax.reshape(1), op="max")[0]
    scale = torch.clamp(amax / 127.0, min=1e-12)
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
                      leaf_index: int = 0, shard=None):
    """What agent ``slot`` shares of its (1, ...) leaf: the leaf, or with
    ``dp_sigma > 0`` the leaf plus ``dp_sigma`` times its noise.  ``x`` a
    shard (``shard = (pod, whole shape, dim)``): the whole leaf's noise,
    sliced to the shard.

    ``dp_sigma > 0`` without a ``dp_key`` raises: a caller that wants a
    clean combine passes ``dp_sigma=0`` itself; skipping the noise
    quietly would be a privacy loss."""
    if dp_sigma > 0.0:
        if dp_key is None:
            raise ValueError("dp_sigma requires dp_key")
        noise = torch.from_numpy(dp_noise(
            dp_key, leaf_index, slot, x.shape if shard is None
            else shard[1])).to(x.device)
        if shard is not None:
            pod, _, dim = shard
            size = x.shape[dim]
            noise = noise.narrow(dim, pod.rank * size, size)
        return (x.to(torch.float32) + dp_sigma * noise).to(x.dtype)
    return x


def _self_weights(schedule: PermuteSchedule, override, device):
    if override is not None:
        return override.self_weights
    return torch.as_tensor(schedule.self_weights, dtype=torch.float32,
                           device=device)


def _ppermute_mix(x, mesh: AgentMesh, schedule: PermuteSchedule, i: int,
                  compress, dp_sigma, dp_key, leaf_index=0, payload=None,
                  override=None, shard=None):
    """Per-offset cyclic-shift rounds: the wire-frugal realisation.

    ``payload`` (when given) replaces ``x`` as the outgoing value (the
    engine's error-feedback layer hands in the compressed payload, so the
    legacy ``compress`` quantisation is skipped for it).  The accumulator
    is seeded with the *clean* local x either way.  ``override`` (a
    ``PermuteWeights``) replaces the schedule's weights for this round.
    ``shard = (pod, whole shape, dim)`` marks ``x`` as a shard of a leaf
    split over a pod (the scale and the noise are the whole leaf's).
    """
    self_w = _self_weights(schedule, override, x.device)[i]
    acc = self_w * x.to(torch.float32)
    if not schedule.offsets:
        return acc.to(x.dtype)

    payload = _outgoing_payload(x if payload is None else payload, i,
                                dp_sigma, dp_key, leaf_index, shard)
    if compress == "int8":
        q, scale = quantize_int8(payload, None if shard is None
                                 else shard[0])
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
              override=None, shard=None):
    """All-reduce realisation: agent j contributes ``M[:, j] (x) sent_j``
    and every agent keeps its own row of the sum, then swaps the shared
    payload's self term for its clean value: ``mix(payload) + M_ii (x -
    payload)``, the same matrix as the permute rounds."""
    payload = _outgoing_payload(x if payload is None else payload, i,
                                dp_sigma, dp_key, leaf_index, shard)
    if compress == "int8":
        sent = dequantize_int8(*quantize_int8(
            payload, None if shard is None else shard[0]))
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
                     override: PermuteWeights | None = None,
                     shard=None) -> torch.Tensor:
    """One consensus combine of this process's (1, ...) leaf.

    ``compress="int8"`` sends int8 payloads and a scale; ``dp_sigma > 0``
    with ``dp_key = (seed, t)`` noises the outgoing payload (the local
    copy mixes clean); ``impl`` is ``"ppermute"`` (per-offset rounds) or
    ``"psum"`` (one all-reduce); ``payload`` overrides the outgoing value;
    ``override`` is the round's ``PermuteWeights``; ``shard = (pod, whole
    shape, dim)`` marks ``x`` as a pod's shard (``PodShards.leaf``).
    Needs one agent a process (the agent's index is the rank).
    """
    _check_one_agent(mesh, schedule)
    mix = _psum_mix if impl == "psum" else _ppermute_mix
    return mix(x, mesh, schedule, mesh.row0, compress, dp_sigma, dp_key,
               leaf_index, payload, override, shard)


def _check_one_agent(mesh: AgentMesh, schedule: PermuteSchedule) -> None:
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


def _buckets(leaves) -> list[list[int]]:
    """Runs of consecutive leaf indices of one dtype, each run at most
    ``PERMUTE_BUCKET_BYTES`` (or one larger leaf)."""
    runs, size = [], 0
    for i, leaf in enumerate(leaves):
        nbytes = leaf.numel() * leaf.element_size()
        if (runs and leaf.dtype == leaves[runs[-1][0]].dtype
                and size + nbytes <= PERMUTE_BUCKET_BYTES):
            runs[-1].append(i)
            size += nbytes
        else:
            runs.append([i])
            size = nbytes
    return runs


def _ppermute_mix_bucket(xs, mesh: AgentMesh, schedule: PermuteSchedule,
                         override=None):
    """``_ppermute_mix`` of several plain leaves in one round an offset:
    their values laid end to end, the sums taken element by element."""
    flat = torch.cat([x.reshape(-1) for x in xs])
    mixed = _ppermute_mix(flat, mesh, schedule, mesh.row0, None, 0.0, None,
                          override=override)
    parts = torch.split(mixed, [x.numel() for x in xs])
    return [part.reshape(x.shape) for part, x in zip(parts, xs)]


def permute_mix_tree(tree, mesh: AgentMesh, schedule: PermuteSchedule,
                     compress: str | None = None, dp_sigma: float = 0.0,
                     dp_key=None, impl: str = "ppermute", payload_tree=None,
                     override: PermuteWeights | None = None,
                     shards: PodShards | None = None):
    """``permute_mix_leaf`` on every leaf, each its own payload and noise
    stream (``leaf_index`` in leaf order).  Plain permute rounds (no
    int8, no noise, no substituted payload) ship the leaves in buckets
    (``PERMUTE_BUCKET_BYTES``), with the same result.  ``shards``: the
    leaves are shards of a pod's agent (the pods layout); mixing is
    elementwise, so each shard mixes with its peers' like shards."""
    leaves, spec = pytree.tree_flatten(tree)
    if (impl == "ppermute" and compress is None and dp_sigma == 0.0
            and payload_tree is None):
        _check_one_agent(mesh, schedule)
        mixed = [None] * len(leaves)
        for run in _buckets(leaves):
            outs = _ppermute_mix_bucket([leaves[j] for j in run], mesh,
                                        schedule, override)
            for j, out in zip(run, outs):
                mixed[j] = out
        return pytree.tree_unflatten(mixed, spec)
    payloads = (pytree.tree_leaves(payload_tree) if payload_tree is not None
                else [None] * len(leaves))
    split = (shards.leaves(tree) if shards is not None
             else [None] * len(leaves))
    mixed = [permute_mix_leaf(leaf, mesh, schedule, compress=compress,
                              dp_sigma=dp_sigma, dp_key=dp_key, impl=impl,
                              leaf_index=k, payload=pl, override=override,
                              shard=sh)
             for k, (leaf, pl, sh) in enumerate(zip(leaves, payloads,
                                                    split))]
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
