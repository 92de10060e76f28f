"""ppermute consensus backend: sparse topologies across processes.

Counterpart of ``repro.consensus.ppermute``.  Decomposes any mixing
matrix into per-offset cyclic-shift rounds
(``repro_torch.sharding.collectives.permute_schedule``), one process an
agent, so Erdős–Rényi, Metropolis and torus graphs run as point-to-point
exchanges: agent j receives the payload of agent (j + o) mod m in the
round of offset o and weighs it by ``M[j, (j + o) mod m]``.  Leaves are
the process's (1, ...) slice.  The per-offset accumulate is elementwise
and stays plain PyTorch (the JAX package does it in ``jnp``); no
consensus kernel runs here.

Backend options: the legacy ``compress="int8"`` wire format quantises
every outgoing payload; ``dp_sigma > 0`` noises the payload whenever
``mix`` is given a ``dp_key = (seed, t)`` (the noise drawn on the host
from numpy, see the collectives module); ``impl="psum"`` is the
all-reduce realisation of the same matrix.  The robust Byzantine rules
need all-to-all access to the payload rows, which a process here never
holds: they raise.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.byzantine import ByzantineConfig
from repro_torch.consensus.compress import CompressionConfig, Int8Compressor
from repro_torch.consensus.engine import (ConsensusEngine, MeshBackendMixin,
                                          check_mesh)
from repro_torch.consensus.ledger import StreamRecord
from repro_torch.core.consensus import MixingSpec
from repro_torch.sharding.collectives import (PermuteSchedule,
                                              permute_mix_tree,
                                              permute_schedule)

__all__ = ["PermuteEngine"]


class PermuteEngine(MeshBackendMixin, ConsensusEngine):

    name = "ppermute"

    def __init__(self, mixing: MixingSpec | PermuteSchedule | np.ndarray,
                 device: torch.device | str, mesh=None,
                 compress: str | None = None, dp_sigma: float = 0.0,
                 impl: str = "ppermute",
                 compression: CompressionConfig | None = None,
                 communication_interval: int = 1,
                 byzantine: ByzantineConfig | None = None,
                 attack_seed: int = 0):
        self.schedule = (mixing if isinstance(mixing, PermuteSchedule)
                         else permute_schedule(mixing))
        self.matrix = torch.as_tensor(self.schedule.matrix,
                                      dtype=torch.float32, device=device)
        self.mesh = check_mesh(mesh, self.schedule.num_agents, device)
        if self.mesh.local_agents != 1:
            m = self.mesh.num_agents
            raise ValueError(
                f"the ppermute backend runs one agent a process, but the "
                f"mesh puts {self.mesh.local_agents} of its {m} agents on "
                f"each of {self.mesh.world_size} processes: launch {m} "
                "processes, or use the allgather backend")
        self.compress = compress
        self.dp_sigma = float(dp_sigma)
        if impl not in ("ppermute", "psum"):
            raise ValueError(f"unknown ppermute impl {impl!r}")
        self.impl = impl
        self._configure_wire(compression, communication_interval, byzantine,
                             attack_seed)
        if self.compression.active and compress is not None:
            raise ValueError(
                "pass either the legacy compress= wire format or a "
                "CompressionConfig, not both")
        if self.byzantine.combine != "weighted":
            raise NotImplementedError(
                f"combine rule {self.byzantine.combine!r} needs all-to-all "
                f"access to the payload rows, but the ppermute backend "
                f"only ever holds the local agent's slice; robust rules "
                f"need the dense, cuda or allgather backend")

    @property
    def rounds_per_mix(self) -> int:
        return self.schedule.rounds_per_mix

    def mix(self, tree, *, matrix=None, dp_key=None):
        """The combine of this process's (1, ...) leaves; ``matrix`` is a
        ``PermuteWeights`` override (the round's weights on the same
        offsets); ``dp_key = (seed, t)`` noises the payload when the
        engine has ``dp_sigma > 0``."""
        return permute_mix_tree(
            tree, self.mesh, self.schedule, compress=self.compress,
            dp_sigma=self.dp_sigma if dp_key is not None else 0.0,
            dp_key=dp_key, impl=self.impl, override=matrix)

    def _wire_compressor(self):
        if not self.compression.active and self.compress == "int8":
            return Int8Compressor()
        return self.compressor

    def _ledger_note(self, stream: str, tree) -> None:
        """Per-link wire template: one payload a leaf a permute round.

        The unicast model ``bytes_on_wire`` prices here, ``rounds_per_mix``
        rounds each shipping every leaf on its own, which exceeds the
        matrix backends' broadcast model by the offset fan-out.  A
        dropped link of a time-varying topology zeroes a weight, not a
        payload: the round still ships, and is counted."""
        led = self.ledger
        if led is None:
            return
        compressor = self._wire_compressor()
        leaves = pytree.tree_leaves(tree)
        sizes = [int(l.numel()) // (int(l.shape[0]) if l.dim() else 1)
                 for l in leaves]
        rounds = self.rounds_per_mix
        led.note(stream, StreamRecord(
            op=f"{self.name}/{self.impl}", entries=sum(sizes),
            wire_bytes=rounds * sum(compressor.bytes_on_wire(s)
                                    for s in sizes),
            full_bytes=rounds * 4 * sum(sizes),
            collectives=rounds * len(leaves)))

    def _encode_leaf(self, leaf: torch.Tensor) -> torch.Tensor:
        """The compressor's decoded value of one (k, ...) leaf, each
        agent's leaf one payload."""
        rows = leaf.reshape(leaf.shape[0], -1)
        return self.compressor.encode_decode(rows).reshape(leaf.shape)

    def mix_ef(self, tree, ef=None, t=None, *, matrix=None, dp_key=None,
               stream: str = "x"):
        """Per-neighbour wire path: every outgoing *leaf* is compressed on
        its own (the matrix backends compress one concatenated buffer an
        agent, so the two agree within a tolerance, not bit for bit; the
        ``none`` compressor is exact on both).  The wire state is the
        same ``{"e", "ref"}`` innovation scheme: the agent ships ``C(x -
        ref)`` and peers reconstruct ``ref + C(...)``, the payload handed
        to the permute rounds, whose accumulator starts from the clean
        local value.  As on the other backends a step between rounds
        sends nothing and keeps the wire state."""
        self._ledger_note(stream, tree)
        if self._skips(t):
            return tree, ef
        if matrix is None:
            matrix = self.topology_matrix(t, tree)
        sent = self._attack_local(tree, t, stream)
        dp = self.dp_sigma if dp_key is not None else 0.0
        if not self.compression.active:
            return self.mix(sent, matrix=matrix, dp_key=dp_key), ef
        v = pytree.tree_map(lambda l: l.to(torch.float32), sent)
        if ef is not None:
            v = pytree.tree_map(lambda a, r: a - r, v, ef["ref"])
        warm, _ = self.wire_schedule(self._require_t(t))
        c = v if warm else pytree.tree_map(self._encode_leaf, v)
        if ef is None:
            ef_new, recon = None, c
        else:
            recon = pytree.tree_map(lambda r, cc: r + cc, ef["ref"], c)
            ef_new = {"e": pytree.tree_map(lambda a, b: a - b, v, c),
                      "ref": recon}
        payload = pytree.tree_map(lambda cc, l: cc.to(l.dtype), recon, tree)
        mixed = permute_mix_tree(
            tree, self.mesh, self.schedule, compress=None, dp_sigma=dp,
            dp_key=dp_key, impl=self.impl, payload_tree=payload,
            override=matrix)
        return self._damp(mixed, tree), ef_new

    def bytes_on_wire(self, tree) -> int:
        """Per-leaf payloads times permute rounds (what each link carries);
        the legacy ``compress="int8"`` format is priced with the int8
        compressor when no ``CompressionConfig`` is active."""
        compressor = self._wire_compressor()
        per_leaf = sum(compressor.bytes_on_wire(int(l.numel()))
                       for l in pytree.tree_leaves(tree))
        return self.rounds_per_mix * per_leaf
