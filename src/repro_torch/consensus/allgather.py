"""all-gather consensus backend: the dense combine across processes.

Counterpart of ``repro.consensus.allgather``.  Each process holds its k
agents' rows (an ``AgentMesh``); a combine gathers every agent's payload
into one (m, D) table, one all-gather a stream (the leaves of a tree
concatenated per agent), and mixes the process's own rows of the full
(m, m) matrix against it:

    mixed[r] = sum_j M[row0 + r, j] * table[j]          (eq. 6 / eq. 10)

On the card the mix and the fused Step-1/3 pair run the row-block
consensus kernels (``consensus_mix_kernel`` / ``consensus_step_kernel``
with ``row0``): M whole in shared memory, the gathered x and u tables,
and p, p_prev and the outputs as the process's (k, D) rows, so neither p
crosses the wire nor is any other process's row computed.  On the CPU
the wrappers run their plain versions.

Trade-off against ``ppermute``: the wire carries one payload an agent a
round (the broadcast model ``cumulative_wire_bytes`` prices, so measured
bytes equal priced ones), and the full matrix makes any round matrix of
a topology stream work (its round buffer) and lets the robust Byzantine
rules run over the gathered table exactly as on the dense backend.  The wire path (the base
class's ``mix_ef``: one concatenated buffer an agent, compressed row by
row) is the dense backend's, with the self weights sliced to the local
rows.  Local-DP noise is a ``ppermute`` wire option and does not exist
here.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.byzantine import ByzantineConfig, robust_combine
from repro_torch.consensus.compress import CompressionConfig
from repro_torch.consensus.engine import (ConsensusEngine, MeshBackendMixin,
                                          as_matrix, check_mesh)
from repro_torch.core.consensus import MixingSpec
from repro_torch.kernels.consensus_step.ops import (consensus_mix_kernel,
                                                    consensus_step_kernel,
                                                    flatten_agents)
from repro_torch.sharding.collectives import gather_tree

__all__ = ["AllGatherEngine"]


class AllGatherEngine(MeshBackendMixin, ConsensusEngine):

    name = "allgather"

    def __init__(self, mixing: MixingSpec | np.ndarray | torch.Tensor,
                 device: torch.device | str, mesh=None,
                 compression: CompressionConfig | None = None,
                 communication_interval: int = 1,
                 byzantine: ByzantineConfig | None = None,
                 attack_seed: int = 0):
        self.matrix = as_matrix(mixing, device).contiguous()
        self.mesh = check_mesh(mesh, int(self.matrix.shape[0]), device)
        self._configure_wire(compression, communication_interval, byzantine,
                             attack_seed)

    def _matrix(self, matrix) -> torch.Tensor:
        return self.matrix if matrix is None else matrix.contiguous()

    def mix(self, tree, *, matrix=None):
        X, unravel = flatten_agents(tree)
        row0, k = self.local_rows
        return unravel(consensus_mix_kernel(
            self._matrix(matrix), self.mesh.all_gather(X), row0=row0,
            rows=k))

    def _combine(self, tree, *, matrix=None):
        """Weighted mix, or a robust rule over the gathered table (every
        process computes the full rule and keeps its rows)."""
        rule = self.byzantine.combine
        if rule == "weighted":
            return self.mix(tree, matrix=matrix)
        full = robust_combine(self._matrix(matrix),
                              gather_tree(self.mesh, tree), rule,
                              self.byzantine.resolve_trim())
        return pytree.tree_map(self._local_slots, full)

    def step1_step3(self, x, u, p, p_prev, alpha, *, t=None, ef=None,
                    matrix=None):
        """The fused pair on the full-precision path: x and u gathered
        (one all-gather each), one row-block ``consensus_step`` launch
        with this process's p and p_prev; the wire path composes the
        base class's two ``mix_ef`` calls."""
        if ef is not None or self.wire_active:
            return super().step1_step3(x, u, p, p_prev, alpha, t=t, ef=ef,
                                       matrix=matrix)
        self._ledger_note("x", x)
        self._ledger_note("u", u)
        if matrix is None:
            matrix = self.topology_matrix(t, x)
        X, unravel_x = flatten_agents(x)
        U, unravel_u = flatten_agents(u)
        P, _ = flatten_agents(p)
        PP, _ = flatten_agents(p_prev)
        dtype = X.dtype
        for other in (U, P, PP):
            dtype = torch.promote_types(dtype, other.dtype)
        X, U, P, PP = (a.to(dtype) for a in (X, U, P, PP))
        X_out, U_out = consensus_step_kernel(
            self._matrix(matrix), self.mesh.all_gather(X),
            self.mesh.all_gather(U), P, PP, alpha=float(alpha),
            row0=self.local_rows[0])
        return unravel_x(X_out), unravel_u(U_out)
