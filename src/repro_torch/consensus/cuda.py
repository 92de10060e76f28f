"""CUDA consensus backend: the fused consensus+tracking kernel on Hopper.

Counterpart of ``repro.consensus.pallas``.  Wraps
``repro_torch/kernels/consensus_step`` behind the ``ConsensusEngine``
API: on the full-precision path both Step-1/3 products run in one
``consensus_step`` launch with the (m, m) mixing matrix in shared memory
and the flattened parameters streaming through once; a time-varying
topology feeds it the round's matrix.  On the wire path (compression, a
communication interval or a Byzantine config) ``step1_step3`` composes
the base class's two ``mix_ef`` calls, as the reference's
``PallasEngine`` does: each one ``consensus_mix`` launch of the
(compressed, attacked) payload under the ``weighted`` rule; a robust
rule launches no consensus kernel (its combine is plain PyTorch, as in
the reference).  The matrix is converted to a float32 tensor on the
device once, here; a per-call matrix must be a contiguous float32
tensor on the same device (the kernel wrappers check).  alpha is a
runtime kernel argument.  On CPU tensors the wrappers run the plain
PyTorch versions of the kernels.

Sweep groups.  Under ``torch.func.vmap`` over a group's experiments the
kernels are reached through the wrappers' custom operators, whose vmap
rules launch the batched kernels: one launch a step for the whole
group, the matrix shared (stride 0) or one per experiment (an adaptive
topology's).  A tensor alpha (one per experiment) takes the fused step
too, alpha read per experiment from the device; the reference's
``PallasEngine`` composes two ``consensus_mix`` launches for a traced
alpha instead (``src/repro/consensus/pallas.py:63-71``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.byzantine import ByzantineConfig
from repro_torch.consensus.compress import CompressionConfig
from repro_torch.consensus.engine import ConsensusEngine, as_matrix
from repro_torch.core.consensus import MixingSpec
from repro_torch.kernels.consensus_step.ops import (consensus_mix,
                                                    consensus_step)

__all__ = ["CudaEngine"]


class CudaEngine(ConsensusEngine):

    name = "cuda"

    def __init__(self, mixing: MixingSpec | np.ndarray | torch.Tensor,
                 device: torch.device | str,
                 compression: CompressionConfig | None = None,
                 communication_interval: int = 1,
                 byzantine: ByzantineConfig | None = None,
                 attack_seed: int = 0):
        self.matrix = as_matrix(mixing, device).contiguous()
        self._configure_wire(compression, communication_interval, byzantine,
                             attack_seed)

    def mix(self, tree, *, matrix=None):
        return consensus_mix(self.matrix if matrix is None else matrix, tree)

    def step1_step3(self, x, u, p, p_prev, alpha, *, t=None, ef=None,
                    matrix=None):
        if ef is not None or self.wire_active:
            return super().step1_step3(x, u, p, p_prev, alpha, t=t, ef=ef,
                                       matrix=matrix)
        self._ledger_note("x", x)
        self._ledger_note("u", u)
        if matrix is None:
            matrix = self.topology_matrix(t, x)
        return consensus_step(self.matrix if matrix is None else matrix,
                              x, u, p, p_prev,
                              alpha=(alpha if isinstance(alpha, torch.Tensor)
                                     else float(alpha)))
