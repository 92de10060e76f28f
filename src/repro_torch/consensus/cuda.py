"""CUDA consensus backend: the fused consensus+tracking kernel on Hopper.

Counterpart of ``repro.consensus.pallas``.  Wraps
``repro_torch/kernels/consensus_step`` behind the ``ConsensusEngine``
API: both Step-1/3 products run in one kernel launch with the (m, m)
mixing matrix in shared memory and the flattened parameters streaming
through once.  The matrix is converted to a float32 tensor on the device
once, here.  alpha is a runtime kernel argument, so any step size runs
the fused kernel.  On CPU tensors the wrappers run the plain PyTorch
versions of the kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.consensus.engine import ConsensusEngine
from repro_torch.core.consensus import MixingSpec
from repro_torch.kernels.consensus_step.ops import (consensus_mix,
                                                    consensus_step)

__all__ = ["CudaEngine"]


class CudaEngine(ConsensusEngine):

    name = "cuda"

    def __init__(self, mixing: MixingSpec | np.ndarray,
                 device: torch.device | str):
        mat = mixing.matrix if isinstance(mixing, MixingSpec) else mixing
        self.matrix = torch.as_tensor(np.asarray(mat), dtype=torch.float32,
                                      device=device).contiguous()

    def mix(self, tree):
        return consensus_mix(self.matrix, tree)

    def step1_step3(self, x, u, p, p_prev, alpha: float):
        return consensus_step(self.matrix, x, u, p, p_prev, alpha=float(alpha))
