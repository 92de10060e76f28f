"""Dense consensus backend: the (m, m) matmul reference.

Counterpart of ``repro.consensus.dense``.  Works for any topology; leaves
carry a leading agent dim of size m.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.consensus.engine import ConsensusEngine
from repro_torch.core.consensus import MixingSpec, mix_pytree

__all__ = ["DenseEngine"]


class DenseEngine(ConsensusEngine):

    name = "dense"

    def __init__(self, mixing: MixingSpec | np.ndarray,
                 device: torch.device | str):
        mat = mixing.matrix if isinstance(mixing, MixingSpec) else mixing
        self.matrix = torch.as_tensor(np.asarray(mat), dtype=torch.float32,
                                      device=device)

    def mix(self, tree):
        return mix_pytree(self.matrix, tree)
