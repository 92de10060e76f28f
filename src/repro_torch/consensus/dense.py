"""Dense consensus backend: the (m, m) matmul reference.

Counterpart of ``repro.consensus.dense``.  Works for any topology; leaves
carry a leading agent dim of size m.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.byzantine import ByzantineConfig
from repro_torch.consensus.compress import CompressionConfig
from repro_torch.consensus.engine import ConsensusEngine
from repro_torch.core.consensus import MixingSpec, mix_pytree

__all__ = ["DenseEngine"]


class DenseEngine(ConsensusEngine):

    name = "dense"

    def __init__(self, mixing: MixingSpec | np.ndarray,
                 device: torch.device | str,
                 compression: CompressionConfig | None = None,
                 communication_interval: int = 1,
                 byzantine: ByzantineConfig | None = None,
                 attack_seed: int = 0):
        mat = mixing.matrix if isinstance(mixing, MixingSpec) else mixing
        self.matrix = torch.as_tensor(np.asarray(mat), dtype=torch.float32,
                                      device=device)
        self._configure_wire(compression, communication_interval, byzantine,
                             attack_seed)

    def mix(self, tree, *, matrix=None):
        return mix_pytree(self.matrix if matrix is None else matrix, tree)
