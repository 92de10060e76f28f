"""Dense consensus backend: the (m, m) matmul reference.

Counterpart of ``repro.consensus.dense``.  Works for any topology; leaves
carry a leading agent dim of size m.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.byzantine import ByzantineConfig
from repro_torch.consensus.compress import CompressionConfig
from repro_torch.consensus.engine import ConsensusEngine, as_matrix
from repro_torch.core.consensus import MixingSpec, mix_pytree, pad_mixing

__all__ = ["DenseEngine"]


class DenseEngine(ConsensusEngine):

    name = "dense"

    def __init__(self, mixing: MixingSpec | np.ndarray | torch.Tensor,
                 device: torch.device | str,
                 compression: CompressionConfig | None = None,
                 communication_interval: int = 1,
                 byzantine: ByzantineConfig | None = None,
                 attack_seed: int = 0):
        self.matrix = as_matrix(mixing, device)
        self._configure_wire(compression, communication_interval, byzantine,
                             attack_seed)

    @classmethod
    def padded(cls, mixing: MixingSpec | np.ndarray, pad_to: int,
               device: torch.device | str, **wire_opts) -> "DenseEngine":
        """A dense engine over the ghost-padded (pad_to, pad_to) matrix
        (``repro_torch.core.consensus.pad_mixing``)."""
        return cls(pad_mixing(mixing, pad_to), device, **wire_opts)

    def mix(self, tree, *, matrix=None):
        return mix_pytree(self.matrix if matrix is None else matrix, tree)
