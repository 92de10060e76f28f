"""Consensus over a process group: the agent mesh and permute schedules."""
from repro_torch.sharding.collectives import (
    AgentMesh,
    PermuteSchedule,
    PermuteWeights,
    dequantize_int8,
    permute_mix_leaf,
    permute_mix_tree,
    permute_schedule,
    quantize_int8,
    ring_mix_leaf,
    ring_mix_tree,
)

__all__ = [
    "AgentMesh",
    "PermuteSchedule",
    "PermuteWeights",
    "dequantize_int8",
    "permute_mix_leaf",
    "permute_mix_tree",
    "permute_schedule",
    "quantize_int8",
    "ring_mix_leaf",
    "ring_mix_tree",
]
