"""Time-varying topologies: mixing matrices as a per-step process.

``TopologyProcessConfig`` (carried by ``SolverConfig.topology_process``)
declares the process; ``process`` realizes ``(T, m, m)`` matrix streams
with per-step active-edge masks (numpy, bit for bit the JAX package's);
``runtime`` puts the round's matrix on the device for the engines.
"""
from repro_torch.topology.process import (
    TopologyProcessConfig,
    TopologyStream,
    adjacency_of,
    available_topology_processes,
    make_topology_process,
    masked_mixing,
    realize_stream,
    register_topology_process,
    stream_wire_bytes,
)
from repro_torch.topology.runtime import (
    AdaptiveTopology,
    GroupStreamTopology,
    RoundTopology,
    StreamTopology,
    adaptive_mixing,
    agents_matrix,
    attach_topology,
    stream_of,
)

__all__ = [
    "AdaptiveTopology",
    "GroupStreamTopology",
    "RoundTopology",
    "StreamTopology",
    "TopologyProcessConfig",
    "TopologyStream",
    "adaptive_mixing",
    "adjacency_of",
    "agents_matrix",
    "attach_topology",
    "available_topology_processes",
    "make_topology_process",
    "masked_mixing",
    "realize_stream",
    "register_topology_process",
    "stream_of",
    "stream_wire_bytes",
]
