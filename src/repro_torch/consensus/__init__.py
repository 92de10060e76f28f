"""Consensus engine: the ``dense`` and ``cuda`` backends and the mesh
backends ``allgather`` and ``ppermute`` behind one API, the compressed
wire and the measured-bytes ledger.

Backend classes are exported lazily, as the JAX package's are: importing
this package does not load the mesh backends or the collectives; they
load when asked for (``make_engine`` or an attribute below).
"""
from repro_torch.consensus.compress import (
    COMPRESSORS,
    CompressionConfig,
    Compressor,
    cumulative_wire_bytes,
    init_ef,
    make_compressor,
)
from repro_torch.consensus.engine import (
    BACKENDS,
    ConsensusEngine,
    MeshBackendMixin,
    consensus_descent_and_track,
    make_engine,
    register_backend,
)
from repro_torch.consensus.ledger import (
    CommsLedger,
    StreamRecord,
    attach_ledger,
    time_round_us,
)

__all__ = [
    "AllGatherEngine",
    "BACKENDS",
    "COMPRESSORS",
    "CommsLedger",
    "CompressionConfig",
    "Compressor",
    "ConsensusEngine",
    "CudaEngine",
    "DenseEngine",
    "MeshBackendMixin",
    "PermuteEngine",
    "StreamRecord",
    "attach_ledger",
    "consensus_descent_and_track",
    "cumulative_wire_bytes",
    "init_ef",
    "make_compressor",
    "make_engine",
    "register_backend",
    "time_round_us",
]

_LAZY_BACKENDS = {
    "AllGatherEngine": "repro_torch.consensus.allgather",
    "CudaEngine": "repro_torch.consensus.cuda",
    "DenseEngine": "repro_torch.consensus.dense",
    "PermuteEngine": "repro_torch.consensus.ppermute",
}


def __getattr__(name):
    module = _LAZY_BACKENDS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(module), name)
