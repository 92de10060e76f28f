"""Consensus engine: ``dense`` and ``cuda`` backends behind one API, the
compressed wire and the measured-bytes ledger."""
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
    "BACKENDS",
    "COMPRESSORS",
    "CommsLedger",
    "CompressionConfig",
    "Compressor",
    "ConsensusEngine",
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
