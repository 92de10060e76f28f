"""Consensus engine: ``dense`` and ``cuda`` backends behind one API."""
from repro_torch.consensus.engine import (
    BACKENDS,
    ConsensusEngine,
    consensus_descent_and_track,
    make_engine,
    register_backend,
)
from repro_torch.consensus.ledger import time_round_us

__all__ = [
    "BACKENDS",
    "ConsensusEngine",
    "consensus_descent_and_track",
    "make_engine",
    "register_backend",
    "time_round_us",
]
