"""CommsLedger: measured bytes on the wire, and round latency.

Counterpart of ``repro.consensus.ledger``.  An engine with
``engine.ledger`` set records, each time a combine is called, the
per-round wire template of every stream it ships (``x`` and ``u`` for
the tracking algorithms, ``x`` for D-SGD); the host then commits the
engine's schedule:

    ledger = attach_ledger(engine, CommsLedger())
    ... step the solver ...                    # records stream templates
    ledger.commit_steps(num_steps)             # applies warm-up/interval
    ledger.measured_wire_bytes                 # per-agent bytes shipped

A captured CUDA graph calls the combine once, at capture, and never at
replay, so the templates come from the capture; the schedule (warm-up
for ``t < compress_after``, silence when ``t % interval != 0``) is a
function of the step index alone, which ``commit_steps`` replays on the
host.  A second call overwrites the same stream key, so warm-up steps,
re-captures and eager steps never count twice.  The matrix backends
ship one concatenated per-agent buffer a stream a round, the model
``cumulative_wire_bytes`` prices, so measured equals priced exactly.
"""
from __future__ import annotations

import dataclasses
import time

from torch.utils import _pytree as pytree

from repro_torch.device import synchronize

__all__ = ["CommsLedger", "StreamRecord", "attach_ledger", "time_round_us"]


@dataclasses.dataclass
class StreamRecord:
    """Per-round wire template of ONE consensus stream (one agent).

    ``wire_bytes`` is what a compressed round ships, ``full_bytes`` what
    a warm-up (full float32) round ships; ``entries`` the per-agent
    payload entry count and ``collectives`` the collective operations of
    one round (1 for the matrix backends).
    """

    op: str
    entries: int
    wire_bytes: int
    full_bytes: int
    collectives: int = 1


class CommsLedger:
    """Measured per-agent communication accounting for one engine."""

    def __init__(self):
        self.streams: dict[str, StreamRecord] = {}
        # schedule knobs, copied from the engine by ``attach_ledger``
        self.compress_after = 0
        self.communication_interval = 1
        self.steps_committed = 0
        self.round_latency_us: float | None = None
        self._bytes = 0.0
        self._collectives = 0

    def note(self, stream: str, record: StreamRecord) -> None:
        """Record (or overwrite) one stream's per-round wire template."""
        self.streams[stream] = record

    def commit_steps(self, num_steps: int) -> float:
        """Charge ``num_steps`` solver steps of the recorded streams,
        continuing from the steps committed before: warm-up rounds ship
        ``full_bytes``, silent rounds (``t % interval != 0``) nothing,
        the others ``wire_bytes``.  Returns the bytes this call charged.
        """
        start = self.steps_committed
        charged = 0.0
        for t in range(start, start + int(num_steps)):
            if t % self.communication_interval != 0:
                continue
            for rec in self.streams.values():
                charged += (rec.full_bytes if t < self.compress_after
                            else rec.wire_bytes)
                self._collectives += rec.collectives
        self.steps_committed += int(num_steps)
        self._bytes += charged
        return charged

    @property
    def measured_wire_bytes(self) -> float:
        """Per-agent bytes shipped over all committed steps."""
        return self._bytes

    @property
    def collectives_issued(self) -> int:
        """Collective operations over all committed steps (per agent)."""
        return self._collectives

    def bytes_per_step(self) -> float:
        """Compressed-round bytes of one step (all streams, no schedule)."""
        return float(sum(r.wire_bytes for r in self.streams.values()))

    def observe_latency(self, us: float) -> None:
        self.round_latency_us = float(us)

    def summary(self) -> dict:
        """JSON-ready dump of everything measured."""
        return {
            "streams": {k: dataclasses.asdict(v)
                        for k, v in self.streams.items()},
            "compress_after": self.compress_after,
            "communication_interval": self.communication_interval,
            "steps_committed": self.steps_committed,
            "measured_wire_bytes": self.measured_wire_bytes,
            "collectives_issued": self.collectives_issued,
            "round_latency_us": self.round_latency_us,
        }


def attach_ledger(engine, ledger: CommsLedger | None = None) -> CommsLedger:
    """Install ``ledger`` (a new one by default) on ``engine``, with the
    engine's schedule knobs, before the step runs or is captured."""
    if ledger is None:
        ledger = CommsLedger()
    ledger.compress_after = int(engine.compression.compress_after)
    ledger.communication_interval = int(engine.communication_interval)
    engine.ledger = ledger
    return ledger


def _wait(out) -> None:
    synchronize(pytree.tree_leaves(out)[0].device)


def time_round_us(fn, *args, reps: int = 5) -> float:
    """Median wall-clock of one warmed call of ``fn(*args)`` in us.

    The first call runs outside the timed window; each timed call ends
    with a device synchronise, so the time covers the device's work.
    """
    _wait(fn(*args))
    samples = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        _wait(fn(*args))
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return 1e6 * samples[len(samples) // 2]
