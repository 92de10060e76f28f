"""Round-latency timing of one consensus combine.

Counterpart of ``time_round_us`` in ``repro.consensus.ledger``; the
measured-bytes ledger of the compressed wire arrives with that path.
"""
from __future__ import annotations

import time

from torch.utils import _pytree as pytree

from repro_torch.device import synchronize

__all__ = ["time_round_us"]


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
