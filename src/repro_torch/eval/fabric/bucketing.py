"""Canonical shape ladder of the batched sweep.

Every padded axis of the driver state sits on a small fixed ladder, so a
sweep meets a handful of kernel shapes: the channel axis C and the
resume-stack depth P double from 4, the chunk axis K is the next power
of two, the bandwidth-profile width B is 1 for all-static batches and
else the power-of-two ladder from :data:`PROFILE_PAD_FLOOR`, and the flat
file-size buffer Q is zero-padded once at upload to the quarter-step
ladder of :func:`qsizes_pad`.
"""
from __future__ import annotations

from typing import Tuple

#: floor on the bucketed flat file-size buffer
QSIZES_FLOOR = 1024

#: the driver compacts finished rows out of the batch only while it is
#: wider than this: below it a sweep costs its launches, not its width
COMPACT_FLOOR = 64

#: floor on the bucketed bandwidth-profile width of any batch that has a
#: profiled row at all (all-static batches keep width 1)
PROFILE_PAD_FLOOR = 16


def bucket(n: int, floor: int = 1) -> int:
    """Next power of two at or above ``max(n, floor)`` (``floor`` for 0)."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


def qsizes_pad(n: int) -> int:
    """Bucketed length of the flat file-size buffer: the quarter-step
    ladder ``1024, 4096, 16384, 65536, ...``."""
    q = QSIZES_FLOOR
    n = int(n)
    while q < n:
        q *= 4
    return q


def chunk_spans(n: int, size: int) -> Tuple[Tuple[int, int], ...]:
    """Split ``n`` rows into execution-chunk ``(lo, hi)`` spans of at most
    ``size`` rows, in order."""
    if size <= 0:
        raise ValueError(f"chunk size must be positive, got {size}")
    return tuple((lo, min(lo + size, n)) for lo in range(0, n, size))
