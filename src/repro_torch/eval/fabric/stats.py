"""What a batched sweep did and where its host time went: the per-call
:class:`SweepStats` and its thread-safe accumulation.

The reference keeps one process-wide ``SYNC_STATS`` dict; the port keeps a
:class:`SweepStats` a call (each driver has its own, the runner adds them
into the caller's), so two sweeps in one process never mix their counts.

The counters (``sweeps`` .. ``post_row_replays``) are exact integers. The
seconds fields are host thread-seconds, each timing its own span and no
other's (none nests inside another):

* ``ingest_s``: building the plans: the columnar build of a matrix, a
  chunk's slice of it, or a lazy chunk's Simulations and the object
  ingest's columns;
* ``build_wall_s``: a chunk's driver set-up on the host from its plan and
  the upload of its columns;
* ``compute_wall_s``: the driver's run (launches, host transitions,
  compaction), less its device-to-host reads;
* ``download_wall_s``: the driver's device-to-host reads (each waits for
  the device's queued work first, so it holds the device time the host
  waits out).

Under the async executor several prep and compute threads add into one
caller's stats at once, so the seconds overlap and may sum to more than
the elapsed wall; their shares say where the host's threads spent it
(``runner --verbose``). Every addition from a thread goes through one lock.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from contextlib import contextmanager
from typing import Optional

#: the wall-clock fields (float thread-seconds, overlapping under the async
#: executor); every other field of :class:`SweepStats` but ``ingest_s`` is
#: an exact integer counter
WALL_KEYS = ("build_wall_s", "compute_wall_s", "download_wall_s")

#: guards every addition into a caller's stats (the executor's threads
#: merge their drivers' stats concurrently)
_LOCK = threading.Lock()


@dataclasses.dataclass
class SweepStats:
    """What one driver did: host rounds (``sweeps``) by route, host reads
    of device values (each one waits for the device), row steps taken on
    the device (``steps``, the sum of the rows' event counts; on the
    ``"rounds"`` route a round takes many), and rows whose loop stopped at
    a capacity guard and left a step's transition to the host
    (``host_transitions``; 0 wherever the plan's bounds size C and P),
    and custom-scheduler rows whose loop stopped at a callback event and
    left the step's transition to the host (``post_row_replays``, the
    reference's name for the same count; 0 on the built-in grids), and
    the row steps whose water level the loop kernels reused from the row's
    last step (``level_reuses``, on the ``"rounds"`` route; their row steps
    less these are the level descents the inputs needed). Then
    the host seconds of the plan build (``ingest_s``) and of the chunk
    pipeline's phases (:data:`WALL_KEYS`; the module docstring says what
    each times)."""

    sweeps: int = 0
    fused: int = 0
    split: int = 0
    host_syncs: int = 0
    steps: int = 0
    host_transitions: int = 0
    post_row_replays: int = 0
    level_reuses: int = 0
    ingest_s: float = 0.0
    build_wall_s: float = 0.0
    compute_wall_s: float = 0.0
    download_wall_s: float = 0.0

    def counters(self) -> dict:
        """The exact integer fields by name (the seconds left out)."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name != "ingest_s" and f.name not in WALL_KEYS}


def record_wall(stats: Optional[SweepStats], key: str, seconds: float) -> None:
    """Add ``seconds`` to ``stats.<key>`` under the lock (nothing without
    stats)."""
    if stats is None:
        return
    with _LOCK:
        setattr(stats, key, getattr(stats, key) + seconds)


@contextmanager
def wall_timer(stats: Optional[SweepStats], key: str):
    """Add the enclosed block's wall seconds to ``stats.<key>``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_wall(stats, key, time.perf_counter() - t0)


def merge_stats(into: Optional[SweepStats], local: SweepStats) -> None:
    """Add every field of one driver's ``local`` stats into ``into`` in one
    locked step, so chunks that finish at once add up to what the serial
    loop gives."""
    if into is None:
        return
    with _LOCK:
        for f in dataclasses.fields(SweepStats):
            setattr(into, f.name, getattr(into, f.name) + getattr(local, f.name))
