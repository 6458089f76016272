"""Host-side data pipeline: prefetching iterator + engine-backed ingestion.

Two layers:

* ``Prefetcher`` — a bounded background-thread prefetch queue around any
  batch iterator (keeps the host busy preparing batch N+1..N+depth while
  step N runs), with clean shutdown and exception propagation.
* ``ingest_files`` — bulk-loads a mixed-size corpus directory through the
  paper's TransferEngine (chunking + Algorithm 1 + MC/ProMC): shard files
  of wildly different sizes are exactly the workload the technique tunes.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from repro_torch.core import testbeds
from repro_torch.core.engine import TransferEngine, TransferTask
from repro_torch.core.runner import prepare_chunks
from repro_torch.core.schedulers import make_scheduler
from repro_torch.core.types import FileSpec, NetworkSpec


class Prefetcher:
    """Wrap an iterator with a depth-bounded background prefetch thread."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def run():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self._q.put(item)
            except BaseException as e:  # surfaced on next __next__
                self._err = e
            finally:
                self._q.put(self._DONE)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        return item

    def close(self):
        """Stop the producer and wait for it (at most 5 seconds):
        drain the queue until it exits, so that neither an item nor the end
        marker it puts after the stop flag leaves it blocked on a full
        queue."""
        self._stop.set()
        deadline = time.monotonic() + 5.0
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                self._q.get(timeout=0.01)
            except queue.Empty:
                pass
        self._thread.join(timeout=max(0.0, deadline - time.monotonic()))


def ingest_files(
    paths: List[str],
    *,
    network: NetworkSpec = testbeds.CKPT_STORE,
    algorithm: str = "mc",
    max_cc: int = 4,
    sink: Optional[Callable[[str, bytes], None]] = None,
) -> Dict[str, bytes]:
    """Read a mixed-size file set through the scheduled transfer engine.

    Returns {path: contents} (or streams into ``sink`` when given). The
    engine tunes pipelining / striping / concurrency per size class exactly
    as it does for WAN transfers — on a parallel filesystem this is what
    keeps many-small-file ingestion from serializing on per-file latency.
    """
    specs: List[FileSpec] = []
    tasks: Dict[str, TransferTask] = {}
    out: Dict[str, bytes] = {}
    lock = threading.Lock()

    for path in paths:
        size = os.path.getsize(path)
        spec = FileSpec(name=path, size=size, path=path)
        specs.append(spec)
        buf = bytearray(size)

        def make(path=path, buf=buf):
            def read(offset: int, length: int) -> bytes:
                with open(path, "rb") as f:
                    f.seek(offset)
                    return f.read(length)

            def write(offset: int, data: bytes) -> None:
                buf[offset : offset + len(data)] = data

            def finalize(path=path, buf=buf):
                payload = bytes(buf)
                if sink is not None:
                    sink(path, payload)
                else:
                    with lock:
                        out[path] = payload

            return TransferTask(
                spec=spec, read=read, write=write, finalize=finalize
            )

        tasks[path] = make()

    chunks = prepare_chunks(specs, network, num_chunks=2, max_cc=max_cc)
    sched = make_scheduler(algorithm, chunks, network, max_cc)
    engine = TransferEngine(network, tick_period=0.05)
    report = engine.run(chunks, sched, tasks)
    if report.files_done != len(specs):
        raise IOError(f"ingested {report.files_done}/{len(specs)} files")
    return out
