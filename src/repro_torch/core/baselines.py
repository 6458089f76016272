"""Comparison systems (Sec. 2 / Sec. 4.2) and the static-parameter rows.

* ``GlobusOnlineScheduler``: the whole dataset as one chunk with static
  parameters chosen from its average file size (< 50 MB small, 50-250 MB
  medium, > 250 MB large); ``connect_personal`` degrades the path like
  Globus Connect Personal on a LAN (control relayed through an internet
  service, one stream a channel).
* ``UntunedScheduler``: globus-url-copy defaults (no pipelining, one
  stream, one channel).
* ``StaticParamsScheduler``: one undivided chunk at caller-chosen
  parameters (the autotuner's candidate rows).
"""
from __future__ import annotations

import dataclasses
from typing import List

from .schedulers import Action, ChunkViews, Open, Scheduler
from .types import MB, Chunk, ChunkType, FileSpec, NetworkSpec, TransferParams

#: static parameter presets per Globus Online size class
GLOBUS_PRESETS = {
    "small": TransferParams(pipelining=20, parallelism=2, concurrency=2),
    "medium": TransferParams(pipelining=5, parallelism=4, concurrency=4),
    "large": TransferParams(pipelining=2, parallelism=6, concurrency=3),
}


def globus_class(avg_file_size: float) -> str:
    if avg_file_size < 50 * MB:
        return "small"
    if avg_file_size <= 250 * MB:
        return "medium"
    return "large"


def degrade_for_connect_personal(network: NetworkSpec) -> NetworkSpec:
    """The Globus-Connect-Personal relay path on a LAN endpoint: control
    round trips cross the internet (40 ms a file), the per-stream window
    is clamped to a relay-grade ~40 MB/s, one stream a channel."""
    relay_rtt = 0.040
    relay_buffer = int(40e6 * network.rtt) if network.rtt > 0 else 8 * 1024
    return dataclasses.replace(
        network,
        name=network.name + "+gcp",
        buffer_size=max(8 * 1024, min(network.buffer_size, relay_buffer)),
        unhidden_overhead=network.unhidden_overhead + relay_rtt,
        max_streams_per_channel=1,
    )


class _StaticOneChunkScheduler(Scheduler):
    """Transfer everything as a single chunk with fixed parameters."""

    params: TransferParams

    def __init__(self, chunks, network, max_cc, params: TransferParams):
        merged = Chunk(
            ctype=ChunkType.ALL,
            files=[f for c in chunks for f in c.files],
            params=params,
        )
        super().__init__([merged], network, max_cc)
        self.params = params

    def initial_actions(self, view: ChunkViews) -> List[Action]:
        return [Open(chunk=0, n=self.params.concurrency)]


class StaticParamsScheduler(_StaticOneChunkScheduler):
    """One undivided chunk at caller-chosen fixed parameters; it opens its
    channels once and never acts again."""

    name = "Static"

    def __init__(self, chunks, network, max_cc, params: TransferParams):
        super().__init__(chunks, network, max_cc, params)
        p = params
        self.name = f"Static(pp={p.pipelining},p={p.parallelism},cc={p.concurrency})"


class GlobusOnlineScheduler(_StaticOneChunkScheduler):
    name = "GlobusOnline"

    def __init__(self, chunks, network, max_cc, *, connect_personal: bool = False):
        files: List[FileSpec] = [f for c in chunks for f in c.files]
        total = sum(f.size for f in files)
        avg = total / len(files) if files else 1.0
        params = GLOBUS_PRESETS[globus_class(avg)]
        if connect_personal:
            network = degrade_for_connect_personal(network)
        super().__init__(chunks, network, max_cc, params)


class UntunedScheduler(_StaticOneChunkScheduler):
    """globus-url-copy defaults: pp=0, p=1, cc=1."""

    name = "Untuned"

    def __init__(self, chunks, network, max_cc):
        super().__init__(
            chunks,
            network,
            max_cc,
            TransferParams(pipelining=0, parallelism=1, concurrency=1),
        )
