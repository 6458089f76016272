"""Core datatypes of the transfer model.

Units convention (paper-faithful):
  - sizes/bytes:   bytes
  - bandwidth:     bytes/second
  - time:          seconds
  - BDP:           bytes  (= bandwidth * RTT)
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

MB = 1024 * 1024
GB = 1024 * MB
KB = 1024


def gbps(x: float) -> float:
    """Gigabits/second -> bytes/second."""
    return x * 1e9 / 8.0


class ChunkType(enum.IntEnum):
    """File-size classes (Fig. 3). Values order by increasing file size."""

    SMALL = 0
    MEDIUM = 1
    LARGE = 2
    HUGE = 3
    #: a dataset transferred as one undivided chunk
    ALL = 4


#: MC channel round-robin order (Alg. 2 line 9): {Huge, Small, Large, Medium}
MC_ROUND_ROBIN_ORDER: tuple = (
    ChunkType.HUGE,
    ChunkType.SMALL,
    ChunkType.LARGE,
    ChunkType.MEDIUM,
    ChunkType.ALL,
)

#: ProMC delta coefficients (Sec. 3.4): smaller chunks get more weight
PROMC_DELTA = {
    ChunkType.SMALL: 6.0,
    ChunkType.MEDIUM: 3.0,
    ChunkType.LARGE: 2.0,
    ChunkType.HUGE: 1.0,
    ChunkType.ALL: 2.0,
}


@dataclasses.dataclass(frozen=True)
class FileSpec:
    """One transferable unit."""

    name: str
    size: int  # bytes
    path: Optional[str] = None

    def __post_init__(self):
        if self.size < 0:
            raise ValueError(f"negative file size: {self.name}: {self.size}")


@dataclasses.dataclass(frozen=True)
class TransferParams:
    """The three protocol parameters tuned by the paper (Algorithm 1)."""

    pipelining: int
    parallelism: int
    concurrency: int

    def __post_init__(self):
        if self.parallelism < 1:
            raise ValueError("parallelism must be >= 1")
        if self.pipelining < 0:
            raise ValueError("pipelining must be >= 0")
        if self.concurrency < 1:
            raise ValueError("concurrency must be >= 1")


def param_triple(params) -> tuple:
    """Normalize a parameter setting to a ``(pp, p, cc)`` int triple
    (:class:`TransferParams` or a plain 3-sequence)."""
    if hasattr(params, "pipelining"):
        return (
            int(params.pipelining),
            int(params.parallelism),
            int(params.concurrency),
        )
    trip = tuple(int(v) for v in params)
    if len(trip) != 3:
        raise ValueError(
            f"expected (pipelining, parallelism, concurrency), got {params!r}"
        )
    return trip


@dataclasses.dataclass(frozen=True)
class DiskSpec:
    """End-system storage model: aggregate streaming rate at saturation,
    per-file overhead, the saturating concurrency, the per-channel
    contention loss past it, and an optional single-channel lane."""

    streaming_rate: float
    per_file_overhead: float = 0.005
    saturation_cc: int = 8
    contention: float = 0.02
    per_channel_rate: Optional[float] = None

    @property
    def channel_lane(self) -> float:
        if self.per_channel_rate is not None:
            return self.per_channel_rate
        return self.streaming_rate / max(1, self.saturation_cc)


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """A network path between two end systems (paper Tables 1-2)."""

    name: str
    bandwidth: float  # bytes/s
    rtt: float  # seconds
    buffer_size: int  # bytes (max TCP buffer per stream)
    disk: DiskSpec
    #: per-file server-side processing that pipelining cannot hide
    unhidden_overhead: float = 0.0
    #: one-time cost of (re-)establishing a data channel
    channel_setup_cost: float = 0.1
    #: per-extra-stream end-system efficiency loss
    stream_cpu_overhead: float = 0.002
    max_total_streams: int = 256
    #: fraction of the nominal window buffer/RTT a TCP stream sustains
    window_efficiency: float = 0.55
    #: server-enforced cap on data streams per transfer
    max_streams_per_channel: int = 64
    #: control-channel round trip when it differs from the data path
    control_rtt: Optional[float] = None
    #: piecewise-constant capacity multipliers ``((0.0, m0), (t1, m1),
    #: ...)``; None means a static path
    bandwidth_profile: Optional[tuple] = None

    def __post_init__(self):
        if self.bandwidth_profile is not None:
            prof = tuple(self.bandwidth_profile)
            if not prof or prof[0][0] != 0.0:
                raise ValueError(
                    "bandwidth_profile must start with a (0.0, mult) step"
                )
            if list(prof) != sorted(prof, key=lambda p: p[0]):
                raise ValueError("bandwidth_profile steps must be sorted")

    @property
    def bdp(self) -> float:
        """Bandwidth-delay product in bytes."""
        return self.bandwidth * self.rtt

    def stream_rate_cap(self, parallelism: int) -> float:
        """Max rate of one channel with ``parallelism`` TCP streams."""
        p = max(1, min(parallelism, self.max_streams_per_channel))
        per_stream = self.window_efficiency * self.buffer_size / max(self.rtt, 1e-9)
        eff = 1.0 / (1.0 + self.stream_cpu_overhead * (p - 1))
        return min(p * per_stream * eff, self.bandwidth)
