"""Channel-rate model for channels sharing a network path and a disk.

A channel's rate ceiling is the per-stream TCP window limit
``window_efficiency * buffer / RTT`` aggregated over its parallel streams
(``NetworkSpec.stream_rate_cap``), capped by the per-channel disk lane.
The batched plan computes the same ceiling column-wise for every
(row, chunk) (:mod:`repro_torch.eval.fabric.plan`); this scalar form
feeds its cost proxy.
"""
from __future__ import annotations

from .types import NetworkSpec


def per_channel_disk_lane(network: NetworkSpec) -> float:
    """Single-channel disk ceiling: one storage lane per channel."""
    return network.disk.channel_lane


def channel_rate_cap(network: NetworkSpec, parallelism: int) -> float:
    """Ceiling of one channel: TCP window aggregate x disk lane."""
    return min(
        network.stream_rate_cap(parallelism),
        per_channel_disk_lane(network),
    )
