"""Channel-rate model for channels sharing a network path and a disk.

A channel's rate ceiling is the per-stream TCP window limit
``window_efficiency * buffer / RTT`` aggregated over its parallel streams
(``NetworkSpec.stream_rate_cap``), capped by the per-channel disk lane.
Channels that move data share the link and the disk's aggregate rate by
max-min water-filling; a file pays serial dead time before its bytes
flow (control gap RTT/(1+pipelining), server processing pipelining
cannot hide, per-file disk overhead).

These are the scalar forms the event simulator
(:mod:`repro_torch.core.simulator`) runs; the batched plan and sweep
compute the same quantities column-wise
(:mod:`repro_torch.eval.fabric.plan`, :mod:`repro_torch.eval.fabric.kernels`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from .types import NetworkSpec, TransferParams


def waterfill(caps: Sequence[float], pool: float) -> List[float]:
    """Max-min fair allocation of ``pool`` across entities with rate
    ``caps``: entities below the fair share keep their cap, the rest is
    split evenly among the others (progressive filling)."""
    n = len(caps)
    if n == 0 or pool <= 0:
        return [0.0] * n
    alloc = [0.0] * n
    remaining = pool
    unfilled = list(range(n))
    while unfilled and remaining > 1e-12:
        share = remaining / len(unfilled)
        capped = [i for i in unfilled if caps[i] <= share + 1e-12]
        if not capped:
            for i in unfilled:
                alloc[i] += share
            remaining = 0.0
            break
        for i in capped:
            alloc[i] = caps[i]
            remaining -= caps[i]
            unfilled.remove(i)
    return alloc


def per_channel_disk_lane(network: NetworkSpec) -> float:
    """Single-channel disk ceiling: one storage lane per channel."""
    return network.disk.channel_lane


def channel_rate_cap(network: NetworkSpec, parallelism: int) -> float:
    """Ceiling of one channel: TCP window aggregate x disk lane."""
    return min(
        network.stream_rate_cap(parallelism),
        per_channel_disk_lane(network),
    )


def allocate_rates(
    network: NetworkSpec,
    parallelisms: Sequence[int],
    active: Optional[Sequence[bool]] = None,
    bandwidth: Optional[float] = None,
) -> List[float]:
    """Instantaneous rates of channels ``i`` with ``parallelisms[i]``
    streams; ``active[i]`` False (dead time, idle) takes no bandwidth.
    ``bandwidth`` overrides the link capacity for this instant (default:
    the nominal one)."""
    n = len(parallelisms)
    if active is None:
        active = [True] * n
    idx = [i for i in range(n) if active[i]]
    if not idx:
        return [0.0] * n
    caps = [channel_rate_cap(network, parallelisms[i]) for i in idx]
    bw = network.bandwidth if bandwidth is None else bandwidth
    pool = min(bw, network.disk.aggregate_rate(len(idx)))
    alloc = waterfill(caps, pool)
    rates = [0.0] * n
    for j, i in enumerate(idx):
        rates[i] = alloc[j]
    return rates


def control_gap(network: NetworkSpec, params: TransferParams) -> float:
    """Control-channel ack gap per file, amortized by pipelining; an
    asymmetric path pays its control RTT here."""
    rtt = network.control_rtt if network.control_rtt is not None else network.rtt
    return rtt / (1.0 + params.pipelining)


def file_start_dead_time(network: NetworkSpec, params: TransferParams) -> float:
    """Serial per-file overhead before bytes flow on a channel: the control
    gap, the unhidden server-side processing and the per-file disk cost."""
    gap = control_gap(network, params)
    return gap + network.unhidden_overhead + network.disk.per_file_overhead


def channel_open_cost(
    network: NetworkSpec,
    new_params: TransferParams,
    prev_params: Optional[TransferParams] = None,
) -> float:
    """Cost of opening a channel, or of re-targeting one to another chunk:
    a quarter of the setup cost when the parallelism is unchanged (the
    cached data channel is reused), the full cost otherwise."""
    if prev_params is not None and prev_params.parallelism == new_params.parallelism:
        return 0.25 * network.channel_setup_cost
    return network.channel_setup_cost


def predict_chunk_rate(
    network: NetworkSpec,
    avg_file_size: float,
    params: TransferParams,
    n_channels: int,
    total_active_channels: Optional[int] = None,
) -> float:
    """Closed-form steady-state throughput estimate of one chunk, for ETAs
    before any rate has been measured."""
    if n_channels <= 0 or avg_file_size <= 0:
        return 0.0
    total = total_active_channels or n_channels
    cap = channel_rate_cap(network, params.parallelism)
    pool = min(network.bandwidth, network.disk.aggregate_rate(total))
    rate = min(cap, pool / max(1, total))
    dead = file_start_dead_time(network, params)
    t_file = dead + avg_file_size / max(rate, 1e-9)
    return n_channels * avg_file_size / t_file
