"""Network presets of the scenario matrices: the paper's WAN testbeds
(Tables 1-2), their impaired-path variants (loss / jitter / asymmetric
control RTT), the time-varying-capacity variants, and two accelerator-fabric
presets: the pod-pair network (``DCN``) and the checkpoint store
(``CKPT_STORE``)."""
from __future__ import annotations

import dataclasses
import math

from .types import MB, DiskSpec, NetworkSpec, gbps

#: segment size of the Mathis loss-window model
_MSS = 1460.0


def impaired_variant(
    base: NetworkSpec,
    name: str,
    *,
    loss_rate: float = 0.0,
    jitter: float = 0.0,
    control_rtt: float | None = None,
    bandwidth_steps: tuple | None = None,
    bandwidth_ramp: tuple | None = None,
) -> NetworkSpec:
    """Derive an impaired path from a clean preset.

    ``loss_rate`` caps the window at the Mathis bound ``MSS *
    sqrt(1.5/loss)`` (and wastes a tenth of it); ``jitter`` inflates the
    RTT to ``rtt + 2*jitter`` and the unhidden per-file cost by
    ``jitter``; ``control_rtt`` sets an asymmetric control path;
    ``bandwidth_steps`` ``((t, mult), ...)`` or ``bandwidth_ramp``
    ``(t0, t1, end_scale, n_steps)`` give a piecewise-constant capacity
    profile.
    """
    rtt = base.rtt + 2.0 * jitter
    buffer_size = base.buffer_size
    window_efficiency = base.window_efficiency
    if loss_rate > 0.0:
        mathis_window = _MSS * math.sqrt(1.5 / loss_rate)
        buffer_size = int(min(buffer_size, mathis_window))
        window_efficiency *= 0.9
    fields = dict(
        name=name,
        rtt=rtt,
        buffer_size=buffer_size,
        window_efficiency=window_efficiency,
        unhidden_overhead=base.unhidden_overhead + jitter,
    )
    if control_rtt is not None:
        fields["control_rtt"] = control_rtt
    if bandwidth_steps is not None and bandwidth_ramp is not None:
        raise ValueError("pass bandwidth_steps or bandwidth_ramp, not both")
    if bandwidth_ramp is not None:
        t0, t1, end_scale, n_steps = bandwidth_ramp
        bandwidth_steps = tuple(
            (t0 + i * (t1 - t0) / n_steps, 1.0 + (end_scale - 1.0) * i / n_steps)
            for i in range(1, n_steps + 1)
        )
    if bandwidth_steps is not None:
        prof = tuple((float(t), float(m)) for t, m in bandwidth_steps)
        if not prof or prof[0][0] > 0.0:
            prof = ((0.0, 1.0),) + prof
        fields["bandwidth_profile"] = prof
    return dataclasses.replace(base, **fields)


XSEDE = NetworkSpec(
    name="xsede-lonestar-gordon",
    bandwidth=gbps(10),
    rtt=60e-3,
    buffer_size=32 * MB,
    disk=DiskSpec(
        streaming_rate=gbps(9.8),
        per_file_overhead=0.004,
        saturation_cc=8,
        contention=0.02,
        per_channel_rate=gbps(4.0),
    ),
    unhidden_overhead=0.055,
)

LONI = NetworkSpec(
    name="loni-queenbee-painter",
    bandwidth=gbps(10),
    rtt=10e-3,
    buffer_size=16 * MB,
    disk=DiskSpec(
        streaming_rate=gbps(5.5),
        per_file_overhead=0.005,
        saturation_cc=8,
        contention=0.03,
        per_channel_rate=gbps(2.5),
    ),
    unhidden_overhead=0.009,
)

BLUEWATERS_STAMPEDE = NetworkSpec(
    name="bluewaters-stampede",
    bandwidth=gbps(30),
    rtt=32e-3,
    buffer_size=32 * MB,
    disk=DiskSpec(
        streaming_rate=gbps(24),
        per_file_overhead=0.004,
        saturation_cc=8,
        contention=0.05,
        per_channel_rate=gbps(2.75),
    ),
    unhidden_overhead=0.012,
)

STAMPEDE_COMET = NetworkSpec(
    name="stampede-comet",
    bandwidth=gbps(10),
    rtt=40e-3,
    buffer_size=32 * MB,
    disk=DiskSpec(
        streaming_rate=gbps(9.2),
        per_file_overhead=0.004,
        saturation_cc=8,
        contention=0.02,
        per_channel_rate=gbps(2.3),
    ),
    unhidden_overhead=0.012,
)

SUPERMIC_BRIDGES = NetworkSpec(
    name="supermic-bridges",
    bandwidth=gbps(10),
    rtt=45e-3,
    buffer_size=4 * MB,
    disk=DiskSpec(
        streaming_rate=gbps(5.0),
        per_file_overhead=0.005,
        saturation_cc=12,
        contention=0.01,
        per_channel_rate=gbps(0.8),
    ),
    unhidden_overhead=0.012,
    max_streams_per_channel=2,
)

LAN = NetworkSpec(
    name="didclab-lan-glusterfs",
    bandwidth=gbps(10),
    rtt=0.2e-3,
    buffer_size=1 * MB,
    disk=DiskSpec(
        streaming_rate=gbps(3.2),
        per_file_overhead=0.003,
        saturation_cc=4,
        contention=0.08,
        per_channel_rate=gbps(0.9),
    ),
    unhidden_overhead=0.004,
)

LOSSY_TRANSATLANTIC = dataclasses.replace(
    impaired_variant(STAMPEDE_COMET, "lossy-transatlantic", loss_rate=2e-4),
    rtt=90e-3,
)

JITTERY_OVERLAY = impaired_variant(XSEDE, "jittery-overlay", jitter=12e-3)

ASYM_CONTROL_PATH = impaired_variant(
    dataclasses.replace(LONI, rtt=20e-3),
    "asym-control-path",
    control_rtt=180e-3,
)

STEPPY_BACKBONE = impaired_variant(
    STAMPEDE_COMET,
    "steppy-backbone",
    bandwidth_steps=((12.0, 0.45), (45.0, 0.8), (120.0, 0.6)),
)

RAMPY_EVENING = impaired_variant(
    LONI,
    "rampy-evening",
    bandwidth_ramp=(8.0, 88.0, 0.4, 8),
)

# ---------------------------------------------------------------------------
# Accelerator-fabric presets
# ---------------------------------------------------------------------------

#: cross-pod data-center network, as one pod's gradient-sync engine sees it:
#: "files" are gradient buckets, the channel window is the staging buffer
DCN = NetworkSpec(
    name="tpu-dcn-pod-pair",
    bandwidth=25e9,  # 25 GB/s aggregate per pod pair
    rtt=500e-6,
    buffer_size=4 * MB,  # per-channel in-flight window (staging buffer)
    disk=DiskSpec(
        streaming_rate=700e9,  # device-side staging, far from binding
        per_file_overhead=20e-6,
        saturation_cc=64,
        contention=0.001,
        per_channel_rate=80e9,
    ),
    unhidden_overhead=50e-6,  # per-bucket collective launch overhead
    channel_setup_cost=5e-3,  # collective-group re-materialization
    window_efficiency=1.0,  # lossless fabric: no TCP dynamics
)

#: host <-> distributed checkpoint storage path (``checkpoint.ckpt``'s and
#: ``data.pipeline.ingest_files``'s default)
CKPT_STORE = NetworkSpec(
    name="ckpt-object-store",
    bandwidth=10e9,  # 10 GB/s per host aggregate
    rtt=2e-3,
    buffer_size=8 * MB,
    disk=DiskSpec(
        streaming_rate=8e9,
        per_file_overhead=0.002,
        saturation_cc=16,
        contention=0.01,
        per_channel_rate=1.2e9,
    ),
    unhidden_overhead=1e-3,
    window_efficiency=0.9,
)

TESTBEDS = {
    t.name: t
    for t in (
        XSEDE,
        LONI,
        BLUEWATERS_STAMPEDE,
        STAMPEDE_COMET,
        SUPERMIC_BRIDGES,
        LAN,
        LOSSY_TRANSATLANTIC,
        JITTERY_OVERLAY,
        ASYM_CONTROL_PATH,
        STEPPY_BACKBONE,
        RAMPY_EVENING,
        DCN,
        CKPT_STORE,
    )
}
