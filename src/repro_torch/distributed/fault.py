"""Fault tolerance and elasticity for 1000+-node operation.

Three mechanisms, all host-side (no accelerator coupling):

1. **Heartbeats + straggler detection** — per-host step-time EWMAs; hosts
   slower than ``tau`` x the fleet median for ``patience`` consecutive
   windows are flagged. Mitigation reuses the paper's *online channel
   re-allocation* (Sec. 3.4) at pod granularity: DCN channels are moved away
   from a straggling pod's links exactly like ProMC moves channels from fast
   chunks to slow ones (the straggler's ETA is the laggard).

2. **Restart policy** — bounded retries with exponential backoff; the train
   loop resumes from the newest *complete* checkpoint (atomic index commit,
   see repro_torch.checkpoint).

3. **Elastic re-mesh plans** — given surviving chip counts, propose degraded
   meshes (drop a pod; shrink the data axis to the largest feasible divisor)
   plus the parameter re-shard map, so the job continues at reduced width
   instead of dying.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class HostStats:
    ewma: float = 0.0
    n: int = 0
    flags: int = 0  # consecutive slow windows


class StragglerDetector:
    """EWMA step-time tracker with median-relative flagging."""

    def __init__(self, tau: float = 1.5, patience: int = 3, alpha: float = 0.3):
        self.tau = tau
        self.patience = patience
        self.alpha = alpha
        self.hosts: Dict[str, HostStats] = {}

    def record(self, host: str, step_time: float) -> None:
        st = self.hosts.setdefault(host, HostStats())
        st.ewma = (
            step_time
            if st.n == 0
            else (1 - self.alpha) * st.ewma + self.alpha * step_time
        )
        st.n += 1

    def median(self) -> float:
        vals = sorted(s.ewma for s in self.hosts.values() if s.n > 0)
        if not vals:
            return 0.0
        return vals[len(vals) // 2]

    def update_flags(self) -> List[str]:
        """Call once per window; returns hosts flagged as stragglers."""
        med = self.median()
        flagged = []
        for host, st in self.hosts.items():
            if med > 0 and st.ewma > self.tau * med:
                st.flags += 1
            else:
                st.flags = 0
            if st.flags >= self.patience:
                flagged.append(host)
        return flagged


def reallocate_channels_for_straggler(
    channel_alloc: Dict[str, int], straggler: str, min_channels: int = 1
) -> Dict[str, int]:
    """Paper Sec.-3.4 re-allocation at pod granularity: move one DCN channel
    from the fastest (non-straggling) pod to each straggler's peers — i.e.
    reduce the straggler's outbound concurrency so its link stops being the
    collective critical path, handing the channel to the fastest pod."""
    alloc = dict(channel_alloc)
    if straggler not in alloc or alloc[straggler] <= min_channels:
        return alloc
    others = [h for h in alloc if h != straggler]
    if not others:
        return alloc
    fastest = max(others, key=lambda h: alloc[h])
    alloc[straggler] -= 1
    alloc[fastest] += 1
    return alloc


@dataclasses.dataclass
class RestartPolicy:
    max_failures: int = 10
    backoff_base: float = 5.0
    backoff_cap: float = 300.0
    failures: int = 0

    def next_delay(self) -> Optional[float]:
        """Seconds to wait before restarting, or None when exhausted."""
        if self.failures >= self.max_failures:
            return None
        delay = min(self.backoff_base * (2 ** self.failures), self.backoff_cap)
        self.failures += 1
        return delay

    def reset(self) -> None:
        self.failures = 0


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    chips: int
    note: str


def elastic_mesh_plans(
    n_pods: int,
    chips_per_pod: int,
    lost_pods: int = 0,
    lost_chips_in_pod: int = 0,
    model_axis: int = 16,
) -> List[MeshPlan]:
    """Degraded-mesh proposals after failures.

    The model axis is preserved (TP width changes would re-shard every
    weight); the data axis shrinks to the largest feasible size; whole-pod
    loss drops the pod axis dimension.
    """
    plans: List[MeshPlan] = []
    pods = n_pods - lost_pods
    if pods < 1:
        return plans
    chips = chips_per_pod - lost_chips_in_pod
    data = chips // model_axis
    # shrink data axis to the largest power-of-two-ish divisor that fits
    while data >= 1:
        if data * model_axis <= chips:
            shape = (pods, data, model_axis) if pods > 1 else (data, model_axis)
            axes = ("pod", "data", "model") if pods > 1 else ("data", "model")
            plans.append(
                MeshPlan(
                    shape=shape,
                    axes=axes,
                    chips=pods * data * model_axis,
                    note=(
                        f"{pods} pod(s) x {data} data x {model_axis} model; "
                        f"global batch rescales by {data * pods}"
                    ),
                )
            )
            break
        data -= 1
    # also offer the half-width fallback (for rolling single-host failures)
    if data >= 2:
        half = data // 2
        shape = (pods, half, model_axis) if pods > 1 else (half, model_axis)
        axes = ("pod", "data", "model") if pods > 1 else ("data", "model")
        plans.append(
            MeshPlan(
                shape=shape,
                axes=axes,
                chips=pods * half * model_axis,
                note="half-width data axis (headroom for rolling failures)",
            )
        )
    return plans
