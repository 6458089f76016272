"""Per-scenario result record of the batched sweep."""
from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class SimResult:
    network: str
    scheduler: str
    total_bytes: float
    total_time: float
    #: aggregate achieved throughput, bytes/s
    throughput: float
    per_chunk_time: Dict[str, float]
    per_chunk_bytes: Dict[str, float]
    timeline: List[tuple]  # (t, instantaneous aggregate rate)
    n_events: int
    n_moves: int

    @property
    def throughput_gbps(self) -> float:
        return self.throughput * 8.0 / 1e9
