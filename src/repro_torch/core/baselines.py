"""Static-parameter baselines of the scenario matrix."""
from __future__ import annotations

from .types import TransferParams

#: static parameter presets per Globus Online size class
GLOBUS_PRESETS = {
    "small": TransferParams(pipelining=20, parallelism=2, concurrency=2),
    "medium": TransferParams(pipelining=5, parallelism=4, concurrency=4),
    "large": TransferParams(pipelining=2, parallelism=6, concurrency=3),
}
