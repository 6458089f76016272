"""Scalar semantics the batched kernels keep."""
from __future__ import annotations

import math

from repro_torch.core.types import FileSpec


def resume_file(remaining: float) -> FileSpec:
    """Synthetic file re-queued when a busy channel is closed mid-transfer:
    the in-flight remainder restarts, rounded up to whole bytes
    (``controllers.transitions.move_channel`` pushes its size)."""
    return FileSpec(name="__resume__", size=int(math.ceil(remaining)))
