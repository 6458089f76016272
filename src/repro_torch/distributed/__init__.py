"""Distributed runtime: ranks as pods, the paper-scheduled gradient sync
between them, gradient compression, fault tolerance (host-side
arithmetic)."""
from .compression import bf16_roundtrip, compression_error, int8_decode, int8_encode
from .grad_sync import (
    DEFAULT_COMPRESSION,
    NO_COMPRESSION,
    SyncItem,
    SyncPlan,
    SyncReport,
    apply_sync,
    build_sync_plan,
    naive_sync,
    simulate_sync,
)
from .pods import Pods, close_pods, init_pods, local_rows

__all__ = [
    "DEFAULT_COMPRESSION",
    "NO_COMPRESSION",
    "Pods",
    "SyncItem",
    "SyncPlan",
    "SyncReport",
    "apply_sync",
    "bf16_roundtrip",
    "build_sync_plan",
    "close_pods",
    "compression_error",
    "init_pods",
    "int8_decode",
    "int8_encode",
    "local_rows",
    "naive_sync",
    "simulate_sync",
]
