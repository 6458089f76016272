"""Warm-start history: per-testbed winners persisted to JSON.

Every search records its per-context winner keyed by
``network/dataset/ccN``, and later searches seed from the store: the
oracle and successive halving add the remembered winner to their
candidate sets, the hill climber starts walking from it instead of the
Algorithm-1 point. The file is the reference implementation's format, so
either package reads a store the other wrote::

    {
      "version": 1,
      "winners": {
        "xsede/mixed/cc8": {
          "pipelining": 16, "parallelism": 4, "concurrency": 8,
          "throughput": 1.04e9, "method": "oracle"
        }, ...
      }
    }

A winner is replaced only by a strictly better throughput, so cheap
searches cannot clobber an exhaustive result.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

from repro_torch.core.types import TransferParams, param_triple

VERSION = 1


def history_key(scenario) -> str:
    """Per-testbed warm-start key: path, dataset shape and maxCC budget
    (the budget caps the admissible space, so winners do not carry across
    it)."""
    return f"{scenario.network}/{scenario.dataset}/cc{scenario.max_cc}"


class HistoryStore:
    """JSON-backed map of per-testbed winning static settings."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._winners: Dict[str, dict] = {}
        if path is not None and os.path.exists(path):
            self.load(path)

    def __len__(self) -> int:
        return len(self._winners)

    def load(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if path is None:
            raise ValueError("no path given and store was created without one")
        with open(path) as f:
            data = json.load(f)
        if data.get("version") != VERSION:
            raise ValueError(
                f"history store {path!r} has version {data.get('version')!r}, "
                f"expected {VERSION}"
            )
        self._winners = dict(data.get("winners", {}))

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if path is None:
            raise ValueError("no path given and store was created without one")
        payload = {"version": VERSION, "winners": self._winners}
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")

    def record(self, scenario, params, throughput: float, method: str = "unknown") -> bool:
        """Remember ``params`` for the scenario's testbed if it beats the
        stored winner (strictly). Returns whether the store changed."""
        key = history_key(scenario)
        prev = self._winners.get(key)
        if prev is not None and prev["throughput"] >= throughput:
            return False
        trip = param_triple(params)
        self._winners[key] = {
            "pipelining": trip[0],
            "parallelism": trip[1],
            "concurrency": trip[2],
            "throughput": float(throughput),
            "method": method,
        }
        return True

    def seed(self, scenario) -> Optional[TransferParams]:
        """The remembered winner for the scenario's testbed, if any."""
        entry = self._winners.get(history_key(scenario))
        if entry is None:
            return None
        return TransferParams(
            pipelining=int(entry["pipelining"]),
            parallelism=int(entry["parallelism"]),
            concurrency=int(entry["concurrency"]),
        )

    def best_throughput(self, scenario) -> Optional[float]:
        entry = self._winners.get(history_key(scenario))
        return None if entry is None else float(entry["throughput"])
