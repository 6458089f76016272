"""Autotuner: batched parameter-space search and static-oracle regret.

The batched sweep is treated as a vectorized black-box objective
``f(scenario, pp, p, cc) -> throughput``; these modules choose which
(scenario x candidate) plane to hand it next:

  - :mod:`.space`    BDP-capped log-spaced (pp, p, cc) axes per testbed,
                     and the ``StaticParamsScheduler`` candidate vehicle
  - :mod:`.oracle`   exhaustive grid search as one batched sweep over the
                     candidate-expanded matrix; per-context argmax tables
                     and the heuristic-vs-oracle regret report
  - :mod:`.search`   successive halving (sketch rungs that shrink the
                     candidate axis between sweeps) and axis-neighbour
                     hill climbing, through the object ingest
  - :mod:`.history`  JSON warm-start store of per-testbed winners
  - :mod:`.contention` greedy per-tenant tuning against a coupled static
                     oracle over the shared-fabric tenant matrix

``python -m repro_torch.eval.runner --tune {oracle,sha,hill}`` is the CLI.
"""
from __future__ import annotations

from .contention import ContentionReport, contention_report, greedy_static_oracle
from .history import HistoryStore, history_key
from .oracle import (
    ContextTable,
    RegretReport,
    TuneEntry,
    TuneResult,
    candidate_lists,
    context_key,
    group_contexts,
    oracle_search,
    regret_report,
    save_report,
)
from .search import hill_climb, successive_halving
from .space import (
    ParamSpace,
    StaticParamsScheduler,
    algorithm1_params,
    axis_sizes,
    param_space,
    scenario_space,
)

__all__ = [
    "ContentionReport",
    "ContextTable",
    "HistoryStore",
    "ParamSpace",
    "RegretReport",
    "StaticParamsScheduler",
    "TuneEntry",
    "TuneResult",
    "algorithm1_params",
    "axis_sizes",
    "candidate_lists",
    "contention_report",
    "context_key",
    "greedy_static_oracle",
    "group_contexts",
    "hill_climb",
    "history_key",
    "oracle_search",
    "param_space",
    "regret_report",
    "save_report",
    "scenario_space",
    "successive_halving",
]
