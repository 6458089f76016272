"""Declarative scenario matrix: (testbed x dataset x scheduler x maxCC).

A :class:`Scenario` is a pure value: every dataset generator is seeded
from the scenario itself, so a scenario names the same file set on every
machine. :func:`default_matrix` (276 rows) crosses the paper's six WAN
testbeds with scaled paper datasets and the five schedulers plus a maxCC
sweep; :func:`full_matrix` (1116 rows) widens it with impaired-path and
time-varying testbeds and heavy-tail / small-file-swarm datasets;
:func:`smoke_matrix` (32 rows) is a cross-section of the default grid.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import testbeds
from repro_torch.core.runner import build_scheduler
from repro_torch.core.simulator import Simulation
from repro_torch.core.types import GB, MB, FileSpec, param_triple
from repro_torch.data import filesets

#: name -> builder(seed) -> list[FileSpec], scaled to tens of files
DATASET_BUILDERS: Dict[str, Callable[[int], List[FileSpec]]] = {
    "des": lambda seed: filesets.dark_energy_survey(scale=0.05, seed=seed),
    "genome": lambda seed: filesets.genome_sequencing(scale=0.0004, seed=seed),
    "mixed": lambda seed: filesets.mixed_dataset(scale=0.008, seed=seed),
    "small_dominated": lambda seed: filesets.small_dominated_mixed(
        scale=0.006, seed=seed
    ),
    "uniform_small": lambda seed: filesets.uniform_files(40, 4 * MB),
    "uniform_huge": lambda seed: filesets.uniform_files(6, 8 * GB),
    "heavy_tail": lambda seed: filesets.heavy_tail_dataset(
        scale=0.012, seed=seed
    ),
    "small_file_swarm": lambda seed: filesets.small_file_swarm(
        scale=0.004, seed=seed
    ),
}

#: the paper's physical WAN testbeds (Tables 1-2); pinned by the goldens
NETWORKS: Sequence[str] = (
    testbeds.XSEDE.name,
    testbeds.LONI.name,
    testbeds.BLUEWATERS_STAMPEDE.name,
    testbeds.STAMPEDE_COMET.name,
    testbeds.SUPERMIC_BRIDGES.name,
    testbeds.LAN.name,
)

#: paper testbeds + the impaired-path variants of the full grid
EXTENDED_NETWORKS: Sequence[str] = NETWORKS + (
    testbeds.LOSSY_TRANSATLANTIC.name,
    testbeds.JITTERY_OVERLAY.name,
    testbeds.ASYM_CONTROL_PATH.name,
)

#: time-varying-capacity variants (step / ramp bandwidth profiles)
TIME_VARYING_NETWORKS: Sequence[str] = (
    testbeds.STEPPY_BACKBONE.name,
    testbeds.RAMPY_EVENING.name,
)

#: datasets of the golden-pinned default and smoke grids
CORE_DATASETS: Sequence[str] = (
    "des", "genome", "mixed", "small_dominated", "uniform_small",
    "uniform_huge",
)

ALGORITHMS: Sequence[str] = ("sc", "mc", "promc", "globus", "untuned")

#: reserved separator of :attr:`Scenario.name`
NAME_SEP = "|"


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One point of the evaluation matrix. Hash-stable and JSON-friendly."""

    network: str  # key into testbeds.TESTBEDS
    dataset: str  # key into DATASET_BUILDERS
    algorithm: str  # sc | mc | promc | globus | untuned | static
    max_cc: int = 8
    num_chunks: int = 4
    tick_period: float = 5.0
    seed: int = 0
    #: record the (t, aggregate rate) timeline into the fixed-budget ring
    record_timeline: bool = False
    #: fixed (pipelining, parallelism, concurrency) of ``static`` rows
    static_params: Optional[Tuple[int, int, int]] = None

    def __post_init__(self):
        for field in ("network", "dataset", "algorithm"):
            value = getattr(self, field)
            if NAME_SEP in value:
                raise ValueError(
                    f"scenario {field} {value!r} contains the reserved "
                    f"name separator {NAME_SEP!r}"
                )
        if (self.algorithm == "static") != (self.static_params is not None):
            raise ValueError(
                "static_params is required for algorithm 'static' and "
                f"reserved to it (got algorithm={self.algorithm!r}, "
                f"static_params={self.static_params!r})"
            )
        if self.static_params is not None:
            pp, par, cc = self.static_params
            if pp < 0 or par < 1 or cc < 1:
                raise ValueError(
                    f"invalid static_params {self.static_params!r}: need "
                    "pipelining >= 0, parallelism >= 1, concurrency >= 1"
                )

    @property
    def name(self) -> str:
        st = (
            "|pp{}.p{}.cc{}".format(*self.static_params)
            if self.static_params is not None
            else ""
        )
        tl = "|tl" if self.record_timeline else ""
        return (
            f"{self.network}|{self.dataset}|{self.algorithm}"
            f"|cc{self.max_cc}|k{self.num_chunks}|s{self.seed}{st}{tl}"
        )

    @property
    def dataset_seed(self) -> int:
        """Seed for the dataset generator: scenario-unique, order-free."""
        digest = hashlib.sha256(
            f"{self.dataset}:{self.seed}".encode("utf-8")
        ).digest()
        return int.from_bytes(digest[:4], "little")


#: bound on the files the built-fileset cache pins (matrix datasets hold
#: tens to hundreds of files each)
FILES_CACHE_MAX_FILES = 1 << 20

_files_cache: "OrderedDict[Tuple[str, int], tuple]" = OrderedDict()


def _build_files_cached(dataset: str, dataset_seed: int) -> tuple:
    """LRU over built file sets, bounded by the files it holds. Entries are
    immutable tuples of frozen FileSpecs shared by every caller."""
    key = (dataset, dataset_seed)
    entry = _files_cache.get(key)
    if entry is not None:
        _files_cache.move_to_end(key)
        return entry
    try:
        builder = DATASET_BUILDERS[dataset]
    except KeyError:
        raise ValueError(
            f"unknown dataset {dataset!r}; options: {sorted(DATASET_BUILDERS)}"
        ) from None
    entry = tuple(builder(dataset_seed))
    held = sum(len(e) for e in _files_cache.values())
    while _files_cache and held + len(entry) > FILES_CACHE_MAX_FILES:
        _, old = _files_cache.popitem(last=False)
        held -= len(old)
    _files_cache[key] = entry
    return entry


def build_files(scenario: Scenario) -> List[FileSpec]:
    """The scenario's dataset (deterministic in (dataset, seed)); the
    specs are shared through the cache, the list is fresh per call."""
    return list(_build_files_cached(scenario.dataset, scenario.dataset_seed))


def build_simulation(scenario: Scenario, record_timeline: Optional[bool] = None) -> Simulation:
    """Scenario -> a ready-to-run event Simulation with a fresh scheduler.
    ``record_timeline`` overrides the scenario's own flag when given."""
    network = testbeds.TESTBEDS[scenario.network]
    extra = (
        {"static_params": scenario.static_params}
        if scenario.static_params is not None
        else {}
    )
    sched = build_scheduler(
        scenario.algorithm,
        build_files(scenario),
        network,
        max_cc=scenario.max_cc,
        num_chunks=scenario.num_chunks,
        **extra,
    )
    if record_timeline is None:
        record_timeline = scenario.record_timeline
    return Simulation(
        sched.chunks,
        sched.network,  # baselines may degrade the path (GCP mode)
        sched,
        tick_period=scenario.tick_period,
        record_timeline=record_timeline,
    )


def default_matrix(seed: int = 0) -> List[Scenario]:
    """The golden-pinned grid: 6 networks x 6 core datasets x 5 schedulers
    (maxCC=8) = 180 rows, plus a maxCC sweep {1, 2, 4, 16} of MC and
    ProMC on two contrasting datasets = 96 more, 276 in all."""
    out: List[Scenario] = []
    for net in NETWORKS:
        for ds in CORE_DATASETS:
            for algo in ALGORITHMS:
                out.append(Scenario(network=net, dataset=ds, algorithm=algo, seed=seed))
    for net in NETWORKS:
        for ds in ("mixed", "uniform_huge"):
            for algo in ("mc", "promc"):
                for cc in (1, 2, 4, 16):
                    out.append(
                        Scenario(
                            network=net, dataset=ds, algorithm=algo,
                            max_cc=cc, seed=seed,
                        )
                    )
    return out


def full_matrix(seed: int = 0) -> List[Scenario]:
    """The 1116-row grid: 9 networks x 8 datasets x 5 schedulers x 2
    dataset seeds (720), a maxCC sweep of MC / ProMC on three datasets
    (216), a chunk-count sweep {1, 2, 3} of the tuned schedulers on the
    heavy-tail and swarm shapes (162), and a time-varying-bandwidth slice
    (18)."""
    out: List[Scenario] = []
    for s in (seed, seed + 1):
        for net in EXTENDED_NETWORKS:
            for ds in DATASET_BUILDERS:
                for algo in ALGORITHMS:
                    out.append(Scenario(network=net, dataset=ds, algorithm=algo, seed=s))
    for net in EXTENDED_NETWORKS:
        for ds in ("mixed", "uniform_huge", "heavy_tail"):
            for algo in ("mc", "promc"):
                for cc in (1, 2, 4, 16):
                    out.append(
                        Scenario(
                            network=net, dataset=ds, algorithm=algo,
                            max_cc=cc, seed=seed,
                        )
                    )
    for net in EXTENDED_NETWORKS:
        for ds in ("heavy_tail", "small_file_swarm"):
            for algo in ("sc", "mc", "promc"):
                for k in (1, 2, 3):
                    out.append(
                        Scenario(
                            network=net, dataset=ds, algorithm=algo,
                            num_chunks=k, seed=seed,
                        )
                    )
    for net in TIME_VARYING_NETWORKS:
        for ds in ("mixed", "heavy_tail", "uniform_huge"):
            for algo in ("sc", "mc", "promc"):
                out.append(Scenario(network=net, dataset=ds, algorithm=algo, seed=seed))
    return out


def expand_candidates(scenarios: Sequence[Scenario], candidates) -> List[Scenario]:
    """Expand a matrix along the autotuner's candidate axis: each scenario
    yields one ``static`` row per ``(pp, p, cc)`` candidate (a shared
    sequence, ``TransferParams`` accepted, or a callable ``scenario ->
    sequence``), scenario-major, candidate order kept. A candidate row
    moves exactly the bytes of its base scenario."""
    out: List[Scenario] = []
    for sc in scenarios:
        cands = candidates(sc) if callable(candidates) else candidates
        for params in cands:
            out.append(
                dataclasses.replace(
                    sc,
                    algorithm="static",
                    static_params=param_triple(params),
                    record_timeline=False,
                )
            )
    return out


def smoke_matrix(seed: int = 0) -> List[Scenario]:
    """A 32-row cross-section (every network, core dataset and scheduler
    appears) plus two cheap extremes."""
    out: List[Scenario] = []
    datasets = list(CORE_DATASETS)
    for i, net in enumerate(NETWORKS):
        for j, algo in enumerate(ALGORITHMS):
            ds = datasets[(i + j) % len(datasets)]
            out.append(Scenario(network=net, dataset=ds, algorithm=algo, seed=seed))
    out.append(
        Scenario(
            network=testbeds.LAN.name, dataset="uniform_small",
            algorithm="promc", max_cc=1, seed=seed,
        )
    )
    out.append(
        Scenario(
            network=testbeds.XSEDE.name, dataset="mixed",
            algorithm="mc", max_cc=16, seed=seed,
        )
    )
    return out
