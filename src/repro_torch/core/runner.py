"""One transfer end to end: partition -> tune -> schedule -> simulate."""
from __future__ import annotations

from typing import List, Optional, Sequence

from .baselines import GlobusOnlineScheduler, StaticParamsScheduler, UntunedScheduler
from .chunking import partition_files
from .params import assign_chunk_params
from .schedulers import SCHEDULERS, Scheduler, make_scheduler
from .simulator import SimResult, Simulation
from .types import Chunk, ChunkType, FileSpec, NetworkSpec, TransferParams

ALGORITHMS = tuple(SCHEDULERS) + ("globus", "untuned", "static")


def prepare_chunks(
    files: Sequence[FileSpec],
    network: NetworkSpec,
    num_chunks: int,
    max_cc: int,
) -> List[Chunk]:
    """Fig.-3 partitioning and Algorithm-1 parameters for each chunk."""
    chunks = partition_files(files, network, num_chunks)
    for c in chunks:
        assign_chunk_params(c, network, max_cc)
    return chunks


def build_scheduler(
    algorithm: str,
    files: Sequence[FileSpec],
    network: NetworkSpec,
    *,
    max_cc: int = 8,
    num_chunks: int = 2,
    **kw,
) -> Scheduler:
    algorithm = algorithm.lower()
    if algorithm == "static":
        params = kw.pop("static_params", None)
        if params is None:
            raise ValueError(
                "algorithm 'static' requires static_params="
                "TransferParams(...) (or a (pp, p, cc) tuple)"
            )
        if not isinstance(params, TransferParams):
            params = TransferParams(*params)
        # one undivided chunk at the caller's parameters: no partitioning,
        # no Algorithm 1
        chunks = [Chunk(ctype=ChunkType.ALL, files=list(files))]
        return StaticParamsScheduler(chunks, network, max_cc, params, **kw)
    if algorithm == "globus":
        chunks = prepare_chunks(files, network, 1, max_cc)
        return GlobusOnlineScheduler(chunks, network, max_cc, **kw)
    if algorithm == "untuned":
        chunks = prepare_chunks(files, network, 1, max_cc)
        return UntunedScheduler(chunks, network, max_cc)
    chunks = prepare_chunks(files, network, num_chunks, max_cc)
    return make_scheduler(algorithm, chunks, network, max_cc, **kw)


def run_transfer(
    files: Sequence[FileSpec],
    network: NetworkSpec,
    algorithm: str = "promc",
    *,
    max_cc: int = 8,
    num_chunks: int = 2,
    tick_period: float = 5.0,
    record_timeline: bool = False,
    max_time: Optional[float] = None,
    **scheduler_kw,
) -> SimResult:
    """Simulate one transfer end to end and return its SimResult."""
    sched = build_scheduler(
        algorithm,
        files,
        network,
        max_cc=max_cc,
        num_chunks=num_chunks,
        **scheduler_kw,
    )
    sim = Simulation(
        sched.chunks,
        sched.network,  # baselines may have degraded the path (GCP mode)
        sched,
        tick_period=tick_period,
        record_timeline=record_timeline,
        **({"max_time": max_time} if max_time else {}),
    )
    return sim.run()
