"""Columnar scenario ingest: ``Scenario`` specs -> driver-ready columns.

Rows are grouped by **transfer context** ``(network, dataset,
dataset_seed, effective_chunks)``; each context's file set is built once
and partitioned with array ops (``np.searchsorted`` over the Fig.-3
thresholds), and its per-chunk columns are shared by every row of the
context. Per-row parameters go through the tensor kernels of
:mod:`repro_torch.eval.fabric.controllers` (Algorithm 1, the initial
allocations), run on the CPU in float64 and int64, whose arithmetic is
exact or correctly rounded, so the columns equal the reference
implementation's bit for bit. File sizes land in one flat ``qsizes``
buffer that rows address through per-row offsets.

This is host-side numpy; the driver uploads the columns to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import netmodel, testbeds
from repro_torch.core.baselines import GLOBUS_PRESETS, globus_class
from repro_torch.core.chunking import _CLASS_LABELS, size_thresholds
from repro_torch.core.params import MAX_PIPELINING
from repro_torch.core.types import (
    MC_ROUND_ROBIN_ORDER,
    PROMC_DELTA,
    ChunkType,
    NetworkSpec,
)

from .bucketing import bucket
from .controllers.alloc import round_robin_alloc, weighted_alloc
from .controllers.tuning import optimal_params, sc_chunk_order

#: algorithms the columnar path can ingest (the Scenario vocabulary)
PLAN_ALGORITHMS = frozenset({"sc", "mc", "promc", "globus", "untuned", "static"})

#: floor of the channel axis the driver sizes for plan rows
PLAN_C_FLOOR = 8

#: channel floor for batches holding profiled (time-varying) rows
PLAN_PROFILED_C_FLOOR = 16

#: shape-hint value that sorts profiled rows after all static ones
_PROFILED_HINT = 1 << 16

#: driver kind codes (``driver.KIND_*``)
_KIND_TRIVIAL, _KIND_STATIC, _KIND_SC, _KIND_MC, _KIND_PROMC = 0, 1, 2, 3, 4

_KIND_OF = {
    "sc": _KIND_SC,
    "mc": _KIND_MC,
    "promc": _KIND_PROMC,
    "static": _KIND_STATIC,
    "globus": _KIND_TRIVIAL,
    "untuned": _KIND_TRIVIAL,
}

#: (trivial_tick, trivial_complete) per kind: which controller callbacks
#: do nothing (SC/MC act on completions, ProMC also on ticks)
_TRIVIAL_OF = {
    _KIND_TRIVIAL: (True, True),
    _KIND_STATIC: (True, True),
    _KIND_SC: (True, False),
    _KIND_MC: (True, False),
    _KIND_PROMC: (False, False),
}

_SCHED_NAME_OF = {_KIND_SC: "SC", _KIND_MC: "MC", _KIND_PROMC: "ProMC"}

#: round-robin service rank by int ChunkType (Alg. 2 order H,S,L,M,A)
_RR_RANK_BY_CT = np.zeros(len(ChunkType), dtype=np.int64)
for _i, _ct in enumerate(MC_ROUND_ROBIN_ORDER):
    _RR_RANK_BY_CT[int(_ct)] = _i

#: ProMC delta weight by int ChunkType (Alg. 3)
_DELTA_BY_CT = np.array(
    [PROMC_DELTA[ChunkType(_i)] for _i in range(len(ChunkType))],
    dtype=np.int64,
)

#: Globus Online class presets as parallel (pp, p, cc) columns
_GLOBUS_CLASSES = ("small", "medium", "large")
_GLOBUS_PP = np.array([GLOBUS_PRESETS[c].pipelining for c in _GLOBUS_CLASSES], dtype=np.int64)
_GLOBUS_P = np.array([GLOBUS_PRESETS[c].parallelism for c in _GLOBUS_CLASSES], dtype=np.int64)
_GLOBUS_CC = np.array([GLOBUS_PRESETS[c].concurrency for c in _GLOBUS_CLASSES], dtype=np.int64)

#: pad-slot chunk type / round-robin rank: pads sort after every real chunk
_PAD_CTYPE = -(10**6)
_PAD_RANK = 10**6

#: (S,) and (S, K) numeric row columns, in dataclass order
ROW_COLUMNS = (
    "net_idx", "kind", "trivial_tick", "trivial_complete", "tick_period",
    "record_timeline", "max_cc", "eff_cc", "total_bytes", "n_files",
    "n_chunks", "cap_need", "qoff", "qlen", "queue_bytes", "avg_fs_k",
    "conc", "par", "cap_k", "fsdt", "sc_order", "open_n", "visit_rank",
)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@dataclasses.dataclass
class _Context:
    """One transfer context: the chunk columns its rows share."""

    net_idx: int
    n_chunks: int
    chunk_names: tuple
    total_bytes: int  # exact int byte total over all files
    n_files: int
    globus_avg: float  # unclamped avg file size (Globus preset class)
    qoff: np.ndarray
    qlen: np.ndarray
    chunk_total: np.ndarray
    ctype: np.ndarray


@dataclasses.dataclass
class ScenarioPlan:
    """Columnar scenario table padded to a shared chunk width ``K``; row
    order is input order. ``take(rows)`` slices a sub-plan that shares
    ``networks`` and ``qsizes``."""

    K: int
    networks: List[NetworkSpec]
    qsizes: np.ndarray  # flat f64 file-size buffer, shared by all rows
    names: List[str]
    sched_names: List[str]
    chunk_names: List[tuple]
    # (S,) row columns
    net_idx: np.ndarray
    kind: np.ndarray
    trivial_tick: np.ndarray
    trivial_complete: np.ndarray
    tick_period: np.ndarray
    record_timeline: np.ndarray
    max_cc: np.ndarray
    eff_cc: np.ndarray
    total_bytes: np.ndarray  # f64 (exact int values)
    n_files: np.ndarray
    n_chunks: np.ndarray
    cap_need: np.ndarray
    # (S, K) row-chunk columns
    qoff: np.ndarray
    qlen: np.ndarray
    queue_bytes: np.ndarray
    avg_fs_k: np.ndarray
    conc: np.ndarray
    par: np.ndarray
    cap_k: np.ndarray
    fsdt: np.ndarray
    sc_order: np.ndarray
    open_n: np.ndarray
    visit_rank: np.ndarray

    @property
    def n_rows(self) -> int:
        return len(self.names)

    def __len__(self) -> int:
        return self.n_rows

    def take(self, rows: Sequence[int]) -> "ScenarioPlan":
        idx = np.asarray(list(rows), dtype=np.int64)
        pick = lambda seq: [seq[int(i)] for i in idx]  # noqa: E731
        return ScenarioPlan(
            K=self.K,
            networks=self.networks,
            qsizes=self.qsizes,
            names=pick(self.names),
            sched_names=pick(self.sched_names),
            chunk_names=pick(self.chunk_names),
            **{c: getattr(self, c)[idx] for c in ROW_COLUMNS},
        )

    def cost_proxy(self) -> np.ndarray:
        """Cheap per-row event-count estimate for cost-homogeneous
        chunking: the transfer duration at the achievable rate in ticks,
        plus the file count."""
        nets = self.networks
        bw = np.array([n.bandwidth for n in nets], dtype=np.float64)
        sr = np.array([n.disk.streaming_rate for n in nets], dtype=np.float64)
        crc4 = np.array(
            [netmodel.channel_rate_cap(n, 4) for n in nets], dtype=np.float64
        )
        ni = self.net_idx
        est = np.minimum(
            np.minimum(bw[ni], sr[ni]),
            np.maximum(1, self.eff_cc) * crc4[ni],
        )
        duration = self.total_bytes / np.maximum(est, 1.0)
        return duration / np.maximum(self.tick_period, 1e-9) + self.n_files

    def shape_hints(self) -> List[int]:
        """Chunk-grouping keys for shape-homogeneous batches: the capacity
        bucket of each row's channel axis (floored at
        :data:`PLAN_C_FLOOR`), with all profiled rows in one trailing
        group."""
        plens = np.array(
            [len(n.bandwidth_profile or ((0.0, 1.0),)) for n in self.networks],
            dtype=np.int64,
        )[self.net_idx]
        return [
            _PROFILED_HINT if p > 1 else int(bucket(int(c), PLAN_C_FLOOR))
            for c, p in zip(self.eff_cc, plens)
        ]

    def arrays(self) -> Dict[str, np.ndarray]:
        """The plan as named numpy arrays (the format of
        :func:`from_reference_arrays`): every row column, ``qsizes``, and
        string arrays ``networks`` (N,), ``names`` / ``schedulers`` (S,),
        ``chunks`` (S, K) padded with ``""``, plus the all-False
        ``coupled`` (S,) column."""
        S = self.n_rows
        chunks = np.full((S, self.K), "", dtype=object)
        for i, row in enumerate(self.chunk_names):
            chunks[i, : len(row)] = row
        out = {c: getattr(self, c) for c in ROW_COLUMNS}
        out.update(
            qsizes=self.qsizes,
            networks=np.array([n.name for n in self.networks], dtype=object),
            names=np.array(self.names, dtype=object),
            schedulers=np.array(self.sched_names, dtype=object),
            chunks=chunks,
            coupled=np.zeros(S, dtype=bool),
        )
        return out


def from_reference_arrays(arrays: Dict[str, np.ndarray]) -> ScenarioPlan:
    """Build a plan from the numpy columns of another implementation's plan
    (the format of :meth:`ScenarioPlan.arrays`): networks are looked up by
    name in this package's ``TESTBEDS``. Coupled rows (shared fabrics) are
    outside this package and raise."""
    coupled = np.asarray(arrays.get("coupled", np.zeros(0, dtype=bool)))
    if coupled.any():
        raise NotImplementedError("coupled shared-fabric rows are not supported")
    missing = [c for c in ROW_COLUMNS + ("qsizes", "networks", "names",
               "schedulers", "chunks") if c not in arrays]
    if missing:
        raise KeyError(f"plan arrays lack columns {missing}")
    chunks = np.asarray(arrays["chunks"])
    return ScenarioPlan(
        K=int(chunks.shape[1]),
        networks=[testbeds.TESTBEDS[str(n)] for n in arrays["networks"]],
        qsizes=np.asarray(arrays["qsizes"], dtype=np.float64),
        names=[str(n) for n in arrays["names"]],
        sched_names=[str(n) for n in arrays["schedulers"]],
        chunk_names=[tuple(str(c) for c in row if c) for row in chunks],
        **{c: np.array(arrays[c]) for c in ROW_COLUMNS},
    )


def plan_supported(scenarios: Sequence) -> bool:
    """True when every scenario's algorithm has a columnar ingest."""
    return all(sc.algorithm.lower() in PLAN_ALGORITHMS for sc in scenarios)


def _effective_chunks(algorithm: str, num_chunks: int) -> int:
    # static/globus/untuned run one merged ALL chunk
    return 1 if algorithm in ("static", "globus", "untuned") else num_chunks


def _build_context(
    sc, net_idx: int, network: NetworkSpec, eff_chunks: int,
    size_chunks: List[np.ndarray], qsizes_len: int,
) -> Tuple[_Context, int]:
    """Partition one context's file set and append its sizes (chunk-major,
    file order preserved) to the flat buffer."""
    from ..scenarios import _build_files_cached

    files = _build_files_cached(sc.dataset, sc.dataset_seed)
    fsizes = np.array([f.size for f in files], dtype=np.int64)
    thresholds = np.asarray(
        size_thresholds(network.bandwidth, eff_chunks), dtype=np.float64
    )
    # class = first i with size <= thr[i]: searchsorted-left
    cls_idx = np.searchsorted(thresholds, fsizes, side="left")
    labels = _CLASS_LABELS[eff_chunks]
    qoff: List[int] = []
    qlen: List[int] = []
    totals: List[int] = []
    ctypes: List[int] = []
    names: List[str] = []
    off = qsizes_len
    for ci, label in enumerate(labels):
        members = np.flatnonzero(cls_idx == ci)
        if members.size == 0:
            continue  # empty size classes are dropped (Sec. 4.1)
        csizes = fsizes[members]
        size_chunks.append(csizes.astype(np.float64))
        qoff.append(off)
        qlen.append(int(members.size))
        totals.append(int(csizes.sum()))
        ctypes.append(int(label))
        names.append(ChunkType(label).name)
        off += int(members.size)
    total_all = int(fsizes.sum())
    ctx = _Context(
        net_idx=net_idx,
        n_chunks=len(qlen),
        chunk_names=tuple(names),
        total_bytes=total_all,
        n_files=len(files),
        globus_avg=total_all / len(files) if files else 1.0,
        qoff=np.array(qoff, dtype=np.int64),
        qlen=np.array(qlen, dtype=np.int64),
        chunk_total=np.array(totals, dtype=np.int64),
        ctype=np.array(ctypes, dtype=np.int64),
    )
    return ctx, off


def build_plan(scenarios: Sequence) -> ScenarioPlan:
    """Vectorized ingest of ``scenarios`` into a :class:`ScenarioPlan`: one
    context build per unique ``(network, dataset, dataset_seed,
    effective_chunks)``, everything per row as (S,) / (S, K) array math."""
    S = len(scenarios)
    networks: List[NetworkSpec] = []
    net_of: Dict[str, int] = {}
    contexts: List[_Context] = []
    ctx_of: Dict[tuple, int] = {}
    size_chunks: List[np.ndarray] = []
    qsizes_len = 0

    ctx_idx = np.zeros(S, dtype=np.int64)
    net_idx = np.zeros(S, dtype=np.int64)
    kind = np.zeros(S, dtype=np.int64)
    max_cc = np.zeros(S, dtype=np.int64)
    eff_cc = np.zeros(S, dtype=np.int64)
    tick_period = np.zeros(S, dtype=np.float64)
    record_timeline = np.zeros(S, dtype=bool)
    sp_pp = np.zeros(S, dtype=np.int64)
    sp_p = np.ones(S, dtype=np.int64)
    sp_cc = np.ones(S, dtype=np.int64)
    names: List[str] = [""] * S
    sched_names: List[str] = [""] * S
    chunk_names: List[tuple] = [()] * S

    for i, sc in enumerate(scenarios):
        alg = sc.algorithm.lower()
        if alg not in PLAN_ALGORITHMS:
            raise ValueError(f"no columnar ingest for algorithm {sc.algorithm!r}")
        if getattr(sc, "shared_fabric", None) is not None:
            raise NotImplementedError("coupled shared-fabric rows are not supported")
        n = net_of.get(sc.network)
        if n is None:
            n = net_of[sc.network] = len(networks)
            networks.append(testbeds.TESTBEDS[sc.network])
        eff_k = _effective_chunks(alg, sc.num_chunks)
        ckey = (sc.network, sc.dataset, sc.dataset_seed, eff_k)
        c = ctx_of.get(ckey)
        if c is None:
            ctx, qsizes_len = _build_context(
                sc, n, networks[n], eff_k, size_chunks, qsizes_len
            )
            c = ctx_of[ckey] = len(contexts)
            contexts.append(ctx)
        ctx_idx[i] = c
        net_idx[i] = n
        kd = _KIND_OF[alg]
        kind[i] = kd
        max_cc[i] = sc.max_cc
        tick_period[i] = sc.tick_period
        record_timeline[i] = sc.record_timeline
        names[i] = sc.name
        chunk_names[i] = contexts[c].chunk_names
        if alg == "static":
            pp, p, cc = sc.static_params
            sp_pp[i], sp_p[i], sp_cc[i] = pp, p, cc
            eff_cc[i] = cc
            sched_names[i] = f"Static(pp={pp},p={p},cc={cc})"
        elif alg == "untuned":
            sp_pp[i], sp_p[i], sp_cc[i] = 0, 1, 1
            eff_cc[i] = sc.max_cc
            sched_names[i] = "Untuned"
        elif alg == "globus":
            avg = contexts[c].globus_avg
            gi = _GLOBUS_CLASSES.index(globus_class(avg))
            sp_pp[i] = _GLOBUS_PP[gi]
            sp_p[i] = _GLOBUS_P[gi]
            sp_cc[i] = _GLOBUS_CC[gi]
            eff_cc[i] = sc.max_cc
            sched_names[i] = "GlobusOnline"
        else:
            eff_cc[i] = sc.max_cc
            sched_names[i] = _SCHED_NAME_OF[kd]

    qsizes = (
        np.concatenate(size_chunks) if size_chunks else np.zeros(0, dtype=np.float64)
    )

    # ---- context tables, padded to the shared chunk width K ---------- #
    n_ctx = len(contexts)
    K = bucket(max((c.n_chunks for c in contexts), default=1))
    c_qoff = np.zeros((n_ctx, K), dtype=np.int64)
    c_qlen = np.zeros((n_ctx, K), dtype=np.int64)
    c_total = np.zeros((n_ctx, K), dtype=np.int64)
    c_ctype = np.full((n_ctx, K), _PAD_CTYPE, dtype=np.int64)
    c_nk = np.zeros(n_ctx, dtype=np.int64)
    for j, ctx in enumerate(contexts):
        nk = ctx.n_chunks
        c_qoff[j, :nk] = ctx.qoff
        c_qlen[j, :nk] = ctx.qlen
        c_total[j, :nk] = ctx.chunk_total
        c_ctype[j, :nk] = ctx.ctype
        c_nk[j] = nk
    c_nonempty = np.arange(K)[None, :] < c_nk[:, None]
    # clamped per-chunk average file size (pads hold the neutral 1.0)
    c_avg = np.ones((n_ctx, K), dtype=np.float64)
    c_avg[c_nonempty] = np.maximum(
        c_total[c_nonempty].astype(np.float64)
        / c_qlen[c_nonempty].astype(np.float64),
        1.0,
    )
    # SC transfer order over padded ctypes (pads sort last), tail zeroed
    c_order = _np(sc_chunk_order(_t(c_ctype)))
    c_order = np.where(c_nonempty, c_order, 0)
    # MC round-robin rank / ProMC delta weight per chunk
    safe_ct = np.where(c_nonempty, c_ctype, 0)
    c_rank = np.where(c_nonempty, _RR_RANK_BY_CT[safe_ct], _PAD_RANK)
    c_weight = np.where(
        c_nonempty,
        _DELTA_BY_CT[safe_ct].astype(np.float64) * c_total.astype(np.float64),
        0.0,
    )

    # ---- gather context columns to rows ------------------------------ #
    qoff = c_qoff[ctx_idx]
    qlen = c_qlen[ctx_idx]
    queue_bytes = c_total[ctx_idx].astype(np.float64)
    avg_fs_k = c_avg[ctx_idx]
    sc_order = c_order[ctx_idx]
    nonempty = c_nonempty[ctx_idx]
    n_chunks = c_nk[ctx_idx]
    rank = c_rank[ctx_idx]
    weight = c_weight[ctx_idx]
    total_bytes = np.array(
        [float(contexts[c].total_bytes) for c in ctx_idx], dtype=np.float64
    )
    n_files = np.array([contexts[c].n_files for c in ctx_idx], dtype=np.int64)

    # ---- per-row network scalars ------------------------------------- #
    def net_col(f, dtype=np.float64):
        return np.array([f(n) for n in networks], dtype=dtype)[net_idx]

    bdp = net_col(lambda n: n.bdp)
    buf = net_col(lambda n: n.buffer_size)
    crtt = net_col(lambda n: n.control_rtt if n.control_rtt is not None else n.rtt)
    unhidden = net_col(lambda n: n.unhidden_overhead)
    pfo = net_col(lambda n: n.disk.per_file_overhead)
    # per-stream window rate and disk lane, with the scalar expressions of
    # NetworkSpec.stream_rate_cap / DiskSpec.channel_lane
    per_stream = net_col(
        lambda n: n.window_efficiency * n.buffer_size / max(n.rtt, 1e-9)
    )
    lane = net_col(lambda n: n.disk.channel_lane)
    msc = net_col(lambda n: n.max_streams_per_channel, np.int64)
    sco = net_col(lambda n: n.stream_cpu_overhead)
    bw = net_col(lambda n: n.bandwidth)

    # ---- Algorithm 1 over every (row, chunk) at once ----------------- #
    pp, par, conc = (
        _np(x)
        for x in optimal_params(
            _t(avg_fs_k),
            _t(bdp[:, None]),
            _t(buf[:, None]),
            _t(max_cc[:, None].astype(np.float64)),
            _t(qlen),
            MAX_PIPELINING,
        )
    )
    # static-parameter family: one merged chunk driven by the row triple
    static_like = kind <= _KIND_STATIC
    pp = np.where(static_like[:, None], sp_pp[:, None], pp)
    par = np.where(static_like[:, None], sp_p[:, None], par)
    conc = np.where(static_like[:, None], sp_cc[:, None], conc)
    # pad slots: born-done chunks hold zeros (parallelism 1)
    pp = np.where(nonempty, pp, 0)
    par = np.where(nonempty, par, 1)
    conc = np.where(nonempty, conc, 0)

    # serial per-file dead time (gap + unhidden + per-file disk overhead)
    gap = crtt[:, None] / (1.0 + pp.astype(np.float64))
    fsdt = np.where(nonempty, gap + unhidden[:, None] + pfo[:, None], 0.0)
    # channel rate cap: min(stream cap, disk lane)
    p_eff = np.maximum(1, np.minimum(par, msc[:, None]))
    stream_eff = 1.0 / (1.0 + sco[:, None] * (p_eff - 1))
    stream_cap = np.minimum(p_eff * per_stream[:, None] * stream_eff, bw[:, None])
    cap_k = np.where(nonempty, np.minimum(stream_cap, lane[:, None]), 0.0)

    # ---- initial channel allocation per controller kind -------------- #
    arangeK = np.arange(K)[None, :]
    # SC: one Open at the first chunk of the transfer order
    first = sc_order[:, :1]
    open_sc = np.where(arangeK == first, np.take_along_axis(conc, first, axis=1), 0)
    # MC: Alg.-2 round-robin split of maxCC over the service order
    open_mc = _np(round_robin_alloc(_t(rank), _t(nonempty), _t(max_cc)))
    # MC opens chunk by chunk in service order (rank, index): the
    # channel-column layout
    key = rank * K + arangeK
    rank_mc = np.sum(key[:, None, :] < key[:, :, None], axis=2)
    # ProMC: Alg.-3 delta-weighted split, opened in ascending chunk index
    open_promc = _np(
        weighted_alloc(_t(weight), _t(nonempty), _t(max_cc), trim_iters=K)
    )
    # static family: Open(chunk=0, n=cc)
    open_static = np.where(arangeK == 0, conc, 0)

    is_sc = kind == _KIND_SC
    is_mc = kind == _KIND_MC
    is_promc = kind == _KIND_PROMC
    # only SC rows read their transfer order
    sc_order = np.where(is_sc[:, None], sc_order, 0)
    open_n = np.where(
        is_sc[:, None],
        open_sc,
        np.where(
            is_mc[:, None], open_mc,
            np.where(is_promc[:, None], open_promc, open_static),
        ),
    ).astype(np.int64)
    visit_rank = np.where(
        is_mc[:, None], rank_mc, np.broadcast_to(arangeK, (S, K))
    ).astype(np.int64)

    # ---- closed-form bound on simultaneously open channels ----------- #
    # SC holds one chunk's wave at a time, MC/ProMC max(maxCC, n_chunks)
    # (transitions conserve the count), the static family its cc sum
    conc_real = np.where(nonempty, conc, 0)
    cap_sc = np.maximum(1, conc_real.max(axis=1, initial=0))
    cap_mc = np.maximum(np.maximum(1, max_cc), n_chunks)
    cap_static = np.maximum(1, conc_real.sum(axis=1))
    cap_need = np.where(
        is_sc, cap_sc, np.where(is_mc | is_promc, cap_mc, cap_static)
    ).astype(np.int64)

    trivial = np.array([_TRIVIAL_OF[int(k)] for k in kind], dtype=bool).reshape(S, 2)

    return ScenarioPlan(
        K=K,
        networks=networks,
        qsizes=qsizes,
        names=names,
        sched_names=sched_names,
        chunk_names=chunk_names,
        net_idx=net_idx,
        kind=kind,
        trivial_tick=trivial[:, 0],
        trivial_complete=trivial[:, 1],
        tick_period=tick_period,
        record_timeline=record_timeline,
        max_cc=max_cc,
        eff_cc=eff_cc,
        total_bytes=total_bytes,
        n_files=n_files,
        n_chunks=n_chunks,
        cap_need=cap_need,
        qoff=qoff,
        qlen=qlen,
        queue_bytes=queue_bytes,
        avg_fs_k=avg_fs_k,
        conc=conc,
        par=par,
        cap_k=cap_k,
        fsdt=fsdt,
        sc_order=sc_order,
        open_n=open_n,
        visit_rank=visit_rank,
    )
