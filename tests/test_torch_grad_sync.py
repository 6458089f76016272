"""The port's gradient sync (``repro_torch.distributed.grad_sync``) and
compression (``repro_torch.distributed.compression``) against the
reference's on the CPU.

* ``build_sync_plan`` equals the reference's plan in every field (chunks:
  names, files, parameters; ``channel_alloc``, ``slicing``, ``order``,
  ``compress_by_class``, ``summary()``), and ``simulate_sync``'s total time
  is within 1e-12 relative of the reference's: on the fake gradients of
  ``tests/test_distributed.py``, the smoke-size gemma3-1b and
  deepseek-moe-16b parameter trees (stacked leaves: a list of the layers'
  tensors in the port, one (L, ...) array in the reference), under ``sc``,
  ``mc``, ``promc``, both compression tables and 2 or 4 chunks.
* ``int8_encode`` / ``bf16_roundtrip`` / ``compression_error`` against
  the reference's on seeded inputs: ``q`` and ``scale`` exact, the
  residual within 1e-7 (absolute).
* ``apply_sync`` on 2 and 4 gloo ranks (spawned processes) for each codec
  and algorithm on seeded per-rank gradients, against a numpy computation
  of the reference's ``_psum_one`` on the same operands: exact for ``none``
  / ``bf16`` at 2 ranks, within 1e-6 of each leaf's largest magnitude
  otherwise; every rank's result bit for bit the others'; ``sc`` / ``mc`` /
  ``promc`` bit for bit ``naive_sync`` at 2 ranks; issuing one collective
  at a time bit for bit the plan's window of ``max_cc``; int8 error
  feedback threaded for whole leaves only. ~30 s.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.distributed import compression as ref_compression
from repro.distributed import grad_sync as ref_grad_sync
from repro.models.config import reduce_for_smoke as ref_reduce_for_smoke
from repro.models.model import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.core import testbeds
from repro_torch.core.types import KB, ChunkType
from repro_torch.distributed import compression, grad_sync
from repro_torch.models.config import reduce_for_smoke
from repro_torch.models.model import build_model, leaf_paths
from torch_ranks import run_ranks

ALGORITHMS = ("sc", "mc", "promc")
TABLES = {"default": None, "none": "NO_COMPRESSION"}

# ------------------------------------------------------------------ #
# the plan and its simulation against the reference's
# ------------------------------------------------------------------ #

FAKE = {"layers": {"w_big": (64, 4096, 4096), "w_mid": (64, 512, 512), "norm": (64, 4096)},
        "embed": {"tok": (32000, 4096)}}


def _ref_fake():
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32), FAKE,
                        is_leaf=lambda n: isinstance(n, tuple))


def _port_fake():
    return {k: {n: torch.empty(s, device="meta") for n, s in v.items()} for k, v in FAKE.items()}


def _model_trees(arch):
    ref = jax.eval_shape(ref_build_model(ref_reduce_for_smoke(ref_get_config(arch))).init,
                         jax.random.PRNGKey(0))
    port = build_model(reduce_for_smoke(get_config(arch)), device="meta").param_tree()
    return ref, port


TREES = {"fake": lambda: (_ref_fake(), _port_fake()),
         "gemma3-1b": lambda: _model_trees("gemma3-1b"),
         "deepseek-moe-16b": lambda: _model_trees("deepseek-moe-16b")}
_cache = {}


def trees(name):
    if name not in _cache:
        _cache[name] = TREES[name]()
    return _cache[name]


def _table(which, module):
    return None if TABLES[which] is None else getattr(module, TABLES[which])


def plan_fields(plan):
    """Every field of a plan as plain values (the two packages' enums and
    dataclasses are their own)."""
    return {
        "network": plan.network.name, "algorithm": plan.algorithm, "max_cc": plan.max_cc,
        "chunks": [(c.name, int(c.ctype), [(f.name, f.size) for f in c.files],
                    (c.params.pipelining, c.params.parallelism, c.params.concurrency))
                   for c in plan.chunks],
        "channel_alloc": dict(plan.channel_alloc),
        "order": [(i.path, i.slice_idx, i.n_slices, i.bytes, int(i.chunk_type), i.compress)
                  for i in plan.order],
        "slicing": dict(plan.slicing),
        "compress_by_class": {int(k): v for k, v in plan.compress_by_class.items()},
        "summary": plan.summary(),
    }


CASES = [(tree, alg, table, nc) for tree in TREES for alg in ALGORITHMS for table in TABLES
         for nc in (2, 4)]


@pytest.mark.parametrize("tree,algorithm,table,num_chunks", CASES)
def test_plan_equals_the_reference(tree, algorithm, table, num_chunks):
    ref_tree, port_tree = trees(tree)
    want = ref_grad_sync.build_sync_plan(ref_tree, algorithm=algorithm, num_chunks=num_chunks,
                                         compress_by_class=_table(table, ref_grad_sync))
    got = grad_sync.build_sync_plan(port_tree, algorithm=algorithm, num_chunks=num_chunks,
                                    compress_by_class=_table(table, grad_sync))
    got, want = plan_fields(got), plan_fields(want)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    if tree == "fake":  # the fake tree's huge leaves are sliced and compressed
        assert max(want["slicing"].values()) > 1
        assert table == "none" or any(i[5] == "bf16" for i in want["order"])


@pytest.mark.parametrize("tree,algorithm,table,num_chunks", CASES)
def test_simulate_sync_equals_the_reference(tree, algorithm, table, num_chunks):
    ref_tree, port_tree = trees(tree)
    want = ref_grad_sync.simulate_sync(ref_tree, algorithm=algorithm, num_chunks=num_chunks,
                                       compress_by_class=_table(table, ref_grad_sync))
    got = grad_sync.simulate_sync(port_tree, algorithm=algorithm, num_chunks=num_chunks,
                                  compress_by_class=_table(table, grad_sync))
    assert got.total_time > 0
    assert abs(got.total_time - want.total_time) <= 1e-12 * want.total_time


def test_plan_flattens_stacked_leaves_as_the_reference():
    """A stacked leaf is one file of the reference's (L, ...) bytes, named
    by its path; a list node of dicts is indexed."""
    ref_tree, port_tree = trees("gemma3-1b")
    want = [(p, int(np.prod(leaf.shape)) * 4) for p, leaf in
            ref_grad_sync.flatten_with_paths(ref_tree)]
    got = [(p, grad_sync.leaf_bytes(leaf)) for p, leaf in
           leaf_paths(port_tree)]
    assert got == want
    assert any(isinstance(leaf, list) for _, leaf in leaf_paths(port_tree))


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError, match="unknown sync algorithm"):
        grad_sync.build_sync_plan(_port_fake(), algorithm="fastest")


# ------------------------------------------------------------------ #
# compression against the reference's
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("shape", [(1024,), (64, 33)])
@pytest.mark.parametrize("magnitude", [1e-3, 1.0, 1e3])
@pytest.mark.parametrize("with_ef", [False, True])
def test_int8_encode_equals_the_reference(shape, magnitude, with_ef):
    rng = np.random.default_rng(int(magnitude * 1e3) + len(shape))
    g = (rng.standard_normal(shape) * magnitude).astype(np.float32)
    ef = (rng.standard_normal(shape) * magnitude * 1e-2).astype(np.float32) if with_ef else None
    q, scale, res = ref_compression.int8_encode(jnp.asarray(g),
                                                None if ef is None else jnp.asarray(ef))
    got_q, got_scale, got_res = compression.int8_encode(
        torch.from_numpy(g), None if ef is None else torch.from_numpy(ef))
    assert got_q.dtype == torch.int8 and got_scale.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(q))
    assert got_scale.item() == float(scale)
    np.testing.assert_allclose(got_res.numpy(), np.asarray(res), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(
        compression.int8_decode(got_q.to(torch.int32), got_scale).numpy(),
        np.asarray(ref_compression.int8_decode(q.astype(jnp.int32), scale)))


@pytest.mark.parametrize("codec", ["bf16", "int8", "none"])
def test_compression_error_and_roundtrip_equal_the_reference(codec):
    g = (np.random.default_rng(7).standard_normal(4096) * 3).astype(np.float32)
    want = float(ref_compression.compression_error(jnp.asarray(g), codec))
    got = float(compression.compression_error(torch.from_numpy(g), codec))
    assert got == pytest.approx(want, rel=1e-5, abs=0)
    np.testing.assert_array_equal(compression.bf16_roundtrip(torch.from_numpy(g)).numpy(),
                                  np.asarray(ref_compression.bf16_roundtrip(jnp.asarray(g))))


def test_int8_error_feedback_reduces_bias():
    """The reference's test: with error feedback the average of 20
    quantized copies converges to the gradient."""
    g = torch.from_numpy((np.random.default_rng(0).standard_normal(1024) * 1e-3).astype(np.float32))
    ef, acc = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(20):
        q, s, ef = compression.int8_encode(g, ef)
        acc = acc + compression.int8_decode(q.to(torch.int32), s)
    err_ef = float(torch.linalg.vector_norm(acc / 20 - g) / torch.linalg.vector_norm(g))
    q, s, _ = compression.int8_encode(g)
    err_once = float(torch.linalg.vector_norm(compression.int8_decode(q, s) - g)
                     / torch.linalg.vector_norm(g))
    assert err_ef < err_once * 0.5


# ------------------------------------------------------------------ #
# apply_sync over gloo ranks against the reference's arithmetic
# ------------------------------------------------------------------ #

#: a link on which this small tree has two size classes and slices: 1 MB
#: class threshold, 4 streams (BDP 1 MB / 256 KB windows), slicing from
#: 512 KB; `layers/w` (8 layers) splits into 4 runs of 2 layers, `embed/tok`
#: into 4 blocks of 128 rows
NET = dataclasses.replace(testbeds.DCN, name="test-link", bandwidth=2e7, rtt=0.05,
                          buffer_size=256 * KB)
LAYERS = 8
SHAPES = {"embed/tok": (512, 640), "layers/w": (LAYERS, 128, 320), "layers/b": (LAYERS, 320),
          "layers/norm": (LAYERS, 64), "head/scale": (7,)}
CODECS = {"none": grad_sync.NO_COMPRESSION, "bf16": None,
          "int8": grad_sync.compress_table(True, "int8")}
ALL_INT8 = {t: "int8" for t in ChunkType}


def rank_grads(rank: int) -> dict:
    """Seeded per-rank gradients, path -> fp32 array (reference layout);
    leaves of magnitudes from 1e-3 to 1e2."""
    out = {}
    for i, (path, shape) in enumerate(sorted(SHAPES.items())):
        rng = np.random.default_rng(1000 * rank + i)
        out[path] = (rng.standard_normal(shape) * 10.0 ** (i - 3)).astype(np.float32)
    return out


def to_tree(flat: dict) -> dict:
    """path -> array as the port's tree (stacked leaves as lists of layers)."""
    tree: dict = {}
    for path, x in flat.items():
        a, b = path.split("/")
        t = torch.from_numpy(np.array(x))
        tree.setdefault(a, {})[b] = list(t.unbind(0)) if a == "layers" else t
    return tree


def from_tree(tree: dict) -> dict:
    out = {}
    for path, leaf in leaf_paths(tree):
        out[path] = (torch.stack(leaf) if isinstance(leaf, list) else leaf).numpy().copy()
    return out


def make_plan(algorithm, table, max_cc=8):
    shapes = to_tree({p: np.zeros(s, np.float32) for p, s in SHAPES.items()})
    return grad_sync.build_sync_plan(shapes, network=NET, algorithm=algorithm,
                                     compress_by_class=table, max_cc=max_cc)


def sync_worker(pods):
    """Every codec x algorithm on this rank's gradients, naive_sync, the
    plan one collective at a time, and int8 with error feedback."""
    grads = rank_grads(pods.rank)
    out, reports = {}, {}
    for codec, table in CODECS.items():
        for alg in ALGORITHMS:
            report = grad_sync.SyncReport()
            synced, ef = grad_sync.apply_sync(make_plan(alg, table), to_tree(grads), report=report)
            assert ef is None
            out[codec, alg] = from_tree(synced)
            reports[codec, alg] = report
    one = grad_sync.SyncReport()
    synced, _ = grad_sync.apply_sync(make_plan("promc", None, max_cc=1), to_tree(grads),
                                     report=one)
    out["one_at_a_time"] = from_tree(synced)
    reports["one_at_a_time"] = one
    out["naive"] = from_tree(grad_sync.naive_sync(to_tree(grads)))
    ef_in = {p: (x * 1e-2).astype(np.float32) for p, x in rank_grads(pods.rank + 50).items()}
    synced, ef = grad_sync.apply_sync(make_plan("promc", ALL_INT8), to_tree(grads),
                                      ef_state=to_tree(ef_in))
    out["ef"] = (from_tree(synced), from_tree(ef))
    return out, {k: dataclasses.asdict(r) for k, r in reports.items()}


_runs = {}


def synced_by_rank(world, tmp_path_factory):
    if world not in _runs:
        _runs[world] = run_ranks(sync_worker, world, tmp_path_factory.mktemp(f"sync{world}"))
    return _runs[world]


def bf16_np(x: np.ndarray) -> np.ndarray:
    """fp32 -> bf16 (round to nearest even) -> fp32, in numpy."""
    bits = x.astype(np.float32).view(np.uint32)
    rounded = (bits + np.uint32(0x7FFF) + ((bits >> 16) & 1)) & np.uint32(0xFFFF0000)
    return rounded.view(np.float32)


def int8_encode_np(gf: np.ndarray):
    scale = np.float32(np.maximum(np.max(np.abs(gf)), np.float32(1e-30)) / np.float32(127.0))
    q = np.clip(np.round(gf / scale), -127, 127).astype(np.int8)
    return q, scale, gf - q.astype(np.float32) * scale


def psum_one_np(operands, compress):
    """The reference's ``_psum_one`` on each rank's operand, in numpy (fp32,
    sums in rank order)."""
    n = np.float32(len(operands))
    if compress == "none":
        parts = operands
    elif compress == "bf16":
        parts = [bf16_np(g) for g in operands]
    else:
        parts = []
        for g in operands:
            q, s, _ = int8_encode_np(g)
            parts.append(q.astype(np.float32) * s)
    acc = parts[0].copy()
    for p in parts[1:]:
        acc = acc + p
    return acc / n


def mirror(plan, grads_by_rank) -> dict:
    out = {p: np.empty(s, np.float32) for p, s in SHAPES.items()}
    for item in plan.order:
        n0 = SHAPES[item.path][0] // item.n_slices
        sl = slice(None) if item.n_slices == 1 else slice(item.slice_idx * n0,
                                                          (item.slice_idx + 1) * n0)
        out[item.path][sl] = psum_one_np([g[item.path][sl] for g in grads_by_rank],
                                         item.compress)
    return out


def assert_same_bits(a: dict, b: dict, what):
    assert a.keys() == b.keys()
    for p in a:
        assert a[p].dtype == b[p].dtype and a[p].shape == b[p].shape, (what, p)
        assert a[p].tobytes() == b[p].tobytes(), (what, p)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_apply_sync_matches_the_reference_arithmetic(world, codec, algorithm, tmp_path_factory):
    by_rank = synced_by_rank(world, tmp_path_factory)
    got = by_rank[0][0][codec, algorithm]
    for r in range(1, world):
        assert_same_bits(by_rank[r][0][codec, algorithm], got, f"rank {r}")
    plan = make_plan(algorithm, CODECS[codec])
    want = mirror(plan, [rank_grads(r) for r in range(world)])
    if codec != "none":
        assert {i.compress for i in plan.order} == {"none", codec}
    for p in SHAPES:
        if world == 2 and codec in ("none", "bf16"):
            np.testing.assert_array_equal(got[p], want[p], err_msg=p)
        else:
            err = np.abs(got[p] - want[p]).max()
            assert err <= 1e-6 * np.abs(want[p]).max(), (p, err)
    report = by_rank[0][1][codec, algorithm]
    assert report["collectives"] == len(plan.order) + sum(i.compress == "int8" for i in plan.order)
    assert 1 < report["max_outstanding"] <= plan.max_cc
    assert set(report["wire_bytes"]) == {i.compress for i in plan.order}


@pytest.mark.parametrize("world", [2, 4])
def test_plans_equal_naive_sync_and_one_at_a_time(world, tmp_path_factory):
    """Uncompressed sc / mc / promc bit for bit naive_sync at 2 ranks (at 4
    the all-reduce's order may differ between a leaf and its slices); one
    collective at a time bit for bit the window of max_cc at any width."""
    by_rank = synced_by_rank(world, tmp_path_factory)
    for r in range(world):
        res = by_rank[r][0]
        if world == 2:
            for alg in ALGORITHMS:
                assert_same_bits(res["none", alg], res["naive"], alg)
        assert_same_bits(res["one_at_a_time"], res["bf16", "promc"], "max_cc 1")
        assert by_rank[r][1]["one_at_a_time"]["max_outstanding"] == 1


@pytest.mark.parametrize("world", [2, 4])
def test_error_feedback_threads_whole_leaves_only(world, tmp_path_factory):
    by_rank = synced_by_rank(world, tmp_path_factory)
    plan = make_plan("promc", ALL_INT8)
    sliced = {p for p, n in plan.slicing.items() if n > 1}
    assert sliced and sliced != set(SHAPES)
    grads = [rank_grads(r) for r in range(world)]
    for r in range(world):
        synced, ef = by_rank[r][0]["ef"]
        ef_in = {p: (x * 1e-2).astype(np.float32) for p, x in rank_grads(r + 50).items()}
        for p in SHAPES:
            if p in sliced:  # the given residual back, untouched
                np.testing.assert_array_equal(ef[p], ef_in[p], err_msg=p)
                continue
            _, _, res = int8_encode_np(grads[r][p] + ef_in[p])
            np.testing.assert_allclose(ef[p], res, rtol=0, atol=1e-7 * np.abs(grads[r][p]).max(),
                                       err_msg=p)
            # the synced leaf: each rank's gradient plus its residual, quantized
            ops = [grads[k][p] + (rank_grads(k + 50)[p] * 1e-2).astype(np.float32)
                   for k in range(world)]
            want = psum_one_np(ops, "int8")
            assert np.abs(synced[p] - want).max() <= 1e-6 * np.abs(want).max(), p
        assert_same_bits(synced, by_rank[0][0]["ef"][0], f"rank {r}")
