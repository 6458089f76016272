"""The port's threaded transfer engine (``repro_torch.core.engine``) on real
files: the reference's engine cases (``tests/test_core_engine.py``) on the
port, and the port against the reference on the same file sets: the
chunks ``prepare_chunks`` makes (partition and Algorithm-1 parameters) and
what each engine run moves (files, bytes, bytes a chunk). Wall time and
the number of channel moves depend on thread timing and are not compared.
~15 s on one CPU core."""
from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import pytest

from repro.core import prepare_chunks as ref_prepare_chunks
from repro.core import testbeds as ref_testbeds
from repro.core.engine import TransferEngine as RefTransferEngine
from repro.core.engine import file_task as ref_file_task
from repro.core.schedulers import make_scheduler as ref_make_scheduler
from repro.core.types import FileSpec as RefFileSpec
from repro_torch.core import testbeds
from repro_torch.core.engine import TransferEngine, bytes_task, file_task
from repro_torch.core.runner import prepare_chunks
from repro_torch.core.schedulers import make_scheduler
from repro_torch.core.types import MB, Chunk, ChunkType, FileSpec, TransferParams

ALGORITHMS = ["sc", "mc", "promc"]


def _make_files(tmp_path, sizes, tag="src"):
    """Files of deterministic pseudo-random contents (the reference test's
    generator); returns (specs, {name: src path}, dst dir)."""
    src_dir, dst_dir = tmp_path / tag, tmp_path / f"{tag}_dst"
    src_dir.mkdir()
    dst_dir.mkdir()
    specs, paths = [], {}
    rng_state = 1234
    for i, size in enumerate(sizes):
        name = f"f{i:03d}"
        blocks, remaining = [], size
        while remaining > 0:
            rng_state = (rng_state * 6364136223846793005 + 1442695040888963407) % (1 << 64)
            blk = rng_state.to_bytes(8, "little") * 1024  # 8 KB
            blocks.append(blk[: min(len(blk), remaining)])
            remaining -= len(blocks[-1])
        (src_dir / name).write_bytes(b"".join(blocks))
        specs.append(FileSpec(name=name, size=size, path=str(src_dir / name)))
        paths[name] = str(src_dir / name)
    return specs, paths, dst_dir


def _digest(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(1 << 20)
            if not b:
                return h.hexdigest()
            h.update(b)


def _copy_tasks(specs, paths, dst_dir, make=file_task):
    return {s.name: make(s, paths[s.name], str(dst_dir / s.name)) for s in specs}


def _chunk_summary(chunks):
    return [(c.ctype.name, [(f.name, f.size) for f in c.files],
             (c.params.pipelining, c.params.parallelism, c.params.concurrency))
            for c in chunks]


def _report_summary(report):
    return report.files_done, report.total_bytes, report.per_chunk_bytes


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_engine_copies_everything_bit_exact(tmp_path, algo):
    net = testbeds.LAN
    sizes = [256 * 1024] * 6 + [8 * MB] * 2  # small + stripeable files
    specs, paths, dst_dir = _make_files(tmp_path, sizes)
    chunks = prepare_chunks(specs, net, 2, max_cc=4)
    sched = make_scheduler(algo, chunks, net, 4)
    report = TransferEngine(net, tick_period=0.05).run(chunks, sched,
                                                       _copy_tasks(specs, paths, dst_dir))
    assert report.files_done == len(specs)
    assert report.total_bytes == sum(sizes)
    for s in specs:
        assert _digest(dst_dir / s.name) == _digest(paths[s.name])


def test_engine_striped_write_is_correct(tmp_path):
    """parallelism > 1 stripes one big file across sub-threads."""
    net = testbeds.XSEDE  # BDP 75MB > buf 32MB -> Alg. 1 picks parallelism 3
    specs, paths, dst_dir = _make_files(tmp_path, [96 * MB])
    chunks = prepare_chunks(specs, net, 1, max_cc=2)
    assert chunks[0].params.parallelism >= 2
    sched = make_scheduler("mc", chunks, net, 2)
    TransferEngine(net, tick_period=0.05).run(chunks, sched, _copy_tasks(specs, paths, dst_dir))
    assert _digest(dst_dir / "f000") == _digest(paths["f000"])


def test_engine_bytes_task(tmp_path):
    payload = os.urandom(3 * MB)
    spec = FileSpec(name="shard0", size=len(payload))
    dst = tmp_path / "shard0.bin"
    task = bytes_task(spec, payload, str(dst))
    net = testbeds.CKPT_STORE
    chunks = prepare_chunks([spec], net, 1, max_cc=2)
    sched = make_scheduler("mc", chunks, net, 2)
    TransferEngine(net, tick_period=0.02).run(chunks, sched, {"shard0": task})
    assert dst.read_bytes() == payload


def test_task_holds_one_destination_fd_for_lifetime(tmp_path, monkeypatch):
    """The destination is opened once a task (not once a ``pwrite``) and the
    fd is released by ``finalize``."""
    opens = []
    real_open = os.open

    def counting_open(path, *a, **kw):
        fd = real_open(path, *a, **kw)
        opens.append(str(path))
        return fd

    monkeypatch.setattr(os, "open", counting_open)
    payload = os.urandom(5 * MB)
    dst = tmp_path / "out.bin"
    task = bytes_task(FileSpec(name="x", size=len(payload)), payload, str(dst))
    for off in range(0, len(payload), MB):
        task.write(off, payload[off: off + MB])
    assert opens.count(str(dst)) == 1
    task.finalize()
    assert dst.read_bytes() == payload
    # after finalize the fd is closed; a fresh write reopens exactly once
    task.write(0, b"y")
    task.finalize()
    assert opens.count(str(dst)) == 2


def test_engine_latency_injection_pipelining_speedup(tmp_path):
    """With injected control latency, pipelining visibly cuts wall time:
    the paper's mechanism on the real engine."""
    net = dataclasses.replace(testbeds.LAN, rtt=0.03, unhidden_overhead=0.0)
    specs, paths, dst_dir = _make_files(tmp_path, [64 * 1024] * 20)
    tasks = _copy_tasks(specs, paths, dst_dir)

    def run_with(pp):
        chunk = Chunk(ctype=ChunkType.ALL, files=list(specs),
                      params=TransferParams(pipelining=pp, parallelism=1, concurrency=1))
        sched = make_scheduler("mc", [chunk], net, 1)
        sched.chunks[0].params = chunk.params  # keep fixed params
        eng = TransferEngine(net, tick_period=0.05, inject_latency=True)
        return eng.run([chunk], sched, tasks).total_time

    slow = run_with(0)
    fast = run_with(9)
    assert fast < slow  # 30 ms a file's gap against 3 ms


def _checkpoint_sizes():
    """The .npy sizes of a gemma3-1b train state at full width: the 11
    parameter leaves, their two AdamW moments (fp32), count and step."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model, tree_leaves

    model = build_model(get_config("gemma3-1b"), device="meta")
    shapes = tree_leaves(model.param_shapes(), lambda n: isinstance(n, tuple))
    header = 128  # np.save's v1.0 header at these shapes
    sizes = [header + 4 * int(np.prod(s)) for s in shapes.values()] * 3
    return sizes + [header + 4, header + 4]


FILE_SETS = {
    "mixed": [256 * 1024] * 6 + [8 * MB] * 2 + [3 * MB, 40 * 1024, 96 * MB],
    "checkpoint": _checkpoint_sizes(),
}


@pytest.mark.parametrize("net_name", ["didclab-lan-glusterfs", "xsede-lonestar-gordon",
                                      "ckpt-object-store"])
@pytest.mark.parametrize("file_set", list(FILE_SETS))
@pytest.mark.parametrize("num_chunks,max_cc", [(1, 2), (2, 4), (4, 8)])
def test_prepare_chunks_matches_the_reference(net_name, file_set, num_chunks, max_cc):
    sizes = FILE_SETS[file_set]
    specs = [FileSpec(name=f"f{i:03d}", size=s) for i, s in enumerate(sizes)]
    ref_specs = [RefFileSpec(name=f"f{i:03d}", size=s) for i, s in enumerate(sizes)]
    ours = prepare_chunks(specs, testbeds.TESTBEDS[net_name], num_chunks, max_cc)
    theirs = ref_prepare_chunks(ref_specs, ref_testbeds.TESTBEDS[net_name], num_chunks, max_cc)
    assert _chunk_summary(ours) == _chunk_summary(theirs)


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_engine_moves_what_the_reference_engine_moves(tmp_path, algo):
    """The same file set copied by both engines under the same controller:
    files, bytes and bytes a chunk equal; both copies bit for bit."""
    net_name, max_cc = "ckpt-object-store", 4
    sizes = [256 * 1024] * 5 + [6 * MB] * 2 + [40 * 1024]
    specs, paths, dst_dir = _make_files(tmp_path, sizes)
    ref_dst = tmp_path / "ref_dst"
    ref_dst.mkdir()
    ref_specs = [RefFileSpec(name=s.name, size=s.size, path=s.path) for s in specs]

    chunks = prepare_chunks(specs, testbeds.TESTBEDS[net_name], 2, max_cc)
    ours = TransferEngine(testbeds.TESTBEDS[net_name], tick_period=0.05).run(
        chunks, make_scheduler(algo, chunks, testbeds.TESTBEDS[net_name], max_cc),
        _copy_tasks(specs, paths, dst_dir))
    ref_net = ref_testbeds.TESTBEDS[net_name]
    ref_chunks = ref_prepare_chunks(ref_specs, ref_net, 2, max_cc)
    theirs = RefTransferEngine(ref_net, tick_period=0.05).run(
        ref_chunks, ref_make_scheduler(algo, ref_chunks, ref_net, max_cc),
        _copy_tasks(ref_specs, paths, ref_dst, make=ref_file_task))
    assert _report_summary(ours) == _report_summary(theirs)
    assert ours.scheduler == theirs.scheduler
    for s in specs:
        assert _digest(dst_dir / s.name) == _digest(ref_dst / s.name) == _digest(paths[s.name])
