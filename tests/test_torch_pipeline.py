"""The port's host data pipeline (``repro_torch.data.pipeline``): the
reference's ``Prefetcher`` cases (order, overlap, exceptions, SyntheticLM
batches), a clean close, and ``ingest_files`` through the transfer engine
against the files and against the reference's ``ingest_files``. ~3 s."""
from __future__ import annotations

import itertools
import time

import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.data.pipeline import ingest_files as ref_ingest_files
from repro.data.synthetic import DataConfig as RefDataConfig
from repro.data.synthetic import SyntheticLM as RefSyntheticLM
from repro.models.config import reduce_for_smoke as ref_reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.core import testbeds
from repro_torch.data.pipeline import Prefetcher, ingest_files
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.models.config import reduce_for_smoke


def test_prefetcher_preserves_order_and_values():
    assert list(Prefetcher(iter(range(50)), depth=4)) == list(range(50))


def test_prefetcher_overlaps_production():
    def slow_gen():
        for i in range(5):
            time.sleep(0.02)
            yield i

    pf = Prefetcher(slow_gen(), depth=4)
    time.sleep(0.15)  # the producer has buffered ahead by now
    t0 = time.monotonic()
    first_three = [next(pf), next(pf), next(pf)]
    elapsed = time.monotonic() - t0
    assert first_three == [0, 1, 2]
    assert elapsed < 0.05  # served from the buffer, not the 20 ms producer


def test_prefetcher_propagates_exceptions():
    def bad():
        yield 1
        raise ValueError("boom")

    pf = Prefetcher(bad(), depth=2)
    assert next(pf) == 1
    with pytest.raises(ValueError, match="boom"):
        for _ in pf:
            pass


@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-base"])
def test_prefetcher_with_synthetic_batches(arch):
    """The port's stream through the prefetcher equals the reference's
    stream bit for bit (whisper's frames included)."""
    data = dict(global_batch=4, seq_len=16)
    theirs = list(RefSyntheticLM(ref_reduce_for_smoke(ref_get_config(arch)),
                                 RefDataConfig(**data)).batches(3))
    ours = list(Prefetcher(SyntheticLM(reduce_for_smoke(get_config(arch)),
                                       DataConfig(**data)).batches(3), depth=2))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("depth", [1, 2])
def test_prefetcher_closes_an_endless_producer(depth):
    """``close`` stops a producer of an endless stream that is blocked on a
    full queue, at any depth, and returns well inside its 5 s bound."""
    pf = Prefetcher(itertools.count(), depth=depth)
    assert [next(pf), next(pf)] == [0, 1]
    time.sleep(0.05)  # let the producer fill the queue and block
    t0 = time.monotonic()
    pf.close()
    assert time.monotonic() - t0 < 2.0
    assert not pf._thread.is_alive()


def _write_files(tmp_path, sizes):
    rng = np.random.RandomState(0)
    blobs = {}
    for i, size in enumerate(sizes):
        p = str(tmp_path / f"f{i}.bin")
        data = rng.bytes(size)
        with open(p, "wb") as f:
            f.write(data)
        blobs[p] = data
    return blobs


@pytest.mark.parametrize("max_cc", [1, 3])
def test_ingest_files_roundtrip(tmp_path, max_cc):
    """Every file's contents, as the reference's ``ingest_files`` reads them
    (a striped 5 MB file among them)."""
    blobs = _write_files(tmp_path, [1024, 64 * 1024, 5 * 1024 * 1024, 0, 300 * 1024])
    out = ingest_files(list(blobs), max_cc=max_cc)
    assert out == blobs
    assert out == ref_ingest_files(list(blobs), max_cc=max_cc)


def test_ingest_files_streams_into_a_sink(tmp_path):
    blobs = _write_files(tmp_path, [2048, 9 * 1024 * 1024])
    got = {}
    out = ingest_files(list(blobs), network=testbeds.LAN, algorithm="promc",
                       sink=lambda path, data: got.__setitem__(path, data))
    assert out == {} and got == blobs
