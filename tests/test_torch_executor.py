"""The port's chunk executor and the sweep's wall splits, on the CPU.

The runner's promises, as the reference's ``tests/test_executor.py`` holds
its executor to them:

* ``"async"`` gives what ``"serial"`` gives, bit for bit (every
  ``SimResult`` field, timelines included), with equal ``SweepStats``
  counters (the seconds fields left out), on the smoke grid, tenant-smoke
  (coupled fabric groups packed whole), a mixed custom-row batch (through
  ``run_built`` at ``chunk_size=4`` and through ``run_simulations``, one
  chunk) and a smoke successive-halving search, the rest at
  ``chunk_size=4``;
* both modes hold the reference's NumPy driver to the limits of
  ``tests/test_torch_runner.py`` (the golden's rtol 1e-6, bytes exact);
* results come back in input order whatever the chunking;
* an exception in a prep or a compute thread is raised in the caller, and
  no chunk runs again on the calling thread;
* chunks are dealt round-robin over the device slots;
* the file-set cache survives concurrent ``build_files`` calls.
"""
from __future__ import annotations

import dataclasses
import sys
import threading

import pytest

from repro.eval.runner import run_matrix as ref_run_matrix
from repro.eval.scenarios import smoke_matrix as ref_smoke_matrix
from repro_torch.eval import runner, tune
from repro_torch.eval import scenarios as scenarios_mod
from repro_torch.eval.fabric import driver as port_driver
from repro_torch.eval.fabric import executor as executor_mod
from repro_torch.eval.fabric.driver import TorchFabricSimulation
from repro_torch.eval.fabric.executor import execute_chunks, executor_mode
from repro_torch.eval.fabric.plan import build_plan
from repro_torch.eval.fabric.stats import WALL_KEYS, SweepStats
from repro_torch.eval.runner import run_built, run_matrix, run_simulations
from repro_torch.eval.scenarios import build_simulation, smoke_matrix, tenant_matrix

MODES = ("serial", "async")


@pytest.fixture(autouse=True)
def one_thread():
    """The sweeps run thousands of tiny torch ops, from several threads at
    once under the async executor: intra-op threads only slow them on a
    shared CPU."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _same(a, b) -> bool:
    """Two SimResults equal in every field, bit for bit (``repr`` of a
    float is exact and NaN equals NaN)."""
    return repr(dataclasses.asdict(a)) == repr(dataclasses.asdict(b))


def _custom_batch():
    from test_torch_custom_rows import port_batch

    sims, names, _ = port_batch()
    return sims, names


def _smoke(mode, stats):
    return run_matrix(smoke_matrix(), device="cpu", chunk_size=4, executor=mode, stats=stats)


def _tenant(mode, stats):
    return run_matrix(tenant_matrix(n_groups=6), device="cpu", chunk_size=4, executor=mode,
                      stats=stats)


def _custom(mode, stats):
    sims, names = _custom_batch()
    return run_built([(lambda s=s: s) for s in sims], names, device="cpu", chunk_size=4,
                     executor=mode, stats=stats)


def _custom_simulations(mode, stats):
    sims, names = _custom_batch()
    return run_simulations(sims, names, device="cpu", executor=mode, stats=stats)


def _sha(mode, stats):
    res = tune.successive_halving(smoke_matrix()[:8], device="cpu", n_candidates=8,
                                  chunk_size=4, executor=mode, stats=stats)
    return [res.evals, res.equivalent_evals, res.tables, res.trace,
            [(e.scenario, e.best_params, e.best_throughput) for e in res.entries]]


# ------------------------------------------------------------------ #
# mode resolution
# ------------------------------------------------------------------ #


def test_executor_mode_resolution(monkeypatch):
    monkeypatch.delenv("REPRO_FABRIC_EXECUTOR", raising=False)
    assert executor_mode() == "serial"
    assert executor_mode("async") == "async"
    monkeypatch.setenv("REPRO_FABRIC_EXECUTOR", "async")
    assert executor_mode() == "async"
    assert executor_mode("serial") == "serial"  # the explicit argument wins
    monkeypatch.setenv("REPRO_FABRIC_EXECUTOR", "bogus")
    with pytest.raises(ValueError, match="unknown executor mode"):
        executor_mode()
    with pytest.raises(ValueError, match="unknown executor mode"):
        executor_mode("threads")
    monkeypatch.delenv("REPRO_FABRIC_EXECUTOR_DEPTH", raising=False)
    assert executor_mod._queue_depth(None) == executor_mod.DEFAULT_QUEUE_DEPTH == 1
    monkeypatch.setenv("REPRO_FABRIC_EXECUTOR_DEPTH", "3")
    assert executor_mod._queue_depth(None) == 3
    assert executor_mod._queue_depth(2) == 2 and executor_mod._queue_depth(0) == 1


def test_backend_devices():
    import torch

    assert executor_mod.backend_devices(torch.device("cpu")) == [torch.device("cpu")]
    assert executor_mod.backend_devices(torch.device("cuda", 1)) == [torch.device("cuda", 1)]


def _spy_threads(monkeypatch):
    """Record the name of every thread started."""
    spawned = []
    orig = threading.Thread

    class SpyThread(orig):
        def __init__(self, *a, **kw):
            spawned.append(kw.get("name"))
            super().__init__(*a, **kw)

    monkeypatch.setattr(threading, "Thread", SpyThread)
    return spawned


def test_serial_mode_starts_no_thread(monkeypatch):
    """``REPRO_FABRIC_EXECUTOR=serial`` is the plain loop on the calling
    thread: no prep or compute thread starts."""
    monkeypatch.setenv("REPRO_FABRIC_EXECUTOR", "serial")
    spawned = _spy_threads(monkeypatch)
    out = run_matrix(smoke_matrix()[:6], device="cpu", chunk_size=2)
    assert len(out) == 6 and all(r is not None for r in out)
    assert not any(n and n.startswith("fabric-") for n in spawned)


def test_async_runs_one_chunk_on_the_calling_thread(monkeypatch):
    """With one chunk there is nothing to overlap: ``"async"`` runs it as
    the plain loop does, on the calling thread, and starts no thread; two
    chunks start the pipeline."""
    spawned = _spy_threads(monkeypatch)
    threads = _spy_runs(monkeypatch)
    scs = smoke_matrix()[:6]
    one = run_matrix(scs, device="cpu", executor="async")
    assert not spawned and threads == [threading.current_thread().name]
    two = run_matrix(scs, device="cpu", chunk_size=3, executor="async")
    assert {"fabric-prep0", "fabric-dev0"} <= set(spawned)
    assert threads[1:] == ["fabric-dev0", "fabric-dev0"]
    assert all(_same(a, b) for a, b in zip(one, two))


def test_driver_lists_every_tensor_its_build_made():
    """``use_stream`` marks the tensors the build made: every tensor a
    freshly built driver holds (its state, the fabric operands and their
    layout) is among them, so none is left unmarked."""
    import torch

    def held(value):
        if isinstance(value, torch.Tensor):
            yield value
        elif isinstance(value, dict):
            for v in value.values():
                yield from held(v)
        elif isinstance(value, (list, tuple)):
            for v in value:
                yield from held(v)

    drv = TorchFabricSimulation(build_plan(tenant_matrix(n_groups=2)), device="cpu")
    assert drv.coupled
    built = {id(ref()) for ref in drv._built if ref() is not None}
    tensors = list(held({k: v for k, v in vars(drv).items() if k != "_built"}))
    assert len(tensors) > 60 and all(id(t) in built for t in tensors)


# ------------------------------------------------------------------ #
# async against serial, bit for bit, counters equal
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("case", [_smoke, _tenant, _custom, _custom_simulations, _sha],
                         ids=["smoke", "tenant-smoke", "custom-chunk4", "custom-simulations",
                              "sha-smoke"])
def test_async_equals_serial_bit_for_bit(case):
    serial, pipelined = SweepStats(), SweepStats()
    a = case("serial", serial)
    b = case("async", pipelined)
    if case is _sha:
        assert repr(a) == repr(b)
    else:
        assert len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    assert serial.counters() == pipelined.counters()
    assert serial.sweeps > 0 and serial.steps > 0
    for st in (serial, pipelined):
        assert all(getattr(st, k) >= 0.0 for k in WALL_KEYS)
        assert st.build_wall_s > 0.0 and st.compute_wall_s > 0.0 and st.ingest_s > 0.0
    if case in (_custom, _custom_simulations):
        assert serial.post_row_replays > 0


@pytest.mark.parametrize("mode", MODES)
def test_both_modes_hold_the_reference_numpy_driver(mode):
    ref = ref_run_matrix(ref_smoke_matrix(), backend="numpy", executor="serial")
    out = run_matrix(smoke_matrix(), device="cpu", chunk_size=4, executor=mode)
    devs = runner.compare_golden(runner.metrics_snapshot(smoke_matrix(), ref),
                                 runner.metrics_snapshot(smoke_matrix(), out))
    assert devs == []
    assert [r.total_bytes for r in out] == [r.total_bytes for r in ref]
    assert [(r.network, r.scheduler) for r in out] == [(r.network, r.scheduler) for r in ref]


@pytest.mark.parametrize("chunk_size", [1, 3, 7, 32])
def test_results_in_input_order_any_chunking(chunk_size):
    """Rows never interact, so each row's result is the same whatever
    chunk it ran in, and lands at its input index."""
    scs = smoke_matrix()[:10]
    baseline = run_matrix(scs, device="cpu", executor="serial")
    out = run_matrix(scs, device="cpu", chunk_size=chunk_size, executor="async")
    assert all(_same(o, b) for o, b in zip(out, baseline))


def test_execute_chunks_writes_original_indices():
    scs = smoke_matrix()[:6]
    plan = build_plan(scs)
    results = [None] * 6
    parts = [[4, 1], [5, 0], [2, 3]]  # scrambled, disjoint
    stats = SweepStats()
    execute_chunks(parts, lambda part, dev: TorchFabricSimulation(plan.take(part), device=dev),
                   results, mode="async", device="cpu", stats=stats)
    direct = TorchFabricSimulation(plan, device="cpu").run()
    assert all(_same(r, d) for r, d in zip(results, direct))
    assert stats.steps == sum(r.n_events for r in direct)


# ------------------------------------------------------------------ #
# errors: raised in the caller, nothing re-run serially
# ------------------------------------------------------------------ #


def _spy_runs(monkeypatch):
    """Record the thread each driver run starts on."""
    threads = []
    real = TorchFabricSimulation.run

    def run(self, turn=None):
        threads.append(threading.current_thread().name)
        return real(self, turn)

    monkeypatch.setattr(TorchFabricSimulation, "run", run)
    return threads


def test_builder_error_raises_in_the_caller(monkeypatch):
    threads = _spy_runs(monkeypatch)
    scs = smoke_matrix()[:4]
    builders = [(lambda sc=sc: build_simulation(sc)) for sc in scs]

    def boom():
        raise RuntimeError("builder exploded")

    builders[2] = boom
    with pytest.raises(RuntimeError, match="builder exploded"):
        run_built(builders, [sc.name for sc in scs], device="cpu", chunk_size=1,
                  executor="async")
    assert all(t.startswith("fabric-dev") for t in threads)


def test_driver_error_raises_in_the_caller(monkeypatch):
    """A row past ``max_time`` raises in the compute thread; the caller gets
    that error, and no chunk ran on the calling thread."""
    threads = _spy_runs(monkeypatch)
    monkeypatch.setattr(port_driver, "MAX_TIME", 1.0)
    with pytest.raises(RuntimeError, match="exceeded max_time"):
        run_matrix(smoke_matrix()[:8], device="cpu", chunk_size=2, executor="async")
    assert threads and all(t.startswith("fabric-dev") for t in threads)


# ------------------------------------------------------------------ #
# device slots
# ------------------------------------------------------------------ #


class _FakeDriver:
    def __init__(self, j, dev, log):
        self.j, self.dev, self.log = j, dev, log
        self.stats = SweepStats(steps=1)

    def run(self, turn=None):
        self.log.append((self.j, self.dev.index, threading.current_thread().name))
        return [self.j]


def test_chunks_are_dealt_round_robin_over_four_slots(monkeypatch):
    import torch

    slots = [torch.device("cpu", i) for i in range(4)]
    monkeypatch.setattr(executor_mod, "backend_devices", lambda device: slots)
    log = []
    results = [None] * 11
    stats = SweepStats()
    execute_chunks([[j] for j in range(11)], lambda part, dev: _FakeDriver(part[0], dev, log),
                   results, mode="async", stats=stats)
    assert results == list(range(11))
    assert sorted(log) == [(j, j % 4, f"fabric-dev{j % 4}") for j in range(11)]
    assert stats.steps == 11
    # the real sweep over four slots gives the serial results (the smoke
    # rows of fewest events: a chunk a row)
    scs = [smoke_matrix()[i] for i in (12, 13, 16, 17, 20, 21)]
    four = run_matrix(scs, device="cpu", chunk_size=1, executor="async")
    serial = run_matrix(scs, device="cpu", chunk_size=1, executor="serial")
    assert all(_same(a, b) for a, b in zip(four, serial))


# ------------------------------------------------------------------ #
# the file-set cache under concurrency
# ------------------------------------------------------------------ #


def test_files_cache_concurrent_build_files(monkeypatch):
    """Eight threads hammer the LRU with a bound small enough to evict all
    the time (the switch interval shortened): no error, the right file
    sets, and the bound held."""
    scs = [dataclasses.replace(smoke_matrix()[0], seed=s) for s in range(6)]
    expected = {sc.seed: [f.size for f in scenarios_mod.build_files(sc)] for sc in scs}
    bound = 2 * max(len(v) for v in expected.values())
    monkeypatch.setattr(scenarios_mod, "FILES_CACHE_MAX_FILES", bound)
    with scenarios_mod._files_cache_lock:
        scenarios_mod._files_cache.clear()  # a cache: emptying it changes no result
    errors = []

    def worker(tid):
        try:
            for i in range(150):
                sc = scs[(tid + i) % len(scs)]
                assert [f.size for f in scenarios_mod.build_files(sc)] == expected[sc.seed]
                with scenarios_mod._files_cache_lock:
                    held = sum(len(e) for e in scenarios_mod._files_cache.values())
                assert held <= bound
        except BaseException as exc:  # surfaced after the join
            errors.append(exc)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
