"""The CUDA kernels on the card: each against its plain PyTorch version,
the smoke matrix through the three sweep routes against the golden
snapshot, and the RWKV-6, recurrentgemma and gemma3 models on the card
against their CPU runs.

These need an NVIDIA GPU and ``nvcc``; without a card they skip. On the
card: ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.eval.fabric.driver import TorchFabricSimulation
from repro_torch.eval.fabric.kernels import fused_step as fs
from repro_torch.eval.fabric.plan import build_plan
from repro_torch.eval.fabric.kernels import waterfill_bisect as wf
from repro_torch.eval.runner import compare_golden, load_golden, metrics_snapshot, run_matrix
from repro_torch.eval.scenarios import smoke_matrix
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as wk
from repro_torch.kernels.ref import flash_attention_ref, rglru_scan_ref, rwkv6_scan_ref
from repro_torch.models.config import reduce_for_smoke
from repro_torch.models.model import build_model

pytestmark = pytest.mark.gpu

GOLDEN = Path(__file__).resolve().parent / "golden" / "eval_smoke.json"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("C", [4, 8, 16, 32, 64])
def test_kernels_match_their_plain_versions_on_the_card(cuda, C):
    rng = np.random.RandomState(C)
    S, K, Q = 300, 4, 1024
    chunk_of = rng.randint(-1, K, (S, C))
    busy = (chunk_of >= 0) & (rng.uniform(size=(S, C)) < 0.5)
    qlen = rng.randint(0, 3, (S, K))
    qoff = np.minimum((np.cumsum(qlen.ravel()) - qlen.ravel()).reshape(S, K), Q - 1)
    f8, i8 = torch.float64, torch.int64

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    args = (
        t(rng.uniform(size=S) < 0.8, torch.bool), t(busy, torch.bool),
        t(np.where(rng.uniform(size=(S, C)) < 0.3, rng.uniform(0, 0.2, (S, C)), 0.0), f8),
        t(np.where(busy, np.floor(rng.uniform(1e5, 5e9, (S, C))), 0.0), f8),
        t(np.where(chunk_of >= 0, rng.uniform(1e8, 5e8, (S, C)), 0.0), f8),
        t(chunk_of, i8), t(rng.uniform(0.05, 5, S), f8), t(np.full(S, 1.25e9), f8),
        t(rng.uniform(4e8, 3e9, S), f8), t(rng.randint(2, 9, S), i8),
        t(rng.uniform(0.01, 0.08, S), f8), t(qoff, i8), t(qlen, i8),
        t(np.zeros((S, K)), i8), t(np.floor(rng.uniform(0, 1e11, (S, K))), f8),
        t(rng.uniform(0.005, 0.1, (S, K)), f8), t(np.floor(rng.uniform(1e5, 1e10, Q)), f8),
    )
    want = fs.fused_step_plain(*args)
    before = fs.fused_step.launches
    out = fs.fused_step(*args)
    assert fs.fused_step.launches == before + 1
    for o, r in zip(out, want):
        if r.dtype == f8:
            torch.testing.assert_close(o, r, rtol=1e-12, atol=0)
        else:
            assert torch.equal(o, r)
    caps = torch.where(args[1], args[4], 0.0).contiguous()
    pool = caps.sum(dim=-1) * 0.7
    torch.testing.assert_close(
        wf.waterfill_bisect(caps, pool), wf.waterfill_bisect_plain(caps, pool),
        rtol=1e-12, atol=0,
    )


@pytest.mark.parametrize("widen", [0, 1, 2])
@pytest.mark.parametrize("max_steps", [1, 7, fs.ROUND_CAP])
def test_fused_rounds_matches_its_plain_version_on_the_card(cuda, max_steps, widen):
    """The loop kernel on a live smoke-matrix state (every fifth row
    recording a timeline; its 16 channel columns doubled ``widen`` times)
    against its plain version on the card: float64 within 1e-12
    relative, bool and int64 exact."""
    drv = TorchFabricSimulation(build_plan(smoke_matrix()), device=cuda, fused_step="kernel")
    drv.start()
    for _ in range(5):
        drv.step()
    for _ in range(widen):
        drv._grow()
    s = {k: v.clone() for k, v in drv.round_operands(~drv.done).items()}
    s["record_timeline"][::5] = True
    want = fs.fused_rounds_plain(s, max_steps)
    before = fs.fused_rounds.launches
    fs.fused_rounds(s, max_steps)
    torch.cuda.synchronize()
    assert fs.fused_rounds.launches == before + 1
    for name, v in want.items():
        if v.dtype == torch.float64:  # completion times stay NaN until a chunk completes
            torch.testing.assert_close(s[name], v, rtol=1e-12, atol=0, equal_nan=True, msg=name)
        else:
            assert torch.equal(s[name], v), name


def _live_smoke_operands(cuda, sweeps=5):
    drv = TorchFabricSimulation(build_plan(smoke_matrix()), device=cuda, fused_step="kernel")
    drv.start()
    for _ in range(sweeps):
        drv.step()
    return {k: v.clone() for k, v in drv.round_operands(~drv.done).items()}


@pytest.mark.parametrize("max_steps", [16, fs.ROUND_CAP])
def test_fused_rounds_sums_interleaved_chunk_columns_in_column_order(cuda, max_steps):
    """The loop kernel's per-chunk sums (moved bytes into ``delivered``,
    files fed) walk each chunk's ballot mask in column order: on a live
    smoke state whose channel columns are shuffled (the same permutation in
    every row) so that chunks interleave, every output, the level reuses
    included, is bit for bit the plain version's."""
    s = _live_smoke_operands(cuda)
    perm = torch.randperm(s["busy"].shape[1], generator=torch.Generator().manual_seed(3))
    for name in ("busy", "dead", "rem", "cap", "chunk_of"):
        s[name] = s[name][:, perm.to(cuda)].contiguous()
    want = fs.fused_rounds_plain(s, max_steps)
    fs.fused_rounds(s, max_steps)
    torch.cuda.synchronize()
    assert fs.fused_rounds.reuses is s["reuses"] and int(s["reuses"].sum()) > 0
    for name, v in want.items():
        if v.dtype == torch.float64:
            torch.testing.assert_close(s[name], v, rtol=0, atol=0, equal_nan=True, msg=name)
        else:
            assert torch.equal(s[name], v), name


def test_fused_rounds_probe_splits_the_step_and_keeps_the_results(cuda):
    """The probe build gives the unprobed kernel's results bit for bit and
    each active row's cycles by phase (every phase of a stepping row
    positive but the profile's, which a row without a profile may skip)."""
    s = _live_smoke_operands(cuda)
    ref = {k: v.clone() for k, v in s.items()}
    fs.fused_rounds(ref, 64)
    before = fs.fused_rounds_probe.launches
    cycles = fs.fused_rounds_probe(s, 64)
    torch.cuda.synchronize()
    assert fs.fused_rounds_probe.launches == before + 1
    assert cycles.shape == (s["act"].shape[0], len(fs.PROBE_PHASES))
    for name, v in ref.items():
        if v.dtype == torch.float64:
            torch.testing.assert_close(s[name], v, rtol=0, atol=0, equal_nan=True, msg=name)
        else:
            assert torch.equal(s[name], v), name
    stepped = s["act"] & (s["steps"] > 1)
    assert bool((cycles[~s["act"]] == 0).all())
    level = fs.PROBE_PHASES.index("level")
    assert bool((cycles[stepped][:, level] > 0).all())


def test_fused_rounds_coupled_probe_splits_the_group_step_and_keeps_the_results(cuda):
    """The coupled loop kernel's probe build on a live tenant-smoke state:
    the unprobed kernel's results, sweeps and reused solves bit for bit,
    the reused solves the plain version's count, and SM cycles by phase
    positive for every row that stepped (0 on inactive rows)."""
    from repro_torch.eval.scenarios import tenant_matrix

    drv = TorchFabricSimulation(build_plan(tenant_matrix(n_groups=6)), device=cuda,
                                fused_step="none")
    drv.start()
    for _ in range(5):
        drv.step()
    s = {k: v.clone() for k, v in drv.round_operands(~drv.done).items()}
    fab = drv._fab
    counts = {}
    fs.fused_rounds_coupled_plain(s, fab, 64, counts=counts)
    ref = {k: v.clone() for k, v in s.items()}
    fs.fused_rounds_coupled(ref, fab, 64)
    want = (fs.fused_rounds_coupled.sweeps, fs.fused_rounds_coupled.solve_reuses)
    before = fs.fused_rounds_coupled_probe.launches
    cycles = fs.fused_rounds_coupled_probe(s, fab, 64)
    torch.cuda.synchronize()
    assert fs.fused_rounds_coupled_probe.launches == before + 1
    assert cycles.shape == (s["act"].shape[0], len(fs.COUPLED_PROBE_PHASES))
    for name, v in ref.items():
        if v.dtype == torch.float64:
            torch.testing.assert_close(s[name], v, rtol=0, atol=0, equal_nan=True, msg=name)
        else:
            assert torch.equal(s[name], v), name
    assert torch.equal(fs.fused_rounds_coupled_probe.sweeps, want[0])
    assert torch.equal(fs.fused_rounds_coupled_probe.solve_reuses, want[1])
    assert torch.equal(want[1].cpu(), counts["solve_reuses"].cpu())
    stepped = s["act"] & (s["steps"] > 0)
    assert bool(stepped.any())
    assert bool((cycles[~s["act"]] == 0).all())
    assert bool((cycles[stepped].sum(dim=1) > 0).all())
    level = fs.COUPLED_PROBE_PHASES.index("level")
    assert bool((cycles[stepped][:, level] > 0).all())


@pytest.mark.parametrize("max_steps", [1, 16, fs.ROUND_CAP])
def test_coupled_loop_matches_its_plain_version_on_the_card(cuda, max_steps):
    """The coupled loop kernel on a live tenant-smoke state against its
    plain version on the card, bit for bit (NaN completion times equal)."""
    from repro_torch.eval.scenarios import tenant_matrix

    drv = TorchFabricSimulation(build_plan(tenant_matrix(n_groups=6)), device=cuda,
                                fused_step="none")
    drv.start()
    for _ in range(5):
        drv.step()
    s = {k: v.clone() for k, v in drv.round_operands(~drv.done).items()}
    fab = drv._fab
    want = fs.fused_rounds_coupled_plain(s, fab, max_steps)
    before = fs.fused_rounds_coupled.launches
    fs.fused_rounds_coupled(s, fab, max_steps)
    torch.cuda.synchronize()
    assert fs.fused_rounds_coupled.launches == before + 1
    for name, v in want.items():
        if v.dtype == torch.float64:
            torch.testing.assert_close(s[name], v, rtol=0, atol=0, equal_nan=True, msg=name)
        else:
            assert torch.equal(s[name], v), name


def test_custom_rows_on_the_loop_route_equal_their_cpu_run(cuda):
    """The mixed batch of ``tests/test_torch_custom_rows.py`` (custom
    schedulers on every other smoke row, their callbacks on the host) on the
    ``"rounds"`` route: the loop kernel stops each custom row at its
    callbacks and the card's results equal the CPU run's (the plain loop)
    within 1e-9 relative throughput, moves and bytes exact."""
    from test_torch_custom_rows import port_batch

    from repro_torch.eval.fabric.plan import from_simulations

    sims, names, _ = port_batch()
    before = fs.fused_rounds.launches
    card = TorchFabricSimulation(from_simulations(sims, names), device=cuda)
    got = card.run()
    assert fs.fused_rounds.launches > before
    assert card.stats.post_row_replays > 0 and card.stats.host_transitions == 0
    want = TorchFabricSimulation(from_simulations(sims, names), device="cpu").run()
    for n, a, b in zip(names, got, want):
        assert (a.n_moves, a.total_bytes) == (b.n_moves, b.total_bytes), n
        assert abs(a.throughput - b.throughput) <= 1e-9 * b.throughput, n


def test_coupled_loop_refuses_a_group_wider_than_a_block(cuda):
    """A fabric group of 9 rows raises before any launch."""
    import dataclasses

    from repro_torch.eval.fabric.shared import SharedFabric
    from repro_torch.eval.scenarios import tenant_matrix

    rows = [dataclasses.replace(sc, shared_fabric=SharedFabric("wide", ("bb",), (1e9,), f"t{i}"))
            for i, sc in enumerate(tenant_matrix(n_groups=2)[:9])]
    before = fs.fused_rounds_coupled.launches
    with pytest.raises(ValueError, match="has 9 rows"):
        run_matrix(rows, device=cuda)
    assert fs.fused_rounds_coupled.launches == before


def test_fused_kernels_launch_nothing_for_zero_rows(cuda):
    """A batch of no rows returns its (empty) outputs without a launch or a
    count on either fused kernel."""
    drv = TorchFabricSimulation(build_plan(smoke_matrix()), device=cuda, fused_step="kernel")
    drv.start()
    s = {k: v[:0].clone() if v.dim() and k != "qsizes" else v
         for k, v in drv.round_operands(~drv.done).items()}
    before = fs.fused_rounds.launches, fs.fused_step.launches
    assert fs.fused_rounds(s).shape == (0,)
    args = (
        s["act"], s["busy"], s["dead"], s["rem"], s["cap"], s["chunk_of"], s["t"],
        s["bw"], s["disk_rate"], s["sat_cc"], s["contention"], s["qoff"], s["qlen"],
        s["qptr"], s["queue_bytes"], s["fsdt"], s["qsizes"],
    )
    out = fs.fused_step(*args)
    assert [o.shape[0] for o in out] == [0] * 9
    assert (fs.fused_rounds.launches, fs.fused_step.launches) == before


@pytest.mark.parametrize("fused", ["rounds", "kernel", "none"])
def test_smoke_matrix_on_the_card_matches_golden(cuda, fused):
    scs = smoke_matrix()
    counters = {"rounds": fs.fused_rounds, "kernel": fs.fused_step, "none": wf.waterfill_bisect}
    before = counters[fused].launches
    out = run_matrix(scs, device=cuda, fused_step=fused)
    assert compare_golden(load_golden(str(GOLDEN)), metrics_snapshot(scs, out)) == []
    assert counters[fused].launches > before


@pytest.mark.parametrize("grid", ["default", "tenant-smoke"])
def test_async_executor_equals_serial_on_the_card(cuda, grid):
    """The chunk executor's two modes on the card, bit for bit in every
    SimResult field, with equal counters (chunks of 64 rows: several
    chunks in flight)."""
    import dataclasses

    from repro_torch.eval.fabric.stats import SweepStats
    from repro_torch.eval.runner import build_matrix

    scs = build_matrix(grid)
    out, stats = {}, {}
    for mode in ("serial", "async"):
        stats[mode] = SweepStats()
        out[mode] = run_matrix(scs, device=cuda, chunk_size=64, executor=mode,
                               stats=stats[mode])
    same = [repr(dataclasses.asdict(a)) == repr(dataclasses.asdict(b))
            for a, b in zip(out["serial"], out["async"])]
    assert len(same) == len(scs) and all(same)
    assert stats["serial"].counters() == stats["async"].counters()


def test_async_executor_uploads_on_a_side_stream(cuda, monkeypatch):
    """Under the async executor each chunk's uploads run on a prep
    worker's side stream, never the default stream, and its driver runs on
    a compute stream that is neither; the compute stream waits on the
    chunk's event first. Both streams are the same on every call."""
    from repro_torch.eval.runner import run_matrix as run

    up_streams, run_streams, waits = set(), set(), []
    real_up, real_run = TorchFabricSimulation._up, TorchFabricSimulation.run
    real_wait = torch.cuda.Stream.wait_event

    def up(self, arr, dtype):
        up_streams.add(torch.cuda.current_stream(self.device).cuda_stream)
        return real_up(self, arr, dtype)

    def run_(self, turn=None):
        run_streams.add(torch.cuda.current_stream(self.device).cuda_stream)
        return real_run(self, turn)

    def wait_event(self, event):
        waits.append(self.cuda_stream)
        return real_wait(self, event)

    monkeypatch.setattr(TorchFabricSimulation, "_up", up)
    monkeypatch.setattr(TorchFabricSimulation, "run", run_)
    monkeypatch.setattr(torch.cuda.Stream, "wait_event", wait_event)
    for _ in range(2):
        out = run(smoke_matrix(), device=cuda, chunk_size=8, executor="async")
        assert len(out) == 32
    default = torch.cuda.default_stream(cuda).cuda_stream
    assert len(up_streams) == 1 and default not in up_streams
    assert len(run_streams) == 1 and default not in run_streams
    assert not (run_streams & up_streams)
    assert len(waits) == 8 and set(waits) == run_streams


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [(1, 2, 64, 32), (2, 4, 128, 64), (1, 1, 96, 16),
                                  (2, 3, 1, 64), (3, 2, 97, 32)], ids=str)
def test_wkv_kernel_matches_its_plain_version_on_the_card(cuda, case, dtype):
    """rtol = atol = 1e-4 for both input types: the wrapper and the plain
    version upcast the same bf16 values, so only the fp32 summation order
    differs."""
    b, h, t, d = case
    rng = np.random.RandomState(t)
    r, k, v = (torch.tensor(0.5 * rng.standard_normal((b, h, t, d)), dtype=dtype, device=cuda)
               for _ in range(3))
    w = torch.tensor(np.exp(-np.exp(0.5 * rng.standard_normal((b, h, t, d)))),
                     dtype=dtype, device=cuda)
    u = torch.tensor(0.5 * rng.standard_normal((h, d)), dtype=torch.float32, device=cuda)
    s0 = torch.tensor(0.1 * rng.standard_normal((b, h, d, d)), dtype=torch.float32, device=cuda)
    before = wk.rwkv6_scan.launches
    y, s = wk.rwkv6_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wk.rwkv6_scan.launches == before + 1
    y_ref, s_ref = rwkv6_scan_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, s_ref, rtol=1e-4, atol=1e-4)


def _wkv_inputs(b, h, t, d, device, layout="kernel"):
    """r, k, v, w (B, H, T, D) fp32 from a seed, as contiguous tensors or as
    views of (B, T, H, D) tensors ("model"); u, s0."""
    rng = np.random.RandomState(b * t + d)
    draw = lambda *s, scale=0.5: torch.tensor(scale * rng.standard_normal(s),  # noqa: E731
                                              dtype=torch.float32, device=device)
    shape = (b, t, h, d) if layout == "model" else (b, h, t, d)
    r, k, v = (draw(*shape) for _ in range(3))
    w = torch.exp(-torch.exp(draw(*shape)))
    seq = [x.movedim(1, 2) if layout == "model" else x for x in (r, k, v, w)]
    return (*seq, draw(h, d), draw(b, h, d, d, scale=0.1))


@pytest.mark.parametrize("case", [(8, 40, 512, 64), (8, 40, 1, 64), (1, 40, 2048, 64),
                                  (2, 40, 77, 64), (1, 3, 13, 32), (3, 2, 9, 16),
                                  (2, 5, 3, 64), (3, 3, 2, 32), (2, 2, 4, 16)], ids=str)
def test_wkv_kernel_at_the_serving_shapes(cuda, case):
    """rwkv6-3b's prefill (8 x 512) and decode (T = 1) at 40 heads of 64, a
    long prompt at B = 1, T that no 16-step chunk divides, and T of 2-4 on
    either side of the step kernel's limit, at each head dim: within
    rtol = atol = 1e-4 of the plain version."""
    args = _wkv_inputs(*case, cuda)
    before = wk.rwkv6_scan.launches
    y, s = wk.rwkv6_scan(*args)
    torch.cuda.synchronize()
    assert wk.rwkv6_scan.launches == before + 1
    y_ref, s_ref = rwkv6_scan_ref(*args)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, s_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", [(8, 40, 512, 64), (2, 40, 77, 64), (1, 4, 1, 32)], ids=str)
def test_wkv_kernel_reads_model_layout_views_in_place(cuda, case):
    """(B, H, T, D) views of (B, T, H, D) tensors, as ``ops.rwkv6_scan``
    hands the model's products over: the call allocates its two outputs and
    nothing else (no copy of r, k, v, w), y is laid out (B, T, H, D), and
    the results are those of contiguous copies, within the limit. Memory is
    counted in the bytes the call requests, and the allocations it makes:
    the caching allocator rounds large blocks up."""
    b, h, t, d = case
    args = _wkv_inputs(*case, cuda, layout="model")
    wk.rwkv6_scan(*args)  # built and loaded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_stats()
    y, s = wk.rwkv6_scan(*args)
    torch.cuda.synchronize()
    after = torch.cuda.memory_stats()
    outputs = 4 * (b * h * t * d + b * h * d * d)
    assert after["allocation.all.allocated"] - before["allocation.all.allocated"] == 2
    assert after["requested_bytes.all.peak"] - before["requested_bytes.all.current"] <= outputs
    assert after["requested_bytes.all.current"] - before["requested_bytes.all.current"] == outputs
    assert y.movedim(1, 2).is_contiguous()
    y_m, s_m = ops.rwkv6_scan(*(x.movedim(2, 1) for x in args[:4]), *args[4:])
    assert y_m.is_contiguous() and torch.equal(y_m, y.movedim(1, 2)) and torch.equal(s_m, s)
    y_c, s_c = wk.rwkv6_scan(*(x.contiguous() for x in args[:4]), *args[4:])
    torch.testing.assert_close(y, y_c, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, s_c, rtol=1e-4, atol=1e-4)
    y_ref, s_ref = rwkv6_scan_ref(*args)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, s_ref, rtol=1e-4, atol=1e-4)


def test_wkv_kernel_refuses_other_head_dims(cuda):
    r = torch.zeros((1, 1, 4, 48), device=cuda)
    with pytest.raises(ValueError, match="D in"):
        wk.rwkv6_scan(r, r, r, r, torch.zeros((1, 48), device=cuda),
                      torch.zeros((1, 1, 48, 48), device=cuda))


def test_rwkv_model_on_the_card_matches_its_cpu_run(cuda):
    """Prefill and two decode steps of the smoke config: logits within atol
    2e-2, caches within rtol = atol = 1e-3; every layer of every call
    launches the WKV kernel once."""
    cfg = reduce_for_smoke(get_config("rwkv6-3b"))
    gpu = build_model(cfg, device=cuda).init(torch.Generator(device=cuda).manual_seed(0))
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 16))
    runs = []
    before = wk.rwkv6_scan.launches
    for m in (gpu, cpu):
        with torch.inference_mode():
            lg, c = m.prefill({"tokens": torch.as_tensor(tokens, device=m.device)},
                              m.init_cache(2, 18))
            out = [(lg[:, 0], c)]
            for i in range(2):
                tok = torch.as_tensor(tokens[:, i], device=m.device)
                out.append(m.decode_step(tok, out[-1][1], 16 + i))
        runs.append(out)
    assert wk.rwkv6_scan.launches == before + 3 * cfg.num_layers
    for (lg_g, c_g), (lg_c, c_c) in zip(*runs):
        torch.testing.assert_close(lg_g.float().cpu(), lg_c.float(), rtol=0, atol=2e-2)
        for name in c_c:
            torch.testing.assert_close(c_g[name].cpu(), c_c[name], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [(1, 64, 128), (2, 128, 256), (3, 100, 64), (2, 1, 4096),
                                  (3, 97, 1000), (1, 37, 33), (70000, 2, 3)], ids=str)
def test_rglru_kernel_matches_its_plain_version_on_the_card(cuda, case, dtype):
    """Bit for bit, and so within the limit of rtol = atol = 1e-6 that
    chip_smoke.py holds: the kernel walks time in the plain version's order
    and, built with -fmad=false, rounds the product and the sum apart as it
    does. The limit is that tight because no other order or rounding of
    this fp32 recurrence keeps it where decays are near 1, or where they
    are a trained model's over a long prompt: there the plain walk is
    itself outside 1e-6 of the exact answer (see
    tests/test_torch_rglru_scan.py). T = 1, T <= 16 and odd widths (a
    thread per column, loaded straight into registers) and T > 16 with
    W % 32 == 0 (the cp.async ring) included. Each call launches the
    kernel once. 70,000 batch rows: more than a grid's y holds."""
    b, t, w = case
    gen = torch.Generator(device=cuda).manual_seed(t * w)
    a = torch.sigmoid(torch.randn((b, t, w), generator=gen, device=cuda)).to(dtype)
    x = (0.5 * torch.randn((b, t, w), generator=gen, device=cuda)).to(dtype)
    h0 = 0.5 * torch.randn((b, w), generator=gen, device=cuda)
    before = rg.rglru_scan.launches
    h, h_fin = rg.rglru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert rg.rglru_scan.launches == before + 1
    assert h.dtype == h_fin.dtype == torch.float32
    h_ref, fin_ref = rglru_scan_ref(a, x, h0)
    torch.testing.assert_close(h, h_ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(h_fin, fin_ref, rtol=1e-6, atol=1e-6)
    assert torch.equal(h, h_ref) and torch.equal(h_fin, fin_ref)


@pytest.mark.parametrize("decay", ["sigmoid", "near1"])
@pytest.mark.parametrize("case", [(8, 512, 4096), (8, 1, 4096), (1, 3072, 4096), (1, 3071, 4096),
                                  (3, 77, 1000), (2, 17, 4096)], ids=str)
def test_rglru_kernel_at_the_serving_shapes(cuda, case, decay):
    """recurrentgemma-9b's prefill (8 x 512), decode (T = 1) and long
    prompt (1 x 3,072), T that no 32-step stage of the ring divides, B = 1,
    and decays near 1 (in (0.999, 1)), where nothing contracts: bit for bit
    against the plain version, within the limit of 1e-6."""
    b, t, w = case
    gen = torch.Generator(device=cuda).manual_seed(t + w)
    u = torch.rand((b, t, w), generator=gen, device=cuda)
    a = torch.sigmoid(torch.randn((b, t, w), generator=gen, device=cuda)) if decay == "sigmoid" \
        else 1.0 - 1e-3 * u
    x = 0.5 * torch.randn((b, t, w), generator=gen, device=cuda)
    h0 = 0.5 * torch.randn((b, w), generator=gen, device=cuda)
    h, h_fin = rg.rglru_scan(a, x, h0)
    h_ref, fin_ref = rglru_scan_ref(a, x, h0)
    torch.testing.assert_close(h, h_ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(h_fin, fin_ref, rtol=1e-6, atol=1e-6)
    assert torch.equal(h, h_ref) and torch.equal(h_fin, fin_ref)


def test_rglru_kernel_takes_inputs_the_ring_cannot_copy(cuda):
    """a and x contiguous but 4 bytes off a 16-byte boundary, which the
    wrapper passes on as they are and the ring's 16-byte copies cannot
    read, at a length and width the ring would take: the thread-per-column
    kernel runs them, bit for bit with the plain version, one launch."""
    b, t, w = 2, 100, 128
    gen = torch.Generator(device=cuda).manual_seed(5)
    a, x = (torch.empty(b * t * w + 1, device=cuda)[1:].view(b, t, w) for _ in range(2))
    a.copy_(torch.sigmoid(torch.randn((b, t, w), generator=gen, device=cuda)))
    x.copy_(0.5 * torch.randn((b, t, w), generator=gen, device=cuda))
    h0 = 0.5 * torch.randn((b, w), generator=gen, device=cuda)
    assert a.is_contiguous() and a.data_ptr() % 16 != 0
    before = rg.rglru_scan.launches
    h, h_fin = rg.rglru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert rg.rglru_scan.launches == before + 1
    h_ref, fin_ref = rglru_scan_ref(a, x, h0)
    assert torch.equal(h, h_ref) and torch.equal(h_fin, fin_ref)


def test_hybrid_model_on_the_card_matches_its_cpu_run(cuda):
    """Prefill (longer than the window of 8) and two decode steps of the
    5-layer smoke model: free-running logits within atol 2e-2; every block
    call of the CPU run replayed on the card on the CPU's inputs, its fp32
    states within rtol = atol = 1e-3, bf16 caches and block output within
    1e-2, positions exact (run freely, a bf16 rounding flip in one layer
    would carry into the next layer's fp32 state); every RG-LRU layer of
    every call launches the kernel once."""
    import dataclasses

    cfg = dataclasses.replace(reduce_for_smoke(get_config("recurrentgemma-9b")), num_layers=5)
    gpu = build_model(cfg, device=cuda).init(torch.Generator(device=cuda).manual_seed(0))
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 16))
    calls = []
    hooks = [blk.register_forward_hook(lambda mod, args, out, i=i: calls.append((i, args, out)))
             for i, blk in enumerate(cpu.layers)]
    logits = []
    before = rg.rglru_scan.launches
    for m in (gpu, cpu):
        with torch.inference_mode():
            lg, c = m.prefill({"tokens": torch.as_tensor(tokens, device=m.device)},
                              m.init_cache(2, 18))
            out = [lg[:, 0]]
            for i in range(2):
                tok = torch.as_tensor(tokens[:, i], device=m.device)
                lg, c = m.decode_step(tok, c, 16 + i)
                out.append(lg)
        logits.append(out)
    for h in hooks:
        h.remove()
    n_rec = sum(t == "R" for t in cfg.layer_types())
    assert rg.rglru_scan.launches == before + 3 * n_rec
    for lg_g, lg_c in zip(*logits):
        torch.testing.assert_close(lg_g.float().cpu(), lg_c.float(), rtol=0, atol=2e-2)
    assert len(calls) == 3 * cfg.num_layers
    for i, (h, positions, state, pos), (h_out, st_out) in calls:
        with torch.inference_mode():
            got_h, got = gpu.layers[i](h.to(cuda), positions.to(cuda),
                                       {k: v.to(cuda) for k, v in state.items()}, pos)
        torch.testing.assert_close(got_h.cpu(), h_out, rtol=1e-2, atol=1e-2)
        for name, want in st_out.items():
            if want.dtype == torch.int32:
                assert torch.equal(got[name].cpu(), want), (i, name)
            else:
                tol = 1e-3 if want.dtype == torch.float32 else 1e-2
                torch.testing.assert_close(got[name].cpu(), want, rtol=tol, atol=tol)


#: (B, H, KV, S, T, D, causal, window, softcap): the reference's FA_CASES
#: (tests/test_kernels.py), ragged and edge shapes, and the serving prefill
#: shapes of gemma3-1b (4 heads, 1 KV head of 256; window 512 or none) and
#: recurrentgemma-9b (16 heads, 1 KV head of 256, window 2048)
#: the bf16 limit on ||out - plain|| / ||plain|| over the whole output. At
#: long shapes an output is about as small as the 2e-2 limit (query i
#: attends i keys of randn values: ~sqrt(e / i)), which alone would let a
#: dropped key tile through. The kernel keeps p to ~2^-18, so it and the
#: plain version differ where their roundings to bf16 of nearly equal fp32
#: values fall apart (one ulp of a few elements); rounding p once to bf16,
#: as the tensor-core kernel's first design did, comes to ~2e-3
FA_BF16_NORMWISE = 2.0 ** -10
FA_CASES = [
    (1, 4, 4, 128, 128, 64, True, None, 0.0),
    (2, 8, 2, 256, 256, 64, True, None, 0.0),
    (1, 4, 1, 256, 256, 128, True, None, 0.0),
    (1, 4, 4, 256, 256, 64, False, None, 0.0),
    (1, 4, 2, 512, 512, 64, True, 128, 0.0),
    (1, 2, 1, 384, 384, 64, True, 64, 0.0),
    (1, 4, 4, 256, 256, 64, True, None, 50.0),
    (2, 2, 2, 1024, 1024, 32, True, 256, 0.0),
    (3, 6, 3, 333, 333, 96, True, 77, 30.0),
    (2, 4, 1, 700, 700, 256, True, 512, 0.0),
    (2, 8, 2, 1, 1, 128, True, None, 0.0),
    (2, 8, 2, 1, 300, 128, False, None, 0.0),
    (1, 3, 1, 50, 70, 40, False, 9, 0.0),
    (1, 3, 1, 50, 70, 20, False, 9, 0.0),
    (8, 4, 1, 512, 512, 256, True, 512, 0.0),
    (8, 4, 1, 512, 512, 256, True, None, 0.0),
    (1, 4, 1, 8192, 8192, 256, True, 512, 0.0),
    (1, 4, 1, 8192, 8192, 256, True, None, 0.0),
    (8, 16, 1, 512, 512, 256, True, 2048, 0.0),
    (1, 16, 1, 3072, 3072, 256, True, 2048, 0.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_flash_kernel_matches_its_plain_version_on_the_card(cuda, case, dtype):
    """Within rtol = atol = 2e-5 (fp32) / 2e-2 (bf16), the reference's
    limits for its kernel against its oracle, and bf16 also normwise within
    FA_BF16_NORMWISE; each call launches once, bf16 with D % 8 == 0 on the
    tensor-core kernel, the rest on the CUDA-core kernel."""
    b, h, kv, s, t, d, causal, window, cap = case
    gen = torch.Generator(device=cuda).manual_seed(s * d + t)
    q = torch.randn((b, h, s, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, kv, t, d), generator=gen, device=cuda).to(dtype) for _ in range(2))
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    before = fa.flash_attention.launches, fa.flash_attention.tc_launches
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    tc = dtype == torch.bfloat16 and d % 8 == 0
    assert fa._route(dtype, d) == (fa.TENSOR_CORES if tc else fa.CUDA_CORES)
    assert fa.flash_attention.launches == before[0] + 1
    assert fa.flash_attention.tc_launches == before[1] + tc
    assert out.dtype == dtype and tuple(out.shape) == (b, h, s, d)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    want = flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(out, want, rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        o, w = out.float(), want.float()
        assert (o - w).norm().item() <= FA_BF16_NORMWISE * w.norm().item()


def test_flash_kernel_launches_nothing_for_an_empty_output(cuda):
    """B H S = 0 returns an empty output on either route without a launch;
    the tensor-core kernel refuses T = 0, the CUDA-core kernel gives zeros."""
    for dtype in (torch.bfloat16, torch.float32):
        before = fa.flash_attention.launches, fa.flash_attention.tc_launches
        q = torch.zeros((2, 4, 0, 64), dtype=dtype, device=cuda)
        k = torch.zeros((2, 2, 8, 64), dtype=dtype, device=cuda)
        assert fa.flash_attention(q, k, k).shape == (2, 4, 0, 64)
        assert (fa.flash_attention.launches, fa.flash_attention.tc_launches) == before
    q = torch.ones((1, 2, 5, 64), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 1, 0, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="T >= 1"):
        fa.flash_attention(q, k, k, causal=False)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q.float(), k.float(), k.float(), causal=False)
    assert fa.flash_attention.launches == before + 1 and not out.any()


def test_flash_kernel_window_one_and_unattended_queries(cuda):
    """On both kernels: window 1 returns v exactly; a query that no key may
    attend (S > T with a window) gets zeros, where the plain version gives
    the mean of v."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    for dtype, d, tol in ((torch.bfloat16, 64, 2e-2), (torch.float32, 64, 2e-5),
                          (torch.bfloat16, 256, 2e-2), (torch.float32, 32, 2e-5),
                          (torch.bfloat16, 32, 2e-2)):
        before = fa.flash_attention.tc_launches
        q = torch.randn((2, 4, 90, d), generator=gen, device=cuda).to(dtype)
        k, v = (torch.randn((2, 2, 90, d), generator=gen, device=cuda).to(dtype)
                for _ in range(2))
        assert torch.equal(fa.flash_attention(q, k, v, window=1), v.repeat_interleave(2, dim=1))
        q = torch.randn((1, 2, 16, d), generator=gen, device=cuda).to(dtype)
        k, v = (torch.randn((1, 1, 4, d), generator=gen, device=cuda).to(dtype) for _ in range(2))
        out = fa.flash_attention(q, k, v, causal=True, window=2)
        assert not out[:, :, 5:].any()
        want = flash_attention_ref(q, k, v, causal=True, window=2)
        torch.testing.assert_close(out[:, :, :5], want[:, :, :5], rtol=tol, atol=tol)
        assert fa.flash_attention.tc_launches == before + 2 * (dtype == torch.bfloat16)


#: the register-tiled CUDA-core kernel (64-query blocks, 64-key tiles):
#: S and T off every tile edge, every head-dim instance, GQA 4:1 and 8:2, a
#: window across tile edges, softcaps, non-causal, T = 0, and fp32 rows of 72
#: bytes (D = 18), which take the load path without cp.async (D = 20 rows
#: are 80 bytes, on 16 bytes)
FA_CUDA_CORE_CASES = [
    (1, 4, 1, 1, 1, 64, True, None, 0.0),
    (1, 4, 1, 63, 63, 64, True, None, 0.0),
    (1, 4, 1, 65, 65, 64, True, None, 0.0),
    (2, 8, 2, 333, 333, 128, True, None, 0.0),
    (1, 4, 1, 1000, 1000, 256, True, None, 0.0),
    (1, 4, 1, 130, 130, 20, True, None, 0.0),
    (1, 4, 1, 130, 130, 32, True, None, 0.0),
    (1, 4, 1, 130, 130, 96, True, None, 0.0),
    (2, 8, 2, 200, 200, 256, True, 77, 0.0),
    (1, 4, 1, 333, 333, 64, True, 77, 30.0),
    (1, 8, 2, 150, 150, 128, True, None, 50.0),
    (2, 4, 1, 65, 333, 64, False, None, 0.0),
    (1, 4, 1, 63, 1000, 256, False, 77, 0.0),
    (1, 4, 2, 5, 0, 64, False, None, 0.0),
    (1, 4, 1, 100, 100, 18, True, None, 0.0),
]


@pytest.mark.parametrize("case", FA_CUDA_CORE_CASES, ids=str)
def test_cuda_core_flash_kernel_matches_flash_attention_ref(cuda, case):
    """fp32 on the CUDA-core kernel within rtol = atol = 2e-5 of the plain
    version, one launch a call (T = 0: zeros)."""
    b, h, kv, s, t, d, causal, window, cap = case
    gen = torch.Generator(device=cuda).manual_seed(1000 + s * d + t)
    q = torch.randn((b, h, s, d), generator=gen, device=cuda)
    k, v = (torch.randn((b, kv, t, d), generator=gen, device=cuda) for _ in range(2))
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    assert fa._route(q.dtype, d) == fa.CUDA_CORES
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, **kw), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", [(1, 3, 1, 50, 70, 20, False, 9, 0.0),
                                  (2, 4, 2, 130, 130, 20, True, 77, 30.0)], ids=str)
def test_cuda_core_flash_kernel_takes_bf16_rows_off_16_bytes(cuda, case):
    """bf16 with D = 20 (40-byte rows) on the CUDA-core kernel, upcast on
    load, within rtol = atol = 2e-2 and normwise FA_BF16_NORMWISE."""
    b, h, kv, s, t, d, causal, window, cap = case
    gen = torch.Generator(device=cuda).manual_seed(s + t)
    q = torch.randn((b, h, s, d), generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn((b, kv, t, d), generator=gen, device=cuda).bfloat16() for _ in range(2))
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    assert fa._route(q.dtype, d) == fa.CUDA_CORES
    out = fa.flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(out, want, rtol=2e-2, atol=2e-2)
    o, w = out.float(), want.float()
    assert (o - w).norm().item() <= FA_BF16_NORMWISE * w.norm().item()


def test_cuda_core_flash_kernel_takes_inputs_off_16_bytes(cuda):
    """fp32 views that start 4 bytes past a 16-byte boundary take the plain
    load path: the same result as aligned copies, within 2e-5 of the plain
    version."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    shapes = [(2, 4, 150, 64), (2, 1, 150, 64), (2, 1, 150, 64)]
    views = []
    for shape in shapes:
        n = int(np.prod(shape))
        views.append(torch.randn(n + 1, generator=gen, device=cuda)[1:].view(shape))
    q, k, v = views
    assert all(t.is_contiguous() and t.data_ptr() % 16 == 4 for t in views)
    out = fa.flash_attention(q, k, v, window=77)
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, window=77), rtol=2e-5, atol=2e-5)
    assert torch.equal(out, fa.flash_attention(q.clone(), k.clone(), v.clone(), window=77))


def _waterfill_rows(C, seed, S=300):
    """caps with idle channels; pools that bind, exceed the caps' sum, are 0
    or are negative."""
    rng = np.random.RandomState(seed)
    caps = rng.uniform(0, 1e9, (S, C))
    caps[rng.uniform(size=caps.shape) < 0.3] = 0.0
    pool = rng.uniform(0, 1.0, S) * caps.sum(axis=1)
    pool[1::5] = caps[1::5].sum(axis=1) * 1.5 + 1.0
    pool[2::5] = 0.0
    pool[3::5] = -1.0 - caps[3::5].sum(axis=1)
    return torch.from_numpy(caps), torch.from_numpy(pool)


@pytest.mark.parametrize("C", [1, 3, 16, 17, 32, 33, 64, 1000])
def test_waterfill_kernel_runs_the_descent_bit_for_bit(cuda, C):
    """Rows of C <= 32 run the 32-way descent: the kernel's output equals its
    plain mirror's on the same inputs bit for bit; wider rows keep the
    halving chain, within 1e-12 of the plain version."""
    caps, pool = _waterfill_rows(C, seed=C)
    before = wf.waterfill_bisect.launches
    out = wf.waterfill_bisect(caps.to(cuda), pool.to(cuda)).cpu()
    assert wf.waterfill_bisect.launches == before + 1
    if C <= 32:
        assert torch.equal(out, wf.waterfill_descent_plain(caps, pool))
    torch.testing.assert_close(out, wf.waterfill_bisect_plain(caps, pool), rtol=1e-12, atol=0)


def test_resolve_device_keeps_fp32_products_out_of_tf32(cuda):
    """A caller's "high" precision would run fp32 matrix products in TF32;
    resolving the card sets them back to full fp32."""
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        assert torch.backends.cuda.matmul.allow_tf32
        assert resolve_device("cuda") == torch.device("cuda")
        assert torch.get_float32_matmul_precision() == "highest"
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    finally:
        torch.set_float32_matmul_precision(saved)


def _to(x, device):
    """A block argument (tensor, state dict or int) on ``device``."""
    if isinstance(x, dict):
        return {name: v.to(device) for name, v in x.items()}
    return x.to(device) if isinstance(x, torch.Tensor) else x


def test_dense_model_on_the_card_matches_its_cpu_run(cuda):
    """Prefill of 16 tokens (twice the window of 8) and two decode steps of
    the 6-layer gemma3 smoke model: free-running logits within atol 2e-2;
    every block call of the CPU run replayed on the card on the CPU's inputs,
    block output and k / v within rtol = atol = 1e-2; every prefill layer
    launches the flash kernel once, decode steps never."""
    cfg = reduce_for_smoke(get_config("gemma3-1b"))
    gpu = build_model(cfg, device=cuda).init(torch.Generator(device=cuda).manual_seed(0))
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 16))
    calls = []
    hooks = [blk.register_forward_hook(lambda mod, args, out, i=i: calls.append((i, args, out)))
             for i, blk in enumerate(cpu.layers)]
    logits = []
    before = fa.flash_attention.launches
    for m in (gpu, cpu):
        with torch.inference_mode():
            lg, c = m.prefill({"tokens": torch.as_tensor(tokens, device=m.device)},
                              m.init_cache(2, 18))
            out = [lg[:, 0]]
            for i in range(2):
                tok = torch.as_tensor(tokens[:, i], device=m.device)
                lg, c = m.decode_step(tok, c, 16 + i)
                out.append(lg)
        logits.append(out)
    for h in hooks:
        h.remove()
    assert fa.flash_attention.launches == before + cfg.num_layers
    for lg_g, lg_c in zip(*logits):
        torch.testing.assert_close(lg_g.float().cpu(), lg_c.float(), rtol=0, atol=2e-2)
    assert len(calls) == 3 * cfg.num_layers
    for i, args, (h_out, st_out) in calls:
        with torch.inference_mode():
            got_h, got = gpu.layers[i](*(_to(a, cuda) for a in args))
        torch.testing.assert_close(got_h.cpu(), h_out, rtol=1e-2, atol=1e-2)
        for name, want in st_out.items():
            torch.testing.assert_close(got[name].cpu(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "paligemma-3b", "whisper-base"])
def test_family_models_on_the_card_match_their_cpu_run(cuda, arch):
    """The MoE, VLM and encoder-decoder smoke models: prefill of 2 x 12
    tokens (with 8 seeded prefix rows or 16 frames) and two decode steps on
    the card and on the CPU: free-running logits within atol 2e-2; every
    block call of the CPU run replayed on the card on the CPU's inputs,
    block output and k / v within rtol = atol = 1e-2 (an MoE block's
    routing on the same input equal to the CPU's); every prefill attention
    launches the tensor-core flash kernel once, decode steps never."""
    cfg = reduce_for_smoke(get_config(arch))
    gpu = build_model(cfg, device=cuda).init(torch.Generator(device=cuda).manual_seed(0))
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, cfg.vocab_size, (2, 12))
    extra, offset = {}, 0
    if cfg.frontend == "vision_stub":
        extra = {"prefix_embed": torch.from_numpy(rng.randn(2, 8, cfg.d_model).astype(np.float32))}
        offset = cfg.num_prefix_tokens
    if cfg.is_encdec:
        extra = {"frames": torch.from_numpy(rng.randn(2, 16, cfg.d_model).astype(np.float32))}
    blocks = {id(m): [*m.encoder, *m.decoder] if cfg.is_encdec else list(m.layers)
              for m in (gpu, cpu)}
    calls, moe_in = [], []
    hooks = [blk.register_forward_hook(lambda mod, args, out, i=i: calls.append((i, args, out)))
             for i, blk in enumerate(blocks[id(cpu)])]
    hooks += [blk.moe.register_forward_hook(lambda mod, args, out: moe_in.append(args[0]))
              for blk in blocks[id(cpu)] if getattr(blk, "moe", None) is not None]
    logits = []
    before = (fa.flash_attention.launches, fa.flash_attention.tc_launches)
    for m in (gpu, cpu):
        batch = {"tokens": torch.as_tensor(tokens, device=m.device),
                 **{k: v.to(m.device) for k, v in extra.items()}}
        with torch.inference_mode():
            lg, c = m.prefill(batch, m.init_cache(2, offset + 14))
            out = [lg[:, 0]]
            for i in range(2):
                lg, c = m.decode_step(torch.as_tensor(tokens[:, i], device=m.device), c,
                                      offset + 12 + i)
                out.append(lg)
        logits.append(out)
    for h in hooks:
        h.remove()
    attentions = cfg.encoder_layers + cfg.num_layers * (2 if cfg.is_encdec else 1)
    assert (fa.flash_attention.launches, fa.flash_attention.tc_launches) == (
        before[0] + attentions, before[1] + attentions)
    for lg_g, lg_c in zip(*logits):
        torch.testing.assert_close(lg_g.float().cpu(), lg_c.float(), rtol=0, atol=2e-2)
    moe_x = iter(moe_in)
    for i, args, out in calls:
        block = blocks[id(gpu)][i]
        if getattr(block, "moe", None) is not None:
            x = next(moe_x)
            assert torch.equal(block.moe.route(x.to(cuda)).ids.cpu(),
                               blocks[id(cpu)][i].moe.route(x).ids)
        with torch.inference_mode():
            got = block(*(_to(a, cuda) for a in args))
        got_h, got_st = (got, {}) if isinstance(got, torch.Tensor) else got
        h_out, st_out = (out, {}) if isinstance(out, torch.Tensor) else out
        torch.testing.assert_close(got_h.cpu(), h_out, rtol=1e-2, atol=1e-2)
        for name, want in st_out.items():
            torch.testing.assert_close(got_st[name].cpu(), want, rtol=1e-2, atol=1e-2)


def test_dense_logits_make_no_fp32_vocab_buffer(cuda):
    """At gemma3-1b's width and vocabulary (262,144) and 8 x 512 tokens the
    fp32 (B, S, V) logits would be 4.3 GB; ``_logits`` (fp32 sums a
    vocabulary slice at a time, stored bf16) stays below that, and agrees
    with the whole-vocabulary fp32-then-cast product within one bf16 ulp
    plus the bound of the fp32 sums' order."""
    import dataclasses

    cfg = dataclasses.replace(get_config("gemma3-1b"), num_layers=1, layer_pattern="L")
    model = build_model(cfg, device=cuda).init(torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    h = torch.randn((8, 512, cfg.d_model), generator=g, device=cuda).to(torch.bfloat16)
    fp32_bytes = 8 * 512 * cfg.vocab_size * 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    logits = model._logits(h)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert logits.dtype == torch.bfloat16 and logits.shape == (8, 512, cfg.vocab_size)
    assert peak < fp32_bytes, (peak, fp32_bytes)
    hn = model.embed["final_norm"]
    from repro_torch.models import layers as L

    hn = L.rms_norm(h[:1], hn, cfg.norm_eps)
    table = L.cast(model.embed["tok"])
    old = torch.matmul(hn.float(), table.float().T).to(torch.bfloat16)
    mag = torch.matmul(hn.float().abs(), table.float().abs().T)
    e = torch.floor(torch.log2(old.float().abs().clamp(min=2.0 ** -126)))
    bound = torch.exp2(e - 7) + 2 * cfg.d_model * 2.0 ** -24 * mag
    assert bool(((logits[:1].float() - old.float()).abs() <= bound).all())


def _normwise(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.parametrize("case", [
    (2, 4, 1, 256, 256, 256, True, 128, 50.0, torch.bfloat16),
    (2, 8, 8, 64, 300, 64, False, None, 0.0, torch.bfloat16),
    (2, 4, 2, 96, 96, 64, True, 32, 0.0, torch.float32),
], ids=str)
def test_flash_function_gradients_on_the_card(cuda, case):
    """ops.FlashAttention on the card: the kernel forward (one launch, none
    in the backward) and kernels/backward.py's gradients against
    torch.autograd through the plain version on the same inputs; dq, dk, dv
    within 2^-7 normwise (bf16) or rtol 1e-5, atol 1e-6 (fp32)."""
    b, h, kv, s, t, d, causal, window, cap, dtype = case
    g = torch.Generator(device=cuda).manual_seed(s + t)
    q = torch.randn((b, h, s, d), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((b, kv, t, d), generator=g, device=cuda).to(dtype) for _ in range(2))
    do = torch.randn((b, h, s, d), generator=g, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = fa.flash_attention.launches
    out = ops.FlashAttention.apply(*leaves, causal, window, cap)
    assert fa.flash_attention.launches == before + 1
    got = torch.autograd.grad(out, leaves, do)
    assert fa.flash_attention.launches == before + 1
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*ref_leaves, **kw), ref_leaves, do)
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == w.shape
        if dtype == torch.bfloat16:
            assert _normwise(a, w) <= 2.0 ** -7, name
        else:
            torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-6, msg=name)


def test_scan_function_gradients_on_the_card(cuda):
    """ops.rwkv6_scan (with s0 and the final state's gradient, rtol = atol
    = 1e-4) and ops.rglru_scan (1e-5) on the card: the kernels forward, the
    backward functions' gradients against torch.autograd through the plain
    versions."""
    g = torch.Generator(device=cuda).manual_seed(0)

    def draw(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=cuda) * scale

    b, h, t, d = 2, 4, 64, 64
    r, k, v = (draw(b, t, h, d, scale=0.5) for _ in range(3))
    w = torch.exp(-torch.exp(draw(b, t, h, d, scale=0.5)))
    args = (r, k, v, w, draw(h, d, scale=0.5), draw(b, h, d, d, scale=0.1))
    dy, ds = draw(b, t, h, d), draw(b, h, d, d)
    before = wk.rwkv6_scan.launches
    leaves = [x.clone().requires_grad_() for x in args]
    got = torch.autograd.grad(ops.rwkv6_scan(*leaves), leaves, (dy, ds))
    assert wk.rwkv6_scan.launches == before + 1
    ref_leaves = [x.clone().requires_grad_() for x in args]
    y, s_last = rwkv6_scan_ref(*(x.transpose(1, 2) if i < 4 else x
                                 for i, x in enumerate(ref_leaves)))
    want = torch.autograd.grad((y.transpose(1, 2), s_last), ref_leaves, (dy, ds))
    for a, w_ in zip(got, want):
        torch.testing.assert_close(a, w_, rtol=1e-4, atol=1e-4)

    a = torch.sigmoid(draw(2, 64, 256))
    args = (a, draw(2, 64, 256, scale=0.5), draw(2, 256, scale=0.5))
    dh, dl = draw(2, 64, 256), draw(2, 256)
    before = rg.rglru_scan.launches
    leaves = [x.clone().requires_grad_() for x in args]
    got = torch.autograd.grad(ops.rglru_scan(*leaves), leaves, (dh, dl))
    assert rg.rglru_scan.launches == before + 1
    ref_leaves = [x.clone().requires_grad_() for x in args]
    want = torch.autograd.grad(rglru_scan_ref(*ref_leaves), ref_leaves, (dh, dl))
    for a, w_ in zip(got, want):
        torch.testing.assert_close(a, w_, rtol=1e-5, atol=1e-5)


def test_dense_train_step_on_the_card(cuda):
    """A 2-layer gemma3-1b at full width, one train step of 2 x 64 tokens
    on the card: every parameter's gradient finite and non-zero, one
    tensor-core flash launch a layer (none from the backward), the loss and
    gradients within the CPU run's limits (loss atol 2e-2, each leaf 2^-5
    normwise)."""
    import dataclasses

    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.train.train_step import loss_and_grads, to_device_batch, train_state

    cfg = dataclasses.replace(get_config("gemma3-1b"), num_layers=2, layer_pattern="LG")
    gpu = build_model(cfg, device=cuda).init(torch.Generator(device=cuda).manual_seed(0))
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    batch = next(SyntheticLM(cfg, DataConfig(global_batch=2, seq_len=64)).batches())
    before = (fa.flash_attention.launches, fa.flash_attention.tc_launches)
    loss, _, grads = loss_and_grads(gpu, train_state(gpu)["params"], to_device_batch(batch, cuda))
    assert (fa.flash_attention.launches - before[0],
            fa.flash_attention.tc_launches - before[1]) == (2, 2)
    want_loss, _, want = loss_and_grads(cpu, train_state(cpu)["params"],
                                        to_device_batch(batch, "cpu"))
    assert abs(float(loss) - float(want_loss)) <= 2e-2
    for name, gr in grads.items():
        assert bool(torch.isfinite(gr).all()) and bool(gr.any()), name
        assert _normwise(gr.cpu(), want[name]) <= 2.0 ** -5, name


def _card_states_equal(model_a, state_a, model_b, state_b):
    from repro_torch.train.train_step import state_tree

    def leaves(model, state):
        tree = state_tree(model, state)
        out = {("params", n): p for n, p in model.named_parameters()}
        for part in ("m", "v"):
            out.update({(part, n): t for n, t in state["opt"][part].items()})
        out["count"], out["step"] = tree["opt"]["count"], tree["step"]
        return out

    a, b = leaves(model_a, state_a), leaves(model_b, state_b)
    assert a.keys() == b.keys()
    return [k for k in a if not (a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]))]


def test_train_state_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A smoke gemma3-1b's train state after two steps on the card, saved
    from the card and restored into a fresh card model's state: every
    parameter, moment, the count and the step bit for bit."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.train.train_step import (StepConfig, init_train_state, make_train_step,
                                              put_state_tree, state_tree)

    cfg = reduce_for_smoke(get_config("gemma3-1b"))
    model = build_model(cfg, device=cuda)
    state = init_train_state(model, torch.Generator(device=cuda).manual_seed(0))
    step = make_train_step(model, StepConfig())
    for batch in SyntheticLM(cfg, DataConfig(global_batch=2, seq_len=32)).batches(2):
        state, _ = step(state, batch)
    ckpt.save(state_tree(model, state), str(tmp_path), 2)
    loaded, at = ckpt.restore(str(tmp_path))
    fresh = build_model(cfg, device=cuda)
    fresh_state = put_state_tree(fresh, init_train_state(
        fresh, torch.Generator(device=cuda).manual_seed(1)), loaded)
    assert at == 2 and int(fresh_state["step"]) == 2
    assert all(p.device.type == cuda.type for p in fresh.parameters())
    assert _card_states_equal(model, state, fresh, fresh_state) == []


def test_crash_resume_on_the_card_bit_for_bit(cuda, tmp_path):
    """A smoke gemma3-1b trained 6 steps on the card straight, and crashed
    at step 4 then resumed from its step-3 checkpoint (asynchronous): the
    final states bit for bit, and the resumed steps' losses."""
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.train_step import StepConfig

    cfg = reduce_for_smoke(get_config("gemma3-1b"))
    data = SyntheticLM(cfg, DataConfig(global_batch=2, seq_len=32))
    lc = dict(total_steps=6, ckpt_every=3, async_ckpt=True, log_every=1)
    straight_model = build_model(cfg, device=cuda)
    straight = train(straight_model, StepConfig(), Prefetcher(data.batches()), LoopConfig(**lc))
    with pytest.raises(RuntimeError, match="injected crash at step 4"):
        train(build_model(cfg, device=cuda), StepConfig(), Prefetcher(data.batches()),
              LoopConfig(ckpt_dir=str(tmp_path), **lc), crash_at=4)
    model = build_model(cfg, device=cuda)
    resumed = train(model, StepConfig(), Prefetcher(data.batches()),
                    LoopConfig(ckpt_dir=str(tmp_path), **lc))
    assert [h["step"] for h in resumed["history"]] == [4, 5, 6]
    assert [h["loss"] for h in resumed["history"]] == [
        h["loss"] for h in straight["history"][3:]]
    assert _card_states_equal(straight_model, straight["state"], model, resumed["state"]) == []
