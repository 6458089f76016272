"""The smoke matrix end to end through the port on the CPU (the kernels'
plain versions), held against the NumPy reference driver and the golden
snapshot ``tests/golden/eval_smoke.json``.

Tolerances: the golden's own rtol 1e-6 on every route; ``total_bytes``
exact everywhere; the split route with the closed-form water-fill runs
the reference's arithmetic and is held to 1e-12 relative (it is in fact
bit-identical on the CPU). The bisected level of the kernel routes
differs from the closed form by ~1e-12, so those routes are held to the
golden's rtol."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from repro.eval.fabric.plan import build_plan as ref_build_plan
from repro.eval.runner import run_matrix as ref_run_matrix
from repro.eval.scenarios import smoke_matrix as ref_smoke_matrix
from repro_torch.eval.fabric.driver import SweepStats, TorchFabricSimulation
from repro_torch.eval.fabric.plan import from_reference_arrays
from repro_torch.eval.runner import (
    compare_golden,
    load_golden,
    metrics_snapshot,
    run_matrix,
)
from repro_torch.eval.scenarios import smoke_matrix

GOLDEN = Path(__file__).resolve().parent / "golden" / "eval_smoke.json"

#: (fused_step, waterfill_impl): the loop kernel's route (the default),
#: the one-step fused kernel's route, split route through the bisected
#: water-fill kernel, split route through the closed form
ROUTES = [("rounds", "kernel"), ("kernel", "kernel"), ("none", "kernel"), ("none", "closed")]


@pytest.fixture(scope="module")
def reference():
    return ref_run_matrix(ref_smoke_matrix(), backend="numpy")


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("fused,waterfill", ROUTES)
def test_smoke_matrix_matches_golden_and_reference(fused, waterfill, reference):
    scs = smoke_matrix()
    assert [s.name for s in scs] == [s.name for s in ref_smoke_matrix()]
    stats = SweepStats()
    out = run_matrix(scs, device="cpu", fused_step=fused, waterfill_impl=waterfill, stats=stats)
    devs = compare_golden(load_golden(str(GOLDEN)), metrics_snapshot(scs, out))
    assert devs == []
    assert [r.total_bytes for r in out] == [r.total_bytes for r in reference]
    if fused != "none":
        assert stats.fused > 0
    else:
        assert stats.fused == 0 and stats.split == stats.sweeps > 0
        assert [r.n_moves for r in out] == [r.n_moves for r in reference]
    if waterfill == "closed":
        for o, r in zip(out, reference):
            assert _rel(o.total_time, r.total_time) <= 1e-12
            assert _rel(o.throughput, r.throughput) <= 1e-12
            for name, b in r.per_chunk_bytes.items():
                assert abs(o.per_chunk_bytes[name] - b) <= 1e-12 * max(b, 1.0)
            assert o.n_events == r.n_events
    for o, r in zip(out, reference):
        assert o.network == r.network and o.scheduler == r.scheduler
        assert list(o.per_chunk_time) == list(r.per_chunk_time)


def test_reference_plan_columns_drive_the_port_like_the_reference(reference):
    """Identical state in, identical results out: the reference plan's
    numpy columns, carried over with ``from_reference_arrays``."""
    from test_torch_fabric import reference_arrays

    ref_plan = ref_build_plan(ref_smoke_matrix())
    drv = TorchFabricSimulation(
        from_reference_arrays(reference_arrays(ref_plan)), device="cpu",
        fused_step="none", waterfill_impl="closed",
    )
    out = drv.run()
    for o, r in zip(out, reference):
        assert o.total_time == r.total_time and o.n_moves == r.n_moves
        np.testing.assert_array_equal(
            list(o.per_chunk_bytes.values()), list(r.per_chunk_bytes.values())
        )


def test_driver_raises_on_a_row_past_max_time():
    from repro_torch.eval.fabric.plan import build_plan

    drv = TorchFabricSimulation(build_plan(smoke_matrix()[:3]), device="cpu")
    drv.start()
    drv.step()
    # the default route runs rows 0 and 1 to their end in its first round
    live = int(torch.nonzero(~drv.done)[0])
    drv.max_time[live] = 0.0
    with pytest.raises(RuntimeError, match="exceeded max_time"):
        drv.step()


def test_compacting_batch_with_timelines_matches_the_reference():
    """A batch wide enough to compact (> 64 rows), a third of its rows
    recording timelines, on the closed-form split route: bit-identical to
    the NumPy reference, except the timeline's aggregate rates, row sums
    taken in another order (1e-12 relative)."""
    import dataclasses

    from repro.eval.scenarios import default_matrix as ref_default_matrix
    from repro_torch.eval.fabric.plan import build_plan
    from repro_torch.eval.scenarios import default_matrix

    pick = list(range(0, 276, 3))
    scs = [dataclasses.replace(default_matrix()[i], record_timeline=i % 2 == 0) for i in pick]
    ref_scs = [
        dataclasses.replace(ref_default_matrix()[i], record_timeline=i % 2 == 0) for i in pick
    ]
    ref = ref_run_matrix(ref_scs, backend="numpy")
    drv = TorchFabricSimulation(
        build_plan(scs), device="cpu", fused_step="none", waterfill_impl="closed"
    )
    out = drv.run()
    assert drv.S < len(scs)  # rows retired by compaction
    for o, r in zip(out, ref):
        assert o.total_time == r.total_time and o.n_events == r.n_events
        assert [t for t, _ in o.timeline] == [t for t, _ in r.timeline]
        np.testing.assert_allclose(
            [x for _, x in o.timeline], [x for _, x in r.timeline], rtol=1e-12, atol=0
        )
    assert sum(len(o.timeline) > 0 for o in out) == sum(s.record_timeline for s in scs)
