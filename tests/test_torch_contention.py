"""The port's fleet contention report against the reference's
(``tests/golden/contention_tenant.json``, written by
``tests/make_contention_golden.py`` from the reference's NumPy run).

The small case (``tenant_matrix(n_groups=2)``, 4 candidates: 10 rows, 266
oracle evaluations) runs on the split route with the closed-form
water-fill, the reference NumPy driver's arithmetic, and must equal the
golden within 1e-9 relative: every aggregate, per-algorithm and per-group
number, the oracle's evaluation count and its chosen settings.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

import repro_torch.eval.tune.contention as contention
from repro_torch.eval.runner import run_matrix
from repro_torch.eval.scenarios import smoke_matrix, tenant_matrix
from repro_torch.eval.tune import ContentionReport, contention_report

GOLDEN = Path(__file__).resolve().parent / "golden" / "contention_tenant.json"
RTOL = 1e-9


@pytest.fixture(scope="module")
def small_report():
    """The small case on the CPU's closed-form split route (one intra-op
    thread: the sweep runs thousands of small torch ops)."""
    case = json.loads(GOLDEN.read_text())["cases"]["small"]

    def closed(scenarios, **kw):
        return run_matrix(scenarios, fused_step="none", waterfill_impl="closed", **kw)

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    orig, contention.run_matrix = contention.run_matrix, closed
    try:
        report = contention_report(
            tenant_matrix(n_groups=case["n_groups"]), device="cpu",
            n_candidates=case["n_candidates"],
        )
    finally:
        contention.run_matrix = orig
        torch.set_num_threads(n)
    return report, case["report"]


def _pairs(a, b):
    out = [(a["aggregate"][k], b["aggregate"][k]) for k in b["aggregate"]]
    for algo, agg in b["per_algorithm"].items():
        out += [(a["per_algorithm"][algo][k], agg[k]) for k in agg]
    for x, y in zip(a["per_group"], b["per_group"]):
        out += [(x[k], y[k]) for k in ("heuristic_bps", "oracle_bps", "isolated_bps", "regret",
                                       "contention_factor", "tenants", "links")]
    return out


def test_small_report_equals_the_golden(small_report):
    report, golden = small_report
    a = report.to_json()
    assert a["candidates"] == golden["candidates"]
    assert a["aggregate"]["oracle_evals"] == golden["aggregate"]["oracle_evals"] == 266
    assert [g["group"] for g in a["per_group"]] == [g["group"] for g in golden["per_group"]]
    for x, y in zip(a["per_group"], golden["per_group"]):
        assert x["oracle_params"] == y["oracle_params"]
        assert x["algorithms"] == y["algorithms"]
    worst = max(abs(x - y) / max(abs(y), 1e-300) for x, y in _pairs(a, golden))
    assert worst <= RTOL, worst


def test_report_structure_and_summary(small_report):
    report, _ = small_report
    assert isinstance(report, ContentionReport)
    agg = report.aggregate
    assert agg["groups"] == 2 and agg["tenants"] == 10
    assert agg["tenants"] == sum(g["tenants"] for g in report.per_group)
    for g in report.per_group:
        # coupling only takes capacity away: the fleet never beats the same
        # tenants in isolation
        assert g["contention_factor"] <= 1.0 + 1e-9
        assert len(g["oracle_params"]) == g["tenants"]
    summary = report.summary()
    json.dumps(summary)
    assert summary["regret_median"] == agg["regret_median"]
    assert set(summary["regret_median_by_algorithm"]) == {"sc", "mc", "promc", "static"}


def test_report_refuses_an_uncoupled_matrix():
    with pytest.raises(ValueError, match="coupled"):
        contention_report(smoke_matrix()[:2], device="cpu")


def test_candidate_grid_equals_the_reference():
    """Each tenant's candidates (its Algorithm-1 point snapped to the grid
    and the axis neighbours) are the reference's."""
    from repro.eval.scenarios import tenant_matrix as ref_tenant_matrix
    from repro.eval.tune.contention import _candidate_grid as ref_grid

    for sc, rsc in zip(tenant_matrix(n_groups=6), ref_tenant_matrix(n_groups=6)):
        for n in (4, 8):
            assert contention._candidate_grid(sc, n) == ref_grid(rsc, n)


def test_cli_prints_the_summary(capsys):
    """``python -m repro_torch.eval.tune.contention`` on one group, on the
    event backend (the CPU's quickest leg)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert contention.main(["--groups", "1", "--candidates", "2", "--backend", "event"]) == 0
    finally:
        torch.set_num_threads(n)
    out = json.loads(capsys.readouterr().out)
    assert out["groups"] == 1 and out["backend"] == "event" and out["wall_s"] > 0
