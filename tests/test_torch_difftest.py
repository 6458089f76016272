"""The port's difftest on the CPU: the batched sweep on each route (the
kernels' plain versions) held to the port's event simulator, the
harness's reporting, and the runner's event legs.

Limits: every route within the harness's 2% on every row (the worst is
printed; it is 0 on the smoke matrix); the split route with the
closed-form water-fill within 1e-12 relative of the event leg.
"""
from __future__ import annotations

import pytest

from repro_torch.core.simulator import SimResult
from repro_torch.eval import difftest
from repro_torch.eval.runner import run_built, run_matrix, run_scenario, run_simulations
from repro_torch.eval.scenarios import build_simulation, smoke_matrix

LEGS = list(difftest.ROUTES) + ["none-closed"]


@pytest.fixture(scope="module")
def smoke_cache():
    scs = smoke_matrix()
    return scs, {"event": run_matrix(scs, backend="event")}


@pytest.mark.parametrize("leg", LEGS)
def test_smoke_matrix_agreement(leg, smoke_cache):
    scs, cache = smoke_cache
    reports = difftest.diff_backend(scs, leg, device="cpu", results_cache=cache)
    assert len(reports) == len(scs)
    assert all(r.reference == "event" and r.backend == leg for r in reports)
    worst = max(r.rel_err for r in reports)
    differ = difftest.event_count_differences(scs, cache["event"], cache[leg])
    print(f"{leg}: worst rel_err {worst:.3e}, {len(differ)} rows count other events: {differ}")
    assert worst <= difftest.DEFAULT_RTOL
    if leg == "none-closed":
        assert worst <= 1e-12
        for e, b in zip(cache["event"], cache[leg]):
            assert abs(b.total_time - e.total_time) <= 1e-12 * e.total_time
            assert b.total_bytes == e.total_bytes


def test_each_leg_runs_once_and_the_pairings_reuse_it(monkeypatch, smoke_cache):
    scs, _ = smoke_cache
    calls = []
    real = difftest.run_leg

    def counted(scenarios, leg, device=None):
        calls.append(leg)
        return real(scenarios, leg, device)

    monkeypatch.setattr(difftest, "run_leg", counted)
    cache: dict = {}
    for leg in ("rounds", "none-closed"):
        difftest.diff_backend(scs[:6], leg, device="cpu", results_cache=cache)
    assert calls == ["event", "rounds", "none-closed"]


def test_diff_matrix_pairs_the_two_legs():
    scs = smoke_matrix()[:4]
    reports = difftest.diff_matrix(scs, backend="kernel", device="cpu")
    assert [r.scenario for r in reports] == [s.name for s in scs]
    assert all(r.ok() for r in reports)
    with pytest.raises(ValueError, match="unknown leg"):
        difftest.run_leg(scs, "jax")


def _result(throughput, n_events=10):
    return SimResult("n", "s", 1.0, 1.0 / throughput, throughput, {}, {}, [], n_events, 0)


def test_assert_agreement_reports_all_violators():
    scs = smoke_matrix()[:4]
    ref = [_result(100.0) for _ in scs]
    test = [_result(100.0), _result(150.0), _result(100.5), _result(10.0, n_events=11)]
    reports = difftest.pair_results(scs, ref, test, backend="rounds")
    assert [round(r.rel_err, 6) for r in reports] == [0.0, 0.5, 0.005, 0.9]
    with pytest.raises(AssertionError) as exc:
        difftest.assert_agreement(reports)
    msg = str(exc.value)
    assert "2/4 scenarios exceed rtol=2.000%" in msg
    assert scs[1].name in msg and scs[3].name in msg
    assert scs[0].name not in msg and scs[2].name not in msg
    # worst first
    assert msg.index(scs[3].name) < msg.index(scs[1].name)
    difftest.assert_agreement(reports, rtol=1.0)
    assert difftest.event_count_differences(scs, ref, test) == [(scs[3].name, 10, 11)]


def test_cli_on_the_cpu(capsys):
    assert difftest.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "difftest OK: route=rounds matrix=smoke (32 scenarios, worst rel_err" in out
    assert difftest.main(
        ["--matrix", "default", "--sample", "12", "--sample-seed", "3", "--device", "cpu",
         "--route", "none", "--closed"]
    ) == 0
    out = capsys.readouterr().out
    assert "route=none matrix=default[sample 12] (12 scenarios" in out
    assert "route=none-closed matrix=default[sample 12]" in out


def test_cli_fails_on_a_violation(monkeypatch):
    real = difftest.run_leg

    def doctored(scenarios, leg, device=None):
        out = real(scenarios, leg, device)
        if leg == "kernel":
            out[0].throughput *= 1.5
        return out

    monkeypatch.setattr(difftest, "run_leg", doctored)
    with pytest.raises(AssertionError, match="1/32 scenarios exceed"):
        difftest.main(["--smoke", "--device", "cpu", "--route", "kernel"])


def test_event_legs_of_the_runner():
    scs = smoke_matrix()[:5]
    direct = [build_simulation(sc).run() for sc in scs]
    for out in (
        run_matrix(scs, backend="event"),
        [run_scenario(sc) for sc in scs],
        run_built([(lambda sc=sc: build_simulation(sc)) for sc in scs]),
        run_simulations([build_simulation(sc) for sc in scs]),
    ):
        assert [(r.n_events, r.total_time, r.throughput) for r in out] == [
            (r.n_events, r.total_time, r.throughput) for r in direct
        ]
    batch = run_scenario(scs[0], backend="batch", device="cpu")
    assert abs(batch.throughput - direct[0].throughput) <= 1e-12 * direct[0].throughput
    with pytest.raises(NotImplementedError, match="columnar plans only"):
        run_built([lambda: build_simulation(scs[0])], backend="batch")
    with pytest.raises(NotImplementedError, match="columnar plans only"):
        run_simulations([build_simulation(scs[0])], backend="batch")
    with pytest.raises(ValueError, match="takes no device"):
        run_matrix(scs, device="cpu", backend="event")
    with pytest.raises(ValueError, match="unknown backend"):
        run_matrix(scs, backend="numpy")
