"""The port's autotuner (``repro_torch.eval.tune``) on the CPU against the
reference implementation's (``repro.eval.tune`` on its NumPy backend).

Limits, each from the reference or the arithmetic:
* the search space and candidate sets: equal (integers);
* the smoke oracle at 16 candidates: throughputs within 1e-9 relative
  (the routes' agreement; 3.96e-16 seen); ``best_params`` the
  reference's wherever its top two differ by more than 1e-9 relative,
  else one of its tied set (most contexts have exact ties at the top);
* successive halving at 64 candidates on the smoke grid: the reference's
  evaluation counts (2,703, 453.4 at full fidelity) and kept sets at
  every rung, where a kept set may differ only at a near-tie (scores
  within 1e-12 relative, named), and every context within 0.95 of the
  oracle (the reference's own bar, ``tests/test_tune.py``);
* hill climbing: the reference's walk and evaluation count (507 on the
  whole smoke grid);
* the regret report's aggregates within 1e-9, static rows left out;
* history stores and saved reports: the reference's JSON format, read
  across the two packages.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from repro.eval import tune as ref_tune
from repro.eval.runner import run_matrix as ref_run_matrix
from repro.eval.scenarios import full_matrix as ref_full_matrix
from repro.eval.scenarios import smoke_matrix as ref_smoke_matrix
from repro_torch.eval import runner, tune
from repro_torch.eval.fabric.driver import SweepStats
from repro_torch.eval.scenarios import full_matrix, smoke_matrix

TABLE_RTOL = 1e-9
TIE_RTOL = 1e-9
KEEP_TIE_RTOL = 1e-12
GRIDS = {"smoke": (smoke_matrix, ref_smoke_matrix), "full": (full_matrix, ref_full_matrix)}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.fixture(scope="module")
def oracle16():
    stats = SweepStats()
    port = tune.oracle_search(smoke_matrix(), device="cpu", n_candidates=16, stats=stats)
    ref = ref_tune.oracle_search(ref_smoke_matrix(), backend="numpy", n_candidates=16)
    return port, ref, stats


@pytest.fixture(scope="module")
def sha64():
    port = tune.successive_halving(smoke_matrix(), device="cpu", n_candidates=64)
    ref = ref_tune.successive_halving(ref_smoke_matrix(), backend="numpy", n_candidates=64)
    return port, ref


@pytest.fixture(scope="module")
def smoke_oracle64():
    return tune.oracle_search(smoke_matrix(), device="cpu", n_candidates=64)


@pytest.fixture(scope="module")
def hill_whole():
    return tune.hill_climb(smoke_matrix(), device="cpu", n_candidates=64)


# ---------------------------------------------------------------------- #
# search space
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_scenario_space_equals_the_reference(grid):
    port_grid, ref_grid = GRIDS[grid]
    keys, reps = tune.group_contexts(port_grid())
    _, ref_reps = ref_tune.oracle.group_contexts(ref_grid())
    assert list(ref_reps) == keys
    for key in keys:
        for n in (16, 64):
            got = tune.scenario_space(reps[key], n_candidates=n)
            want = ref_tune.scenario_space(ref_reps[key], n_candidates=n)
            assert (got.pp_axis, got.par_axis, got.cc_axis) == (
                want.pp_axis, want.par_axis, want.cc_axis
            ), key
        a1 = tune.algorithm1_params(reps[key])
        r1 = ref_tune.algorithm1_params(ref_reps[key])
        assert (a1.pipelining, a1.parallelism, a1.concurrency) == (
            r1.pipelining, r1.parallelism, r1.concurrency
        )


def test_axis_sizes_and_space_walk_equal_the_reference():
    from repro.eval.tune.space import axis_sizes as ref_axis_sizes

    for n in range(1, 300):
        assert tune.axis_sizes(n) == ref_axis_sizes(n)
    sp = tune.scenario_space(smoke_matrix()[0])
    ref_sp = ref_tune.scenario_space(ref_smoke_matrix()[0])
    for idx in [(0, 0, 0), tuple(s - 1 for s in sp.shape), (1, 1, 1)]:
        assert sp.neighbors(idx) == ref_sp.neighbors(idx)
    p = sp.params_at((1, 0, 1))
    assert sp.nearest(p) == ref_sp.nearest(p) == (1, 0, 1)


@pytest.mark.parametrize("n", [16, 64])
def test_candidate_lists_equal_the_reference_on_the_smoke_grid(n):
    keys, _, cands = tune.candidate_lists(smoke_matrix(), n_candidates=n)
    ref_keys, _, ref_cands = ref_tune.oracle.candidate_lists(ref_smoke_matrix(), n_candidates=n)
    assert keys == ref_keys and cands == ref_cands


# ---------------------------------------------------------------------- #
# oracle
# ---------------------------------------------------------------------- #


def _tied(table, rtol):
    best = table.best_throughput
    return {c for c, t in zip(table.candidates, table.throughputs) if t >= best * (1 - rtol)}


def test_smoke_oracle_matches_the_reference(oracle16):
    port, ref, stats = oracle16
    assert port.evals == ref.evals == 519
    assert list(port.tables) == list(ref.tables)
    worst = 0.0
    for key, want in ref.tables.items():
        got = port.tables[key]
        assert got.candidates == want.candidates
        worst = max(worst, max(_rel(a, b) for a, b in zip(got.throughputs, want.throughputs)))
        top = sorted(want.throughputs, reverse=True)
        if len(top) > 1 and _rel(top[0], top[1]) > TIE_RTOL:
            assert got.best_params == want.best_params, key
        else:
            assert got.best_params in _tied(want, TIE_RTOL), key
    assert worst <= TABLE_RTOL
    assert [(e.scenario, e.context, e.n_candidates) for e in port.entries] == [
        (e.scenario, e.context, e.n_candidates) for e in ref.entries
    ]
    assert stats.host_transitions == 0 and stats.steps > 0


# ---------------------------------------------------------------------- #
# successive halving and hill climbing
# ---------------------------------------------------------------------- #


def _keep_near_ties(port_rung, ref_rung):
    """Where two kept sets differ: the (port-only, reference-only)
    candidates and their scores in the port's rung, which must lie within
    ``KEEP_TIE_RTOL`` of each other."""
    mine = set(port_rung["kept"]) - set(ref_rung["kept"])
    theirs = set(ref_rung["kept"]) - set(port_rung["kept"])
    scores = port_rung["scores"]
    return [(a, b, scores[a], scores[b]) for a in mine for b in theirs]


def test_successive_halving_matches_the_reference(sha64, smoke_oracle64):
    port, ref = sha64
    assert (port.evals, ref.evals) == (2703, 2703)
    assert port.equivalent_evals == ref.equivalent_evals
    assert round(port.equivalent_evals, 1) == 453.4
    ties = []
    for key, ref_rungs in ref.trace.items():
        rungs = port.trace[key]
        assert [r["evaluated"] for r in rungs] == [r["evaluated"] for r in ref_rungs]
        for got, want in zip(rungs, ref_rungs):
            assert _rel(got["best_throughput"], want["best_throughput"]) <= TABLE_RTOL
            if got["kept"] != want["kept"]:
                pairs = _keep_near_ties(got, want)
                ties.append((key, got["rung"], pairs))
                assert pairs and all(_rel(x, y) <= KEEP_TIE_RTOL for _, _, x, y in pairs), (
                    f"{key} rung {got['rung']}: kept sets differ off a tie: {pairs}"
                )
    print(f"kept sets that differ at a near-tie: {ties}")
    best = {e.context: e.best_throughput for e in smoke_oracle64.entries}
    ratios = [e.best_throughput / best[e.context] for e in port.entries]
    assert min(ratios) >= 0.95
    assert min(ratios) == pytest.approx(0.99793, abs=1e-5)


@pytest.mark.parametrize("n_rows,evals", [(6, None), (None, 507)], ids=["slice6", "whole"])
def test_hill_climb_matches_the_reference(n_rows, evals, hill_whole):
    scs, ref_scs = smoke_matrix()[:n_rows], ref_smoke_matrix()[:n_rows]
    if n_rows is None:
        port = hill_whole
    else:
        port = tune.hill_climb(scs, device="cpu", n_candidates=64)
    ref = ref_tune.hill_climb(ref_scs, backend="numpy", n_candidates=64)
    assert port.evals == ref.evals
    if evals is not None:
        assert port.evals == evals
    for key, its in ref.trace.items():
        assert [it["current"] for it in port.trace[key]] == [it["current"] for it in its], key
        assert port.tables[key].candidates == ref.tables[key].candidates
    for got, want in zip(port.entries, ref.entries):
        assert got.best_params == want.best_params
        assert _rel(got.best_throughput, want.best_throughput) <= TABLE_RTOL


def test_hill_climb_stays_within_the_bar_on_the_smoke_grid(smoke_oracle64, hill_whole):
    hill = hill_whole
    best = {e.context: e.best_throughput for e in smoke_oracle64.entries}
    assert min(e.best_throughput / best[e.context] for e in hill.entries) >= 0.95
    assert hill.evals < smoke_oracle64.evals


# ---------------------------------------------------------------------- #
# history
# ---------------------------------------------------------------------- #


def test_history_files_read_across_the_packages(tmp_path):
    sc, ref_sc = smoke_matrix()[0], ref_smoke_matrix()[0]
    port_path, ref_path = tmp_path / "port.json", tmp_path / "ref.json"
    store = tune.HistoryStore(str(port_path))
    assert store.seed(sc) is None
    assert store.record(sc, (8, 2, 4), 1.5e9, method="oracle")
    assert not store.record(sc, (0, 1, 1), 1.0e9, method="sha")
    store.save()
    ref_store = ref_tune.HistoryStore(str(port_path))
    assert ref_store.seed(ref_sc).concurrency == 4 and ref_store.best_throughput(ref_sc) == 1.5e9
    assert ref_store.record(ref_sc, (16, 4, 8), 2.0e9, method="hill")
    ref_store.save(str(ref_path))
    back = tune.HistoryStore(str(ref_path))
    seed = back.seed(sc)
    assert (seed.pipelining, seed.parallelism, seed.concurrency) == (16, 4, 8)
    assert json.loads(ref_path.read_text())["version"] == 1
    # the same winners give the same file
    same = [tmp_path / "a.json", tmp_path / "b.json"]
    for cls, path, row in ((tune.HistoryStore, same[0], sc),
                           (ref_tune.HistoryStore, same[1], ref_sc)):
        st = cls(str(path))
        st.record(row, (8, 2, 4), 1.5e9, method="oracle")
        st.save()
    assert same[0].read_text() == same[1].read_text()
    assert tune.history_key(sc) == ref_tune.history_key(ref_sc)


def test_history_warm_start_reduces_hill_evaluations(tmp_path):
    scs = smoke_matrix()[:4]
    cold = tune.hill_climb(scs, device="cpu", n_candidates=16)
    store = tune.HistoryStore(str(tmp_path / "w.json"))
    for key, table in cold.tables.items():
        rep = next(sc for sc in scs if tune.context_key(sc) == key)
        store.record(rep, table.best_params, table.best_throughput, "hill")
    warm = tune.hill_climb(scs, device="cpu", n_candidates=16, history=store)
    assert warm.evals < cold.evals
    for c, w in zip(cold.entries, warm.entries):
        assert w.best_throughput >= c.best_throughput * (1 - 1e-12)


# ---------------------------------------------------------------------- #
# regret report and its JSON
# ---------------------------------------------------------------------- #


def _with_static(scs):
    return scs + [dataclasses.replace(scs[0], algorithm="static", static_params=(1, 1, 1))]


def _reports(oracle16):
    port, ref, _ = oracle16
    scs, ref_scs = _with_static(smoke_matrix()), _with_static(ref_smoke_matrix())
    heur = runner.run_matrix(scs, device="cpu")
    ref_heur = ref_run_matrix(ref_scs, backend="numpy")
    return (tune.regret_report(scs, heur, port), port,
            ref_tune.regret_report(ref_scs, ref_heur, ref), ref)


def test_regret_report_matches_the_reference(oracle16):
    got, _, want, _ = _reports(oracle16)
    assert len(got.per_scenario) == len(want.per_scenario) == len(smoke_matrix())
    assert all(row["algorithm"] != "static" for row in got.per_scenario)
    assert sorted(got.per_algorithm) == sorted(want.per_algorithm)
    for algo, agg in want.per_algorithm.items():
        for field, value in agg.items():
            assert _rel(got.per_algorithm[algo][field], value) <= 1e-9 or \
                abs(got.per_algorithm[algo][field] - value) <= 1e-12, (algo, field)
    assert got.format_table().splitlines()[0] == want.format_table().splitlines()[0]


def _key_tree(obj):
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return [_key_tree(obj[0])]
    return type(obj).__name__


def test_save_report_writes_the_reference_format(oracle16, tmp_path):
    got, port, want, ref = _reports(oracle16)
    tune.save_report(str(tmp_path / "port.json"), got, port)
    ref_tune.save_report(str(tmp_path / "ref.json"), want, ref)
    a = json.loads((tmp_path / "port.json").read_text())
    b = json.loads((tmp_path / "ref.json").read_text())
    assert _key_tree(a) == _key_tree(b)
    assert a["tables"].keys() == b["tables"].keys()
    assert a["search"]["evals"] == b["search"]["evals"]


# ---------------------------------------------------------------------- #
# the CLI and the event backend
# ---------------------------------------------------------------------- #


def test_cli_tune_successive_halving_on_the_smoke_grid(tmp_path, capsys):
    report, history = tmp_path / "regret.json", tmp_path / "history.json"
    argv = ["--tune", "sha", "--matrix", "smoke", "--device", "cpu",
            "--regret-out", str(report), "--history", str(history)]
    assert runner.main(argv) == 0
    out = capsys.readouterr().out
    assert "tune[sha]: 32 scenarios" in out and "2703 candidate evaluations" in out
    assert "0 host transitions" in out
    assert "algorithm" in out and "promc" in out
    assert json.loads(report.read_text())["search"]["method"] == "sha"
    assert len(ref_tune.HistoryStore(str(history))) > 0


@pytest.mark.parametrize("method", ["oracle", "sha", "hill"])
def test_event_backend_equals_the_batched_backend(method):
    search = {"oracle": tune.oracle_search, "sha": tune.successive_halving,
              "hill": tune.hill_climb}[method]
    scs = smoke_matrix()[:3]
    batch = search(scs, device="cpu", n_candidates=8)
    event = search(scs, backend="event", n_candidates=8)
    assert batch.evals == event.evals and batch.equivalent_evals == event.equivalent_evals
    for key, table in event.tables.items():
        assert batch.tables[key].candidates == table.candidates
        np.testing.assert_allclose(batch.tables[key].throughputs, table.throughputs,
                                   rtol=TABLE_RTOL)
