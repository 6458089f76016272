"""The paper's contribution plus this repo's autotuner on the PyTorch port,
end to end:

1. TUNE — run the static-parameter oracle over the smoke matrix on the
   batched sweep, print each testbed's optimal (pipelining, parallelism,
   concurrency) and the regret table: how close SC / MC / ProMC get to the
   best static setting they never saw.
2. SEARCH CHEAPER — successive halving and warm-started hill climbing
   find (nearly) the same winners at a fraction of the oracle's
   evaluations, persisting per-testbed winners to a JSON history store.
3. REAL ENGINE (``--engine``) — the threaded engine moves actual files on
   local disk with the tuned schedulers.

    PYTHONPATH=src python examples/torch_transfer_optimizer.py [--engine]
    PYTHONPATH=src python examples/torch_transfer_optimizer.py --preset tiny --device cpu

Runs the sweeps on the card unless ``--device cpu`` is given.
"""
import argparse
import dataclasses
import hashlib
import os
import tempfile

from repro_torch.core import testbeds
from repro_torch.core.engine import TransferEngine, file_task
from repro_torch.core.runner import prepare_chunks
from repro_torch.core.schedulers import make_scheduler
from repro_torch.core.types import KB, MB, FileSpec, to_gbps
from repro_torch.eval.runner import run_matrix
from repro_torch.eval.scenarios import smoke_matrix
from repro_torch.eval.tune import (HistoryStore, hill_climb, oracle_search, regret_report,
                                   successive_halving)

PRESETS = {
    # name: (smoke-matrix rows, candidates, engine files of 64 KB, of 8 MB)
    "smoke": (None, 16, 40, 4),
    "tiny": (4, 4, 8, 1),
}


def tune_demo(device, rows=None, n_candidates=16):
    """Oracle + regret on the smoke matrix, then the budget searchers.
    Returns the oracle regret report."""
    scenarios = smoke_matrix()[:rows]
    print(f"== tune: static-parameter oracle over the smoke matrix ({len(scenarios)} "
          f"scenarios, {n_candidates}+ candidates each, device={device}) ==")
    heuristics = run_matrix(scenarios, device=device)
    oracle = oracle_search(scenarios, device=device, n_candidates=n_candidates)
    report = regret_report(scenarios, heuristics, oracle)

    print("   per-testbed optima (first one per network):")
    seen = set()
    for entry in oracle.entries:
        net = entry.context[0]
        if net in seen:
            continue
        seen.add(net)
        pp, par, cc = entry.best_params
        print(f"   {net:<24s} pp={pp:<4d} p={par:<2d} cc={cc:<2d} "
              f"-> {to_gbps(entry.best_throughput):6.2f} Gbps")
    print("   regret = heuristic / oracle throughput:")
    for line in report.format_table().splitlines():
        print(f"   {line}")

    with tempfile.TemporaryDirectory() as tmp:
        history = HistoryStore(os.path.join(tmp, "winners.json"))
        sha = successive_halving(scenarios, device=device, n_candidates=n_candidates,
                                 history=history)
        hill = hill_climb(scenarios, device=device, n_candidates=n_candidates,
                          history=history)  # warm-started from the sha winners
        history.save()
        oracle_best = {e.context: e.best_throughput for e in oracle.entries}
        for result in (sha, hill):
            worst = min(e.best_throughput / max(oracle_best[e.context], 1e-12)
                        for e in result.entries)
            print(f"   {result.method:<6s} {result.evals:4d} evaluations "
                  f"({result.equivalent_evals:6.1f} full-fidelity-equiv, oracle spent "
                  f"{oracle.evals}); worst-case {worst:.1%} of oracle throughput")
        print(f"   {len(history)} per-testbed winners recorded (demo store is temporary)")
    return report


def real_engine(n_small=40, n_large=4):
    print("== real engine: moving actual files on local disk ==")
    net = dataclasses.replace(testbeds.LAN, rtt=0.02)  # inject 20ms ctrl RTT
    with tempfile.TemporaryDirectory() as base:
        src, dst = os.path.join(base, "src"), os.path.join(base, "dst")
        os.makedirs(src), os.makedirs(dst)
        specs, tasks = [], {}
        for i, size in enumerate([64 * KB] * n_small + [8 * MB] * n_large):
            name = f"f{i:03d}"
            path = os.path.join(src, name)
            with open(path, "wb") as f:
                f.write(os.urandom(size))
            spec = FileSpec(name=name, size=size, path=path)
            specs.append(spec)
            tasks[name] = file_task(spec, path, os.path.join(dst, name))

        for algo in ("sc", "mc", "promc"):
            for f in os.listdir(dst):
                os.unlink(os.path.join(dst, f))
            chunks = prepare_chunks(specs, net, 2, max_cc=4)
            sched = make_scheduler(algo, chunks, net, 4)
            rep = TransferEngine(net, tick_period=0.05, inject_latency=True).run(
                chunks, sched, tasks)
            print(f"   {algo:6s} {rep.total_bytes/1e6:6.1f} MB in {rep.total_time:5.2f} s "
                  f"({rep.throughput/1e6:6.1f} MB/s, {rep.files_done} files)")
        digest = lambda p: hashlib.sha256(open(p, "rb").read()).digest()  # noqa: E731
        ok = all(digest(os.path.join(src, s.name)) == digest(os.path.join(dst, s.name))
                 for s in specs)
        print(f"   integrity: {'OK' if ok else 'CORRUPTED'}")
        return ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="smoke", choices=PRESETS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine", action="store_true")
    args = ap.parse_args()
    rows, n_candidates, n_small, n_large = PRESETS[args.preset]
    tune_demo(args.device, rows, n_candidates)
    if args.engine and not real_engine(n_small, n_large):
        raise SystemExit("the engine's copies differ from their sources")


if __name__ == "__main__":
    main()
