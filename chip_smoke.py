"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase (the full check)
    python3 chip_smoke.py --quick    # build + kernel checks only

Phases, each printing its own lines:
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build of every CUDA kernel of the sweep (one nvcc per source, all
     started together), timed;
  3. each kernel against its plain PyTorch version on the card at the
     shapes the sweep gives it, and on a live default-grid state: max
     error (limit 1e-12 relative; bool and int64 outputs exact), device
     time, the plain version's time, and the bound (bytes moved at
     3.35 TB/s or float64 operations at 34 TFLOP/s, whichever is longer);
  4. the 276-row default grid on the fused route and on the split route,
     each held to tests/golden/eval_matrix.json at rtol 1e-6;
  5. the main path: the 1116-row full grid on the default (fused) route,
     with every launch count set to 0 just before and read just after; a
     sample of 64 rows must match the port's own CPU run (plain kernel
     versions) within 1e-6 relative;
  6. one profiled run of the default grid: device busy and idle share;
  7. a {"kernels": [...]} JSON line, then the nvidia-smi name/power line,
     then the result line {"ok": true, "device": {...}}.

Any failure exits non-zero without the result line. The script imports
only the port (src/repro_torch) and needs the repository around it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "golden" / "eval_matrix.json"

#: H100 SXM data-sheet rates the bounds are computed against
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12

#: (S, C, K, Q) kernel-check shapes: the sweep's row chunks (276-row
#: default grid, 1024-row full-grid chunks), its channel ladder and its
#: padded file buffers
SHAPES = [
    (S, C, 4, Q) for S in (256, 1024) for C in (8, 16, 32) for Q in (4096, 16384)
]
#: shape whose numbers go into the kernels JSON line: a full-grid chunk
JSON_SHAPE = (1024, 16, 4, 16384)
REL_TOL = 1e-12


class SmokeFailure(RuntimeError):
    pass


def fail_if(cond: bool, msg: str) -> None:
    if cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def rel_err(out, ref) -> float:
    """Max of |out - ref| / max(|ref|, 1) over float tensors (inf == inf)."""
    import torch

    same = (out == ref) | (torch.isnan(out) & torch.isnan(ref))
    diff = torch.where(same, 0.0, (out - ref).abs() / ref.abs().clamp(min=1.0))
    return float(diff.max()) if diff.numel() else 0.0


def abs_err(out, ref) -> float:
    import torch

    same = out == ref
    return float(torch.where(same, 0.0, (out - ref).abs()).max()) if out.numel() else 0.0


def compare(outs, refs, label):
    """Hold kernel outputs to the plain version's: floats within
    REL_TOL relative, bool / int64 exact. Returns the max abs error."""
    import torch

    worst = 0.0
    for i, (o, r) in enumerate(zip(outs, refs)):
        fail_if(o.shape != r.shape or o.dtype != r.dtype, f"{label}: output {i} shape/dtype")
        if o.dtype == torch.float64:
            e = rel_err(o, r)
            fail_if(not e <= REL_TOL, f"{label}: output {i} relative error {e:.3g}")
            worst = max(worst, abs_err(o, r))
        else:
            fail_if(not torch.equal(o, r), f"{label}: output {i} differs")
    return worst


def synthetic_inputs(S, C, K, Q, seed, device):
    """Sweep-like kernel operands at (S, C, K, Q), made from a seed."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    chunk_of = rng.randint(-1, K, (S, C)).astype(np.int64)
    open_ = chunk_of >= 0
    busy = open_ & (rng.rand(S, C) < 0.6)
    dead = np.where(rng.rand(S, C) < 0.3, rng.uniform(0.0, 0.2, (S, C)), 0.0)
    rem = np.where(busy, np.floor(rng.uniform(1e6, 5e9, (S, C))), 0.0)
    cap = np.where(open_, rng.uniform(1e8, 5e8, (S, C)), 0.0)
    per = max(1, 2 * Q // (S * K))
    qlen = rng.randint(0, per + 1, (S, K)).astype(np.int64)
    qoff = (np.cumsum(qlen.ravel()) - qlen.ravel()).reshape(S, K)
    qlen = np.where(qoff + qlen <= Q, qlen, 0)
    qptr = (rng.rand(S, K) * (qlen + 1)).astype(np.int64)
    f = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    f8, i8, b = torch.float64, torch.int64, torch.bool
    return (
        f(rng.rand(S) < 0.9, b), f(busy, b), f(dead, f8), f(rem, f8), f(cap, f8),
        f(chunk_of, i8), f(rng.uniform(0.1, 5.0, S), f8),
        f(rng.choice([1.25e9, 3.75e9], S), f8), f(rng.uniform(4e8, 3e9, S), f8),
        f(rng.randint(4, 13, S), i8), f(rng.uniform(0.01, 0.08, S), f8),
        f(qoff, i8), f(qlen, i8), f(qptr, i8),
        f(np.floor(rng.uniform(0, 1e11, (S, K))), f8),
        f(rng.uniform(0.005, 0.1, (S, K)), f8),
        f(np.floor(rng.uniform(1e5, 1e10, Q)), f8),
    )


def device_ms(fn, n):
    """Device time of one launch of the single-kernel ``fn``: the kernel
    time the profiler records over ``n`` calls, averaged over the launches
    it recorded (it may drop some), 0.0 when it records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = _device_events(prof)
    launches = sum(e.count for e in events)
    return sum(_self_device_us(e) for e in events) / 1e3 / max(launches, 1)


def _device_events(prof):
    """The profiler's device-side rows (kernels, copies, fills). Host
    operator rows also carry the device time of what they launched, so
    summing every row would count it twice."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v:
            return float(v)
    return 0.0


def event_ms(fn, n):
    """Time per call between CUDA events around ``n`` back-to-back calls."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def kernel_checks(wf, fs, live_state):
    """Phase 3. Returns {kernel: {shape: row}} of measurements."""
    import torch

    rows = {"waterfill": {}, "fused_step": {}}
    cases = [(shape, synthetic_inputs(*shape, seed=i, device="cuda"))
             for i, shape in enumerate(SHAPES)]
    if live_state is not None:
        cases.append(("live", live_state))
    for shape, args in cases:
        S, C = args[1].shape
        K = args[13].shape[1]
        Q = args[16].shape[0]
        busy, dead, cap = args[1], args[2], args[4]
        caps = torch.where(busy & (dead <= 1e-12), cap, 0.0).contiguous()
        gen = torch.Generator(device="cuda").manual_seed(S * C + K)
        pool = torch.rand(S, dtype=torch.float64, device="cuda", generator=gen)
        pool = pool * caps.sum(dim=-1) * 1.2  # some rows leave the pool slack
        # water-fill: kernel vs plain
        out = wf.waterfill_bisect(caps, pool)
        ref = wf.waterfill_bisect_plain(caps, pool)
        torch.cuda.synchronize()
        err_w = compare([out], [ref], f"waterfill {shape}")
        # fused step: kernel vs plain
        outs = fs.fused_step(*args)
        refs = fs.fused_step_plain(*args)
        torch.cuda.synchronize()
        err_f = compare(outs, refs, f"fused_step {shape}")
        if shape == "live":
            print(f"[kernels] live default-grid state S={S} C={C} K={K} Q={Q}: "
                  f"max_abs_err waterfill {err_w:.3g}, fused_step {err_f:.3g}", flush=True)
            continue
        fed = int((refs[7] - args[13]).sum())
        b_w = 8 * (2 * S * C + S)
        b_f = (S + S * C + 8 * 4 * S * C + 8 * 5 * S + 8 * 5 * S * K + 8 * fed
               + 8 * 2 * S + S + S * C + 8 * 3 * S * C + 8 * 2 * S * K)
        ops = 2 * 80 * S * C  # min + add per channel per halving
        for name, err, nbytes, fn, plain in (
            ("waterfill", err_w, b_w, lambda: wf.waterfill_bisect(caps, pool),
             lambda: wf.waterfill_bisect_plain(caps, pool)),
            ("fused_step", err_f, b_f, lambda: fs.fused_step(*args),
             lambda: fs.fused_step_plain(*args)),
        ):
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / FP64_FLOPS * 1e3
            row = {
                "max_abs_err": err,
                "ms": device_ms(fn, 50),
                "call_ms": event_ms(fn, 50),
                "plain_ms": event_ms(plain, 5),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
            fail_if(row["ms"] <= 0.0, f"{name} {shape}: profiler recorded no device time")
            rows[name][shape] = row
            print(f"[kernels] {name:10s} S={S:5d} C={C:2d} K={K} Q={Q:5d}: "
                  f"max_abs_err {err:.3g} | device {row['ms'] * 1e3:.2f} us | "
                  f"wrapper call {row['call_ms'] * 1e3:.2f} us | plain "
                  f"{row['plain_ms'] * 1e3:.1f} us | bound {row['bound_ms'] * 1e3:.3f} us "
                  f"({row['bound_by']})", flush=True)
    return rows


def live_default_state():
    """A default-grid driver state a few sweeps in, as fused-step operands."""
    import torch

    from repro_torch.eval.fabric.driver import TorchFabricSimulation
    from repro_torch.eval.fabric.plan import build_plan
    from repro_torch.eval.scenarios import default_matrix

    drv = TorchFabricSimulation(build_plan(default_matrix()), device="cuda")
    drv.start()
    for _ in range(20):
        drv.step()
    eff_bw, next_prof = drv._bandwidth_now()
    return (
        ~drv.done, drv.busy, drv.dead, drv.rem, drv.cap, drv.chunk_of,
        torch.minimum(drv.next_tick - drv.t, next_prof - drv.t),
        eff_bw.contiguous(), drv.disk_rate, drv.sat_cc, drv.contention,
        drv.qoff, drv.qlen, drv.qptr, drv.queue_bytes, drv.fsdt, drv.qsizes,
    )


def run_grid(scenarios, device, fused_step, wf, fs):
    """One grid run with launch counts zeroed just before and read just
    after. Returns (results, stats, launches, seconds)."""
    import torch

    from repro_torch.eval.fabric.driver import SweepStats
    from repro_torch.eval.runner import run_matrix

    stats = SweepStats()
    wf.waterfill_bisect.launches = 0
    fs.fused_step.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_matrix(scenarios, device=device, fused_step=fused_step, stats=stats)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"waterfill": wf.waterfill_bisect.launches, "fused_step": fs.fused_step.launches}
    return results, stats, launches, seconds


def main(argv) -> int:
    quick = "--quick" in argv
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's sources are missing ({SRC / 'repro_torch'})",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.eval.fabric.kernels import _build
    from repro_torch.eval.fabric.kernels import fused_step as fs
    from repro_torch.eval.fabric.kernels import waterfill_bisect as wf
    from repro_torch.eval.runner import compare_golden, load_golden, metrics_snapshot
    from repro_torch.eval.scenarios import default_matrix, full_matrix

    # ---- 1. environment ----
    smi = nvidia_smi_line()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True)
    print(f"[env] {smi} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"{nvcc.stdout.strip().splitlines()[-1]} | python {sys.version.split()[0]}",
          flush=True)

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.build(["waterfill", "fused_step"])
    print(f"[build] 2 kernels in {time.perf_counter() - t0:.2f}s", flush=True)
    for name, (secs, report) in _build.BUILD_LOG.items():
        print(f"[build] {name}: {secs:.2f}s; {report}", flush=True)

    # ---- 3. kernels against their plain versions ----
    rows = kernel_checks(wf, fs, None if quick else live_default_state())

    launches = {"waterfill": 0, "fused_step": 0}
    by_path = {"waterfill": {}, "fused_step": {}}
    if not quick:
        # ---- 4. the default grid on both routes ----
        golden = load_golden(str(GOLDEN))
        scs = default_matrix()
        for route, must in (("kernel", "fused_step"), ("none", "waterfill")):
            res, st, lc, secs = run_grid(scs, "cuda", route, wf, fs)
            devs = compare_golden(golden, metrics_snapshot(scs, res))
            path = f"default_{'fused' if route == 'kernel' else 'split'}"
            for k in lc:
                by_path[k][path] = lc[k]
            print(f"[default] fused_step={route}: {len(scs)} rows in {secs:.3f}s "
                  f"({len(scs) / secs:.1f} rows/s), {st.sweeps} sweeps ({st.fused} fused, "
                  f"{st.split} split), {st.host_syncs} host syncs, launches {lc}, "
                  f"{len(devs)} golden deviations", flush=True)
            for d in devs[:10]:
                print(f"[default] DEVIATION {d.scenario} {d.field}: golden={d.golden} "
                      f"observed={d.observed}", flush=True)
            fail_if(bool(devs), f"default grid ({route}): {len(devs)} golden deviations")
            fail_if(lc[must] == 0, f"default grid ({route}): {must} never launched")

        # ---- 5. the main path: the full grid, default route ----
        full = full_matrix()
        res, st, launches, secs = run_grid(full, "cuda", "kernel", wf, fs)
        for k in launches:
            by_path[k]["full"] = launches[k]
        finite = all(np.isfinite(r.total_time) and r.total_time > 0
                     and np.isfinite(r.throughput) for r in res)
        fail_if(not finite, "full grid: non-finite results")
        moved_ok = max(abs(sum(r.per_chunk_bytes.values()) - r.total_bytes) / r.total_bytes
                       for r in res if r.n_moves == 0)
        sample = sorted(np.random.RandomState(0).choice(len(full), 64, replace=False).tolist())
        from repro_torch.eval.runner import run_matrix

        t0 = time.perf_counter()
        cpu = run_matrix([full[i] for i in sample], device="cpu")
        cpu_secs = time.perf_counter() - t0
        worst = 0.0
        for i, c in zip(sample, cpu):
            g = res[i]
            fail_if(g.total_bytes != c.total_bytes, f"full grid row {i}: total_bytes")
            for a, b in ((g.total_time, c.total_time), (g.throughput, c.throughput)):
                worst = max(worst, abs(a - b) / abs(b))
        print(f"[full] {len(full)} rows in {secs:.3f}s ({len(full) / secs:.1f} rows/s), "
              f"{st.sweeps} sweeps ({st.fused} fused, {st.split} split), {st.host_syncs} "
              f"host syncs, launches {launches}; worst byte-conservation error of rows "
              f"without moves {moved_ok:.3g}; {len(sample)} sampled rows vs the CPU run "
              f"({cpu_secs:.1f}s): worst relative difference {worst:.3g}", flush=True)
        fail_if(not moved_ok <= 1e-9, f"full grid: bytes not conserved ({moved_ok:.3g})")
        fail_if(not worst <= 1e-6, f"full grid: sample differs from the CPU run ({worst:.3g})")
        for k, n in launches.items():
            fail_if(n == 0, f"full grid: {k} was never launched on the main path")

        # ---- 6. profiled default grid ----
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_matrix(scs, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        avgs = _device_events(prof)
        busy_s = sum(_self_device_us(e) for e in avgs) / 1e6
        fused_s = sum(_self_device_us(e) for e in avgs if "fused_step_kernel" in e.key) / 1e6
        n_ops = sum(e.count for e in avgs)
        if busy_s > 0:
            print(f"[profile] default grid, fused route, under the profiler: wall {wall:.3f}s, "
                  f"device busy {busy_s:.4f}s ({100 * busy_s / wall:.2f}%), idle "
                  f"{100 * (1 - busy_s / wall):.2f}%, {n_ops} device operations; device "
                  f"seconds fused_step {fused_s:.4f}, other {busy_s - fused_s:.4f}", flush=True)
        else:
            print(f"[profile] wall {wall:.3f}s; device time not measured (the profiler "
                  "recorded no device activity)", flush=True)

    # ---- 7. summary lines ----
    pick = JSON_SHAPE
    kernels = []
    for name, src, replaces in (
        ("waterfill", "src/repro_torch/eval/fabric/csrc/waterfill.cu",
         "src/repro/eval/fabric/kernels/waterfill_pallas.py:40"),
        ("fused_step", "src/repro_torch/eval/fabric/csrc/fused_step.cu",
         "src/repro/eval/fabric/kernels/fused_step_pallas.py:37"),
    ):
        row = rows[name][pick]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "launches_by_path": by_path[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name].values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "shape": {"S": pick[0], "C": pick[1], "K": pick[2], "Q": pick[3]},
        })
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        rc = 1
    raise SystemExit(rc)
