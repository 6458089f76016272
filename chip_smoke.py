"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase (the full check)
    python3 chip_smoke.py --quick    # build + kernel checks only

Phases, each printing its own lines:
  1. environment: the card's name and power limit, torch and CUDA versions
     (fp32 matrix products must not run in TF32);
  2. build of every CUDA kernel (one nvcc per source, all started
     together), timed; the tensor-core flash kernel's SASS must hold
     HGMMA (warpgroup MMA) instructions;
  3. each kernel against its plain PyTorch version on the card at the
     shapes its path gives it: the sweep's kernels also on a live
     default-grid state (limit 1e-12 relative; bool and int64 outputs
     exact), the one-step fused kernel, the loop kernel (fused_rounds, the
     whole device loop: steps, completions, handlers, ticks, ProMC moves,
     resume stack, timeline ring) against its plain whole loop on live
     default-grid states at caps of 1, 3, 16, 256 and 2,048 steps, on states
     pushed to each stop (done, both capacity guards, max_time, stranded,
     cap), with resume files and with recording rows (a ring of 8 samples),
     on the default grid with 32 and 64 channel columns (the wide rows'
     one-halving-at-a-time water level) and on a live full-grid chunk, then
     on that chunk at the main path's cap of 2,048 steps, timed (per launch
     and per step of the longest row), the WKV-6 kernel at the serving
     run's prefill and decode
     shapes and a long prompt (rtol = atol = 1e-4, fp32), the RG-LRU
     kernel at recurrentgemma-9b's prefill, decode and long-prompt shapes,
     an odd width and bf16 inputs (rtol = atol = 1e-6), the two
     flash-attention kernels (bf16 with D % 8 == 0 on the tensor-core
     kernel, the rest on the CUDA-core kernel) at gemma3-1b's and
     recurrentgemma-9b's serving prefill shapes, the reference's FA cases in
     fp32 and bf16 and ragged and edge shapes (rtol = atol = 2e-5 fp32, 2e-2
     bf16, and bf16 also normwise within 2^-10 of the plain version's norm;
     window 1 returns v exactly; a query no key may attend gets zeros,
     on each kernel); max error, device time, the plain version's time, one
     scaled_dot_product_attention call's time for each flash kernel, and the
     bound (bytes moved at 3.35 TB/s, or operations at 34 TFLOP/s float64 /
     67 TFLOP/s float32 / 989 TFLOP/s bf16 on the tensor cores, whichever
     is longer);
  4. the 276-row default grid on the loop kernel's route ("rounds", the
     default), the one-step fused route ("kernel") and the split route
     ("none"), each held to tests/golden/eval_matrix.json at rtol 1e-6;
     host rounds, device row steps, host syncs and host transitions (rows
     a capacity guard stopped; must be 0) of each;
  5. the main path: the 1116-row full grid on the "rounds" route, then on
     the "kernel" route, each with every launch count set to 0 just before
     and read just after; rows/s of each; the two held to each other over
     every row (total_time, throughput, per-chunk bytes within 1e-6
     relative; rows whose event counts differ are counted and listed);
     host transitions 0 on both; the "rounds" route's host rounds must be
     the launches each runner chunk's longest row needs at 2,048 steps a
     launch; a
     sample of 64 rows must match the port's own CPU run (plain kernel
     versions) within 1e-6 relative;
  5b. the port's event simulator (a scalar loop on the host) over the
     default and full grids, timed; each route's results of phases 4 and
     5 (default grid: "rounds", "kernel", "none"; full grid: "rounds",
     "kernel") paired with it through eval.difftest: the worst relative
     throughput error of each, limits 2% (the difftest's bar) and 1e-6
     (route agreement); rows whose event counts differ are listed, not
     gated; then `python -m repro_torch.eval.difftest --smoke --route
     all --expect-zero-replays` in a subprocess on the card must exit 0;
  6. profiled runs of the sweep: the default grid on the "rounds" and
     "kernel" routes and the full grid on "rounds": device busy and idle
     share, device operations per host round;
  7. the serving path: rwkv6-3b at full width (32 layers, fp32 weights
     from a seeded generator) serves 8 prompts of 512 tokens and 32 new
     greedy tokens through ``train.serve_step.generate``, with the WKV
     launch count set to 0 just before and read just after (it must be
     32 layers x 32 model calls); then prefill and decode are timed;
  8. the same model cut to 2 layers on the card against the port's CPU
     run on the same weights: prefill of 2 x 64 tokens, then 4
     teacher-forced decode steps; every layer of every call is replayed
     on the card on the CPU run's inputs (wkv state within rtol = atol =
     1e-3, logits within atol 2e-2); the free-running drift is printed
     beside the CPU's own drift between thread counts;
  9. the hybrid serving path: recurrentgemma-9b at full width and depth
     (38 layers, 9,396,408,320 fp32 parameters from a seeded generator)
     serves 8 prompts of 512 tokens with 32 new greedy tokens (RG-LRU
     launches exactly 26 x 32) and 1 prompt of 3,072 tokens with 8 new
     tokens (the 2,048-token window wraps the rolling cache; 26 x 8
     launches); each prefill attends through the tensor-core flash kernel
     (exactly 12 launches a run, one a local-attention layer, decode none)
     and is timed also with the plain attention it took before; prefill and
     decode timed, each prefill and 4 decode steps profiled, peak device
     memory under 80 GB;
 10. recurrentgemma-9b cut to one period (R, R, L) at full width on the
     card against the port's CPU run, as phase 8: h / conv states within
     rtol = atol = 1e-3, bf16 k / v caches within 1e-2, positions exact,
     block outputs within two bf16 ulps of their largest magnitude, logits
     within atol 2e-2; exactly 1 flash launch in the card's prefill (kept
     out of the kernels line's main-path count);
 11. the dense serving path: gemma3-1b at full width and depth (26 layers
     "LLLLLG", 999,812,736 fp32 parameters from a seeded generator) serves
     8 prompts of 512 tokens with 32 new greedy tokens and 1 prompt of
     8,192 tokens with 8 new tokens; every prefill layer attends through
     the tensor-core flash kernel (exactly 26 launches a run, decode none);
     prefill and decode timed, each prefill profiled, peak device memory;
 12. gemma3-1b cut to one period (L x 5, G) at full width on the card
     against the port's CPU run: 1 x 640 prompt tokens (past the window),
     4 forced decode steps, each layer on the CPU's inputs (k / v within
     one bf16 ulp of their largest magnitude, block outputs two, logits
     atol 2e-2), exactly 6 flash launches in the card's prefill; the
     free-running drift printed beside that of a second card run with the
     plain attention in place of the kernel;
 13. a {"kernels": [...]} JSON line, then the nvidia-smi name/power line,
     then the result line {"ok": true, "device": {...}}.

Any failure exits non-zero without the result line. The script imports
only the port (src/repro_torch) and needs the repository around it.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
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
FP32_FLOPS = 67e12  # outside the tensor cores

#: (S, C, K, Q) kernel-check shapes: the sweep's row chunks (276-row
#: default grid, 1024-row full-grid chunks), its channel ladder and its
#: padded file buffers
SHAPES = [
    (S, C, 4, Q) for S in (256, 1024) for C in (8, 16, 32) for Q in (4096, 16384)
]
#: shape whose numbers go into the kernels JSON line: a full-grid chunk
JSON_SHAPE = (1024, 16, 4, 16384)
REL_TOL = 1e-12

#: (B, H, T, D) WKV-6 check shapes: the serving run's prefill (8 prompts
#: of 512 tokens) and decode (T = 1) at rwkv6-3b's 40 heads of 64, and
#: one long prompt; the first goes into the kernels JSON line, and is also
#: checked through ops.rwkv6_scan on (B, T, H, D) tensors, as the model
#: calls it
WKV_SHAPES = [(8, 40, 512, 64), (8, 40, 1, 64), (1, 40, 2048, 64)]
WKV_TOL = 1e-4
#: the serving run: requests, prompt tokens, new tokens
SERVE_B, SERVE_PROMPT, SERVE_NEW = 8, 512, 32
#: the card-against-CPU check: layers, requests, prompt tokens, forced steps
CHECK_LAYERS, CHECK_B, CHECK_PROMPT, CHECK_STEPS = 2, 2, 64, 4

#: (B, T, W) RG-LRU check shapes, fp32 unless marked: recurrentgemma-9b's
#: serving prefill (8 prompts of 512 tokens), decode (T = 1) and long
#: prompt (3,072 tokens) at its LRU width, an odd width, and bf16 inputs;
#: the first goes into the kernels JSON line
RG_SHAPES = [((8, 512, 4096), "float32"), ((8, 1, 4096), "float32"),
             ((1, 3072, 4096), "float32"), ((3, 77, 1000), "float32"),
             ((8, 512, 4096), "bfloat16")]
RG_TOL = 1e-6
#: the hybrid serving runs: (requests, prompt tokens, new tokens); the
#: second prompt is longer than the 2,048-token window
HYB_RUNS = [(8, 512, 32), (1, 3072, 8)]
#: the hybrid card-against-CPU check: one "RRL" period at full width
HYB_CHECK_LAYERS = 3
#: one card's device memory
CARD_BYTES = 80e9

#: bf16 dense tensor-core rate of the data sheet (the bf16 flash bound)
BF16_TC_FLOPS = 989e12
#: flash-attention checks, (B, H, KV, S, T, D, causal, window, softcap,
#: dtype): gemma3-1b's serving prefill shapes (8 x 512 and 1 x 8,192, 4
#: query heads and 1 KV head of 256, window 512 on 'L' layers, none on 'G'),
#: the reference's FA_CASES (tests/test_kernels.py) in fp32 and bf16, and
#: ragged and edge shapes. The serving shapes (bf16: the tensor-core kernel)
#: are timed, the first goes into the kernels JSON line
FA_SERVING = [(8, 4, 1, 512, 512, 256, True, w, 0.0, "bfloat16") for w in (512, None)] + \
             [(1, 4, 1, 8192, 8192, 256, True, w, 0.0, "bfloat16") for w in (512, None)]
#: the CUDA-core kernel's timed shapes, fp32: the first serving shape (window
#: 512; it goes into the kernels JSON line), the same without a window (the
#: library call then takes is_causal=True), and the long prompt with window
#: 512 (the kernel's block skipping at length)
FA_FP32 = FA_SERVING[0][:-1] + ("float32",)
FA_FP32_TIMED = [FA_FP32, FA_SERVING[1][:-1] + ("float32",), FA_SERVING[2][:-1] + ("float32",)]
FA_TIMED = FA_SERVING + FA_FP32_TIMED
#: each route's kernel, as the profiler names it
FA_KERNEL = {"tensor_cores": "flash_fwd_sm90_kernel", "cuda_cores": "flash_fwd_kernel"}
FA_CASES = [
    (1, 4, 4, 128, 64, True, None, 0.0),
    (2, 8, 2, 256, 64, True, None, 0.0),
    (1, 4, 1, 256, 128, True, None, 0.0),
    (1, 4, 4, 256, 64, False, None, 0.0),
    (1, 4, 2, 512, 64, True, 128, 0.0),
    (1, 2, 1, 384, 64, True, 64, 0.0),
    (1, 4, 4, 256, 64, True, None, 50.0),
    (2, 2, 2, 1024, 32, True, 256, 0.0),
]
FA_CHECKS = FA_SERVING + [FA_FP32] + [
    (b, h, kv, s, s, d, c, w, cap, dt) for b, h, kv, s, d, c, w, cap in FA_CASES
    for dt in ("float32", "bfloat16")
] + [
    (3, 6, 3, 333, 333, 96, True, 77, 30.0, dt) for dt in ("float32", "bfloat16")
] + [
    (2, 8, 2, 1, 1, 128, True, None, 0.0, "bfloat16"),      # S = T = 1
    (2, 8, 2, 1, 300, 128, False, None, 0.0, "float32"),   # one query over 300 keys
    (2, 4, 2, 100, 100, 64, True, 1, 0.0, "float32"),      # window 1: the output is v
    (2, 4, 2, 100, 100, 256, True, 1, 0.0, "bfloat16"),
    (1, 3, 1, 50, 70, 20, False, 9, 0.0, "bfloat16"),      # bf16 that TMA cannot describe
] + [
    # recurrentgemma-9b's serving prefills: 16 query heads, 1 KV head of 256,
    # window 2048
    (b, 16, 1, s, s, 256, True, 2048, 0.0, "bfloat16") for b, s, _ in HYB_RUNS
] + FA_FP32_TIMED[1:]
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: bf16 checks are also held normwise: ||out - plain|| <= FA_BF16_NORMWISE
#: ||plain|| over the whole output. At long shapes an output is about as
#: small as the 2e-2 limit (query i attends i keys of randn values: ~sqrt(e /
#: i)), which alone would let a dropped key tile through. The tensor-core
#: kernel keeps p to ~2^-18, so it and the plain version differ only where
#: their roundings to bf16 of nearly equal fp32 values fall apart (one ulp
#: of a few elements); rounding p once to bf16, as its first design did,
#: comes to ~2e-3
FA_BF16_NORMWISE = 2.0 ** -10
#: gemma3-1b serving runs: (requests, prompt tokens, new tokens); the second
#: prompt is 16 windows long
DENSE_RUNS = [(8, 512, 32), (1, 8192, 8)]
#: the dense card-against-CPU check: one "LLLLLG" period at full width, one
#: request of 640 tokens (longer than the 512 window), 4 forced steps
DENSE_CHECK_LAYERS, DENSE_CHECK_B, DENSE_CHECK_PROMPT = 6, 1, 640


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

    same = (out == ref) | (torch.isnan(out) & torch.isnan(ref))
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


def device_ms(fn, n, kernel=None):
    """Device time of one launch of the single-kernel ``fn`` (or of the
    kernel named ``kernel`` among what ``fn`` launches): the kernel time the
    profiler records over ``n`` calls, averaged over the launches it
    recorded (it may drop some). A window whose records it dropped entirely
    is profiled again, up to five times; 0.0 when it records none (the
    callers then fail), after a line that gives each window's count of
    device records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = _device_events(prof)
        events = [e for e in rows if kernel is None or kernel in e.key]
        launches = sum(e.count for e in events)
        if launches:
            return sum(_self_device_us(e) for e in events) / 1e3 / launches
        seen.append(sum(e.count for e in rows))
    print(f"[profiler] no launch of {kernel or 'the kernel'} recorded in 5 windows of {n} calls "
          f"(device records a window: {seen})", flush=True)
    return 0.0


def call_device_ms(fn, n):
    """Device time of one call of ``fn`` with every kernel, copy and fill it
    runs summed, {row name: launches a call} and {row name: launches the
    profiler recorded over ``n`` calls}. The profiler may drop records: each
    row's time is averaged over the launches it recorded, and its launches a
    call are those it recorded over ``n``, rounded up (exact while it drops
    fewer than one in a row's launches a call). Profiled again, up to three
    times, if the profiler recorded nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in _device_events(prof) if e.count]
        if events:
            per_call = {e.key: math.ceil(e.count / n - 1e-9) for e in events}
            ms = sum(_self_device_us(e) / e.count * per_call[e.key] for e in events) / 1e3
            return ms, per_call, {e.key: e.count for e in events}
    return 0.0, {}, {}


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


def ptxas_of(stem, kernel) -> str:
    """The ptxas registers and spills of the kernels of source ``stem``
    whose names start with ``kernel``, from this process's build."""
    from repro_torch import _cuda_build as _build

    report = _build.BUILD_LOG.get(stem, (0.0, ""))[1]
    hits = [e for e in report.split("; ") if e.startswith(kernel)]
    return "; ".join(hits) or "not built in this process"


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
        if C <= 32:  # the 32-way descent: its plain mirror's output, bit for bit
            fail_if(not torch.equal(out.cpu(), wf.waterfill_descent_plain(caps.cpu(), pool.cpu())),
                    f"waterfill {shape}: the descent differs from its plain mirror")
        # fused step: kernel vs plain
        refs = fs.fused_step_plain(*args)
        outs = fs.fused_step(*args)
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
            if name == "waterfill":  # rows of C <= 32 run the 32-way descent
                row["ptxas"] = ptxas_of("waterfill", f"waterfill_descent_kernel<{C}>")
            rows[name][shape] = row
            print(f"[kernels] {name:10s} S={S:5d} C={C:2d} K={K} Q={Q:5d}: "
                  f"max_abs_err {err:.3g} | device {row['ms'] * 1e3:.2f} us | "
                  f"wrapper call {row['call_ms'] * 1e3:.2f} us | plain "
                  f"{row['plain_ms'] * 1e3:.1f} us | bound {row['bound_ms'] * 1e3:.3f} us "
                  f"({row['bound_by']})" + (f" | ptxas {row['ptxas']}" if "ptxas" in row else ""),
                  flush=True)
    return rows


def wkv_checks(wk, ref):
    """Phase 3, WKV-6: the kernel against its plain version on the card,
    and the model's call (``ops.rwkv6_scan`` on (B, T, H, D) tensors) at the
    first shape. Returns {shape: row} of measurements."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops as kops

    def held(out, want, label):
        err = 0.0
        for o, x in zip(out, want):
            fail_if(o.shape != x.shape or o.dtype != x.dtype, f"wkv {label}: shape/dtype")
            excess = ((o - x).abs() - WKV_TOL * x.abs()).max().item()
            fail_if(not excess <= WKV_TOL, f"wkv {label}: outside rtol = atol = {WKV_TOL}")
            err = max(err, (o - x).abs().max().item())
        return err

    rows = {}
    for B, H, T, D in WKV_SHAPES:
        rng = np.random.RandomState(T)
        f = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")  # noqa: E731
        r, k, v = (f(0.5 * rng.standard_normal((B, H, T, D))) for _ in range(3))
        w = f(np.exp(-np.exp(0.5 * rng.standard_normal((B, H, T, D)))))
        u = f(0.5 * rng.standard_normal((H, D)))
        s0 = f(0.1 * rng.standard_normal((B, H, D, D)))
        args = (r, k, v, w, u, s0)
        out = wk.rwkv6_scan(*args)
        want = ref(*args)
        torch.cuda.synchronize()
        err = held(out, want, (B, H, T, D))
        # each input read once, each output written once; 5 D^2 flops a
        # step of a (b, h): the k v^T outer product, w S + k v^T, r^T S
        nbytes = 4 * (5 * B * H * T * D + H * D + 2 * B * H * D * D)
        ops = 5 * B * H * T * D * D
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOPS * 1e3
        row = {
            "max_abs_err": err,
            "ms": device_ms(lambda: wk.rwkv6_scan(*args), 20),
            "call_ms": event_ms(lambda: wk.rwkv6_scan(*args), 20),
            "plain_ms": event_ms(lambda: ref(*args), 3),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        fail_if(row["ms"] <= 0.0, f"wkv {B, H, T, D}: profiler recorded no device time")
        rows[(B, H, T, D)] = row
        print(f"[kernels] rwkv6_scan B={B} H={H} T={T:4d} D={D}: max_abs_err {err:.3g} | "
              f"device {row['ms'] * 1e3:.2f} us | wrapper call {row['call_ms'] * 1e3:.2f} us | "
              f"plain {row['plain_ms'] * 1e3:.1f} us | bound {row['bound_ms'] * 1e3:.3f} us "
              f"({row['bound_by']}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP) | "
              "library: none", flush=True)
        if (B, H, T, D) != WKV_SHAPES[0]:
            continue
        # the model's call: (B, T, H, D) products through ops.rwkv6_scan,
        # which must launch the kernel and nothing else (no copy in or out)
        seq = [x.transpose(1, 2).contiguous() for x in (r, k, v, w)]
        model_out = kops.rwkv6_scan(*seq, u, s0)
        torch.cuda.synchronize()
        row["model_max_abs_err"] = held(
            (model_out[0].transpose(1, 2), model_out[1]), want, f"model layout {B, T, H, D}")
        n_calls = 20
        row["model_call_ms"], per_call, recorded = call_device_ms(
            lambda: kops.rwkv6_scan(*seq, u, s0), n_calls)
        fail_if(not per_call, "wkv model layout: profiler recorded no device time")
        others = {k: n for k, n in per_call.items() if "wkv6_kernel" not in k}
        fail_if(bool(others), f"wkv model layout: the call runs more than the kernel: {others}")
        kernel_rows = {k: n for k, n in per_call.items() if "wkv6_kernel" in k}
        kept = sum(recorded[k] for k in kernel_rows)  # too few to count launches a call?
        fail_if(list(kernel_rows.values()) != [1] or 2 * kept < n_calls,
                f"wkv model layout: not one kernel launch a call ({kernel_rows}; recorded "
                f"{recorded} over {n_calls} calls)")
        print(f"[kernels] rwkv6_scan model layout (B, T, H, D) = {B, T, H, D} through "
              f"ops.rwkv6_scan: max_abs_err {row['model_max_abs_err']:.3g} | device time of "
              f"the whole call {row['model_call_ms'] * 1e3:.2f} us (kernel alone "
              f"{row['ms'] * 1e3:.2f} us) | launches a call: {per_call} (recorded over "
              f"{n_calls} calls: {recorded})", flush=True)
    return rows


def rglru_checks(rg, ref):
    """Phase 3, RG-LRU: the kernel against its plain version on the card.
    Returns {(shape, dtype): row} of measurements."""
    import torch

    rows = {}
    for (B, T, W), dtype in RG_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(B * T + W)
        dt = getattr(torch, dtype)

        def draw(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * scale

        a = torch.sigmoid(draw(B, T, W)).to(dt)  # decay in (0, 1)
        x = draw(B, T, W, scale=0.5).to(dt)
        h0 = draw(B, W, scale=0.5)
        args = (a, x, h0)
        out = rg.rglru_scan(*args)
        want = ref(*args)
        torch.cuda.synchronize()
        err = 0.0
        for o, w in zip(out, want):
            fail_if(o.shape != w.shape or o.dtype != w.dtype or o.dtype != torch.float32,
                    f"rglru {B, T, W} {dtype}: shape/dtype")
            excess = ((o - w).abs() - RG_TOL * w.abs()).max().item()
            fail_if(not excess <= RG_TOL, f"rglru {B, T, W} {dtype}: outside rtol = atol = {RG_TOL}")
            err = max(err, (o - w).abs().max().item())
        # a, x read once (in their type), h written once, h0 in, h_T out;
        # one multiply and one add an element
        nbytes = 2 * B * T * W * a.element_size() + 4 * (B * T * W + 2 * B * W)
        ops = 2 * B * T * W
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOPS * 1e3
        row = {
            "max_abs_err": err,
            "ms": device_ms(lambda: rg.rglru_scan(*args), 20, "rglru_kernel"),
            "call_ms": event_ms(lambda: rg.rglru_scan(*args), 20),
            "plain_ms": event_ms(lambda: ref(*args), 3),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        fail_if(row["ms"] <= 0.0, f"rglru {B, T, W}: profiler recorded no device time")
        rows[((B, T, W), dtype)] = row
        print(f"[kernels] rglru_scan B={B} T={T:4d} W={W} {dtype}: max_abs_err {err:.3g} | "
              f"device {row['ms'] * 1e3:.2f} us | wrapper call {row['call_ms'] * 1e3:.2f} us | "
              f"plain {row['plain_ms'] * 1e3:.1f} us | bound {row['bound_ms'] * 1e3:.3f} us "
              f"({row['bound_by']}: {nbytes / 1e6:.1f} MB) | library: none", flush=True)
    return rows


def kept_pairs(S, T, causal, window) -> int:
    """(query, key) pairs the mask keeps for queries 0..S-1, keys 0..T-1."""
    import numpy as np

    i = np.arange(S)
    hi = np.minimum(i, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(i - window + 1, 0) if window is not None else np.zeros(S, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_checks(fa, ref):
    """Phase 3, flash attention: each check of FA_CHECKS on the kernel its
    dtype and head dim route it to (bf16 with D % 8 == 0: the tensor-core
    kernel; the rest: the CUDA-core kernel), held to the plain version on
    the card (bf16 also normwise, FA_BF16_NORMWISE; window 1 must return v
    exactly), and a shape with queries that
    no key may attend on each route (the kernel must return zeros there).
    The timed shapes (FA_SERVING on the tensor-core kernel, FA_FP32_TIMED on
    the CUDA-core kernel) are timed against the plain version, one
    ``scaled_dot_product_attention`` call (the library yardstick) and the
    bound. Returns {route: {check: row}} of measurements."""
    import torch
    import torch.nn.functional as F

    rows = {fa.TENSOR_CORES: {}, fa.CUDA_CORES: {}}
    for i, check in enumerate(FA_CHECKS):
        B, H, KV, S, T, D, causal, window, cap, dtype = check
        gen = torch.Generator(device="cuda").manual_seed(i)
        dt = getattr(torch, dtype)
        q = torch.randn((B, H, S, D), generator=gen, device="cuda").to(dt)
        k, v = (torch.randn((B, KV, T, D), generator=gen, device="cuda").to(dt) for _ in range(2))
        kw = dict(causal=causal, window=window, logit_softcap=cap)
        route = fa._route(dt, D)
        before = (fa.flash_attention.launches, fa.flash_attention.tc_launches)
        out = fa.flash_attention(q, k, v, **kw)
        want = ref(q, k, v, **kw)
        torch.cuda.synchronize()
        label = (f"flash {(B, H, KV, S, T, D)} causal={causal} window={window} softcap={cap} "
                 f"{dtype} ({route})")
        fail_if((fa.flash_attention.launches - before[0], fa.flash_attention.tc_launches - before[1])
                != (1, int(route == fa.TENSOR_CORES)), f"{label}: launch counts")
        fail_if(out.shape != want.shape or out.dtype != want.dtype, f"{label}: shape/dtype")
        tol = FA_TOL[dtype]
        o, w = out.float(), want.float()
        excess = ((o - w).abs() - tol * w.abs()).max().item()
        fail_if(not excess <= tol, f"{label}: outside rtol = atol = {tol}")
        row = {"max_abs_err": (o - w).abs().max().item()}
        if dt == torch.bfloat16:
            row["normwise_err"] = ((o - w).norm() / w.norm()).item()
            fail_if(not row["normwise_err"] <= FA_BF16_NORMWISE,
                    f"{label}: within rtol = atol = {tol} (excess {excess:.3g}), but "
                    f"||out - plain|| / ||plain|| = {row['normwise_err']:.3g} > "
                    f"{FA_BF16_NORMWISE:.3g}")
        if window == 1:
            fail_if(not torch.equal(out, v.repeat_interleave(H // KV, dim=1)),
                    f"{label}: window 1 does not return v")
        err = row["max_abs_err"]
        if check in FA_TIMED:
            # each input read once, the output written once; 4 D flops a kept
            # (query, key) pair: q k^T and p v
            nbytes = q.element_size() * (2 * B * H * S * D + 2 * B * KV * T * D)
            flops = 4 * D * B * H * kept_pairs(S, T, causal, window)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / (BF16_TC_FLOPS if dt == torch.bfloat16 else FP32_FLOPS) * 1e3
            if window is None:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, is_causal=True, enable_gqa=True)
            else:
                pos = torch.arange(S, device="cuda")
                mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, attn_mask=mask, enable_gqa=True)
            lib_out = lib()
            torch.cuda.synchronize()
            fail_if(not (lib_out.float() - w).abs().max().item() <= 2 * tol,
                    f"{label}: the library call computes another function")
            n = 20 if S <= 512 else 5
            name = FA_KERNEL[route]
            row.update({
                "ms": device_ms(lambda: fa.flash_attention(q, k, v, **kw), n, name),
                "call_ms": event_ms(lambda: fa.flash_attention(q, k, v, **kw), n),
                "plain_ms": event_ms(lambda: ref(q, k, v, **kw), 3),
                "library_ms": event_ms(lib, n),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            })
            fail_if(row["ms"] <= 0.0, f"{label}: profiler recorded no device time")
            if route == fa.CUDA_CORES:
                dmax = 64 if D <= 64 else 128 if D <= 128 else 256
                row["ptxas"] = ptxas_of("flash_attention", f"flash_fwd_kernel<float, {dmax}>")
            print(f"[kernels] {name} B={B} H={H} KV={KV} S={S} D={D} window={window} {dtype}: "
                  f"max_abs_err {err:.3g} | device {row['ms'] * 1e3:.2f} us "
                  f"({flops / row['ms'] / 1e9:.1f} TFLOP/s of kept work) | wrapper call "
                  f"{row['call_ms'] * 1e3:.1f} us | plain {row['plain_ms'] * 1e3:.1f} us | "
                  f"library (scaled_dot_product_attention) {row['library_ms'] * 1e3:.1f} us | "
                  f"bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}: {nbytes / 1e6:.1f} "
                  f"MB, {flops / 1e9:.2f} GFLOP)"
                  + (f" | ptxas {row['ptxas']}" if "ptxas" in row else ""), flush=True)
        rows[route][check] = row
    for route, by_check in rows.items():
        worst = {dt: max((r["max_abs_err"] for key, r in by_check.items() if key[-1] == dt),
                         default=None) for dt in FA_TOL}
        normwise = max((r["normwise_err"] for r in by_check.values() if "normwise_err" in r),
                       default=None)
        print(f"[kernels] flash_attention ({route}): {len(by_check)} shapes within rtol = atol = "
              f"2e-5 (fp32) / 2e-2 (bf16) of the plain version; worst |error| {worst}; bf16 "
              f"worst ||out - plain|| / ||plain|| {normwise} (limit {FA_BF16_NORMWISE:.3g})",
              flush=True)
    # 16 queries over 4 keys in a window of 2: queries 5.. see no key; each
    # kernel returns zeros there (the plain version the mean of v)
    for dtype in ("float32", "bfloat16"):
        gen = torch.Generator(device="cuda").manual_seed(99)
        dt = getattr(torch, dtype)
        q = torch.randn((1, 2, 16, 32), generator=gen, device="cuda").to(dt)
        k, v = (torch.randn((1, 1, 4, 32), generator=gen, device="cuda").to(dt) for _ in range(2))
        out = fa.flash_attention(q, k, v, causal=True, window=2)
        want = ref(q, k, v, causal=True, window=2)
        torch.cuda.synchronize()
        route, tol = fa._route(dt, 32), FA_TOL[dtype]
        fail_if(bool(out[:, :, 5:].any()),
                f"flash ({route}): a query that no key may attend is not zero")
        fail_if(not ((out[:, :, :5].float() - want[:, :, :5].float()).abs().max().item() <= tol),
                f"flash ({route}): the attended queries differ from the plain version")
        print(f"[kernels] flash_attention ({route}): queries that no key may attend return zeros",
              flush=True)
    return rows


def serve_full_width(wk):
    """Phase 7: rwkv6-3b at full width through ``generate``. Returns the
    WKV launch count of the generate run."""
    import numpy as np
    import torch

    from repro_torch.models.model import build_model
    from repro_torch.train.serve_step import generate, make_decode_step, make_prefill

    t0 = time.perf_counter()
    model = build_model("rwkv6-3b", device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    init_s = time.perf_counter() - t0
    cfg = model.cfg
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT))
    prompt = torch.as_tensor(prompts, device="cuda")
    generate(model, prompt[:, :16], 2)  # warm-up: cuBLAS handles, the kernel's library

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wk.rwkv6_scan.launches = 0
    t0 = time.perf_counter()
    tokens = generate(model, prompt, SERVE_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = wk.rwkv6_scan.launches
    peak = torch.cuda.max_memory_allocated()
    fail_if(tuple(tokens.shape) != (SERVE_B, SERVE_NEW), f"serve: tokens {tuple(tokens.shape)}")
    fail_if(not (0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size),
            "serve: tokens out of the vocabulary")
    want = cfg.num_layers * SERVE_NEW
    fail_if(launches != want, f"serve: {launches} WKV launches, expected {want}")

    # prefill and decode timed apart, on the same model and prompts
    prefill, decode = make_prefill(model), make_decode_step(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill({"tokens": prompt}, model.init_cache(SERVE_B, SERVE_PROMPT + SERVE_NEW))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    fail_if(not bool(torch.isfinite(logits.float()).all()), "serve: non-finite prefill logits")
    tok = torch.argmax(logits[:, -1, :], dim=-1)
    fail_if(not torch.equal(tok, tokens[:, 0]), "serve: prefill token differs from generate's")
    t0 = time.perf_counter()
    for i in range(SERVE_NEW - 1):
        tok, cache = decode(tok, cache, SERVE_PROMPT + i)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    fail_if(not torch.equal(tok, tokens[:, -1]), "serve: decode tokens differ from generate's")
    fail_if(not bool(torch.isfinite(cache["wkv"]).all()), "serve: non-finite wkv state")
    steps = SERVE_NEW - 1
    row = {
        "params": n_params, "init_s": init_s, "generate_s": gen_s,
        "prefill_tok_s": SERVE_B * SERVE_PROMPT / prefill_s,
        "decode_tok_s": SERVE_B * steps / decode_s,
        "decode_step_ms": decode_s / steps * 1e3,
        "peak_gib": peak / 2**30,
    }
    print(f"[serve] rwkv6-3b full width: {n_params:,} fp32 parameters (init {init_s:.2f}s); "
          f"{SERVE_B} requests x {SERVE_PROMPT} prompt tokens, {SERVE_NEW} new greedy tokens: "
          f"generate {gen_s:.3f}s, WKV launches {launches} (= {cfg.num_layers} layers x "
          f"{SERVE_NEW} model calls), peak device memory {row['peak_gib']:.2f} GiB", flush=True)
    print(f"[serve] prefill {prefill_s * 1e3:.1f} ms ({row['prefill_tok_s']:.0f} tokens/s); "
          f"decode {steps} steps in {decode_s * 1e3:.1f} ms ({row['decode_step_ms']:.2f} ms a step, "
          f"{row['decode_tok_s']:.1f} tokens/s)", flush=True)
    # where the time goes: one prefill and 4 decode steps under the profiler
    cache0 = model.init_cache(SERVE_B, SERVE_PROMPT + SERVE_NEW)
    for label, fn in (
        ("prefill", lambda: prefill({"tokens": prompt}, cache0)),
        ("4 decode steps", lambda: [decode(tok, cache, SERVE_PROMPT) for _ in range(4)]),
    ):
        print(f"[serve] profiled {label}: {profile_window(fn, 'wkv6_kernel')}", flush=True)
    del model, cache, logits
    torch.cuda.empty_cache()
    return launches


def plain_attention(q, k, v, *, causal=True, window=None, logit_softcap=0.0):
    """The model-layout attention the port's prefills took before they went
    through the flash kernel: ``L.attend`` with queries and keys at
    positions 0..S-1 (one dense pass, query-chunked above 2,048 queries)."""
    import torch

    from repro_torch.models import layers as L

    pos = torch.arange(q.shape[1], device=q.device)
    return L.attend(q, k, v, pos, pos, causal=causal, window=window,
                    logit_softcap=logit_softcap)


@contextlib.contextmanager
def attention_swapped(fn):
    """Within the block, every model attends with ``fn`` in place of the
    flash kernel's wrapper ``ops.flash_attention`` (a diagnostic, not a route
    of the port)."""
    from repro_torch.kernels import ops

    kernel = ops.flash_attention
    ops.flash_attention = fn
    try:
        yield
    finally:
        ops.flash_attention = kernel


def serve_hybrid(rg, wk, fa):
    """Phase 9: recurrentgemma-9b at full width and depth through
    ``generate``. Returns ({run: RG-LRU launches of its generate}, {run:
    flash launches of its generate})."""
    import numpy as np
    import torch

    from repro_torch.models.model import build_model
    from repro_torch.train.serve_step import generate, make_decode_step, make_prefill

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_model("recurrentgemma-9b", device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    init_s = time.perf_counter() - t0
    cfg = model.cfg
    n_rec = sum(t == "R" for t in cfg.layer_types())
    n_att = cfg.num_layers - n_rec
    rng = np.random.RandomState(0)
    generate(model, torch.as_tensor(rng.randint(0, cfg.vocab_size, (2, 16)), device="cuda"), 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    print(f"[hybrid] recurrentgemma-9b full width: {n_params:,} fp32 parameters (init "
          f"{init_s:.2f}s), {cfg.num_layers} layers of which {n_rec} RG-LRU and {n_att} local "
          f"attention", flush=True)
    prefill, decode = make_prefill(model), make_decode_step(model)
    by_run, flash_by_run = {}, {}
    for b, s_len, new in HYB_RUNS:
        prompt = torch.as_tensor(rng.randint(0, cfg.vocab_size, (b, s_len)), device="cuda")
        torch.cuda.synchronize()
        rg.rglru_scan.launches = wk.rwkv6_scan.launches = 0
        fa.flash_attention.launches = fa.flash_attention.tc_launches = 0
        t0 = time.perf_counter()
        tokens = generate(model, prompt, new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches, other = rg.rglru_scan.launches, wk.rwkv6_scan.launches
        flash, flash_tc = fa.flash_attention.launches, fa.flash_attention.tc_launches
        run = f"serve_{b}x{s_len}"
        by_run[run] = launches
        flash_by_run[f"hybrid_{run}"] = flash
        fail_if(tuple(tokens.shape) != (b, new), f"{run}: tokens {tuple(tokens.shape)}")
        fail_if(not (0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size),
                f"{run}: tokens out of the vocabulary")
        fail_if(launches != n_rec * new or other != 0,
                f"{run}: {launches} RG-LRU launches (expected {n_rec * new}), {other} WKV")
        fail_if(flash != n_att or flash_tc != n_att,
                f"{run}: {flash} flash launches, {flash_tc} on the tensor cores (expected "
                f"{n_att}, all on the tensor cores: one a local-attention layer in the "
                f"prefill, none in decode)")

        # prefill and decode timed apart, on the same prompts
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill({"tokens": prompt}, model.init_cache(b, s_len + new))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        fail_if(not bool(torch.isfinite(logits.float()).all()), f"{run}: non-finite prefill logits")
        tok = torch.argmax(logits[:, -1, :], dim=-1)
        fail_if(not torch.equal(tok, tokens[:, 0]), f"{run}: prefill token differs from generate's")
        t0 = time.perf_counter()
        for i in range(new - 1):
            tok, cache = decode(tok, cache, s_len + i)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        fail_if(not torch.equal(tok, tokens[:, -1]), f"{run}: decode tokens differ from generate's")
        for name, state in cache["periods"].items():
            for key, v in state.items():
                fail_if(key != "pos" and not bool(torch.isfinite(v.float()).all()),
                        f"{run}: non-finite {name}.{key} state")
        # the prefill as it was before it went through the flash kernel (the
        # plain attention), between two more runs through the kernel
        timed = {"kernel": [prefill_s], "plain": []}
        for how in ("plain", "kernel"):
            with contextlib.ExitStack() as stack:
                if how == "plain":
                    stack.enter_context(attention_swapped(plain_attention))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, _ = prefill({"tokens": prompt}, model.init_cache(b, s_len + new))
                torch.cuda.synchronize()
                timed[how].append(time.perf_counter() - t0)
            if how == "plain":
                plain_diff = (lg.float() - logits.float()).abs().max().item()
            del lg
        written = cache["periods"]["l2"]["pos"]
        want_pos = min(s_len + new - 1, cfg.window_size)
        fail_if(int((written >= 0).sum(dim=-1).min()) != want_pos,
                f"{run}: {int((written >= 0).sum(dim=-1).min())} written window slots, expected {want_pos}")
        steps = new - 1
        print(f"[hybrid] {b} requests x {s_len} prompt tokens, {new} new greedy tokens: generate "
              f"{gen_s:.3f}s, RG-LRU launches {launches} (= {n_rec} layers x {new} model calls), "
              f"flash launches {flash} ({flash_tc} on the tensor cores; = {n_att} layers x 1 "
              f"prefill); prefill {prefill_s * 1e3:.1f} ms ({b * s_len / prefill_s:.0f} "
              f"tokens/s); decode {steps} steps in {decode_s * 1e3:.1f} ms "
              f"({decode_s / steps * 1e3:.2f} ms a step, {b * steps / decode_s:.1f} tokens/s)",
              flush=True)
        print(f"[hybrid] {b} x {s_len} prefill, attention through the flash kernel: "
              f"{', '.join(f'{x * 1e3:.1f}' for x in timed['kernel'])} ms; through the plain "
              f"attention (the path before the kernel): {timed['plain'][0] * 1e3:.1f} ms; "
              f"worst |logits| difference between the two {plain_diff:.3g}", flush=True)
        # where the time goes: one prefill (and 4 decode steps) under the profiler
        cache0 = model.init_cache(b, s_len + new)
        print(f"[hybrid] profiled prefill {b} x {s_len}: "
              f"{profile_window(lambda: prefill({'tokens': prompt}, cache0), 'flash_fwd_sm90', 'rglru_kernel')}",
              flush=True)
        if (b, s_len, new) == HYB_RUNS[0]:
            print(f"[hybrid] profiled 4 decode steps: "
                  f"{profile_window(lambda: [decode(tok, cache, s_len) for _ in range(4)], 'rglru_kernel')}",
                  flush=True)
        del cache, logits
    peak = torch.cuda.max_memory_allocated()
    print(f"[hybrid] peak device memory {peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB)", flush=True)
    fail_if(not peak < CARD_BYTES, f"hybrid: peak device memory {peak / 1e9:.2f} GB")
    del model
    torch.cuda.empty_cache()
    return by_run, flash_by_run


def profile_window(fn, *kernels):
    """One call of ``fn`` under the profiler: wall time, device busy share,
    the device time of each kernel named in ``kernels`` (a part of its
    name) and the three costliest device rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _device_events(prof)
    busy = sum(_self_device_us(e) for e in rows) / 1e6
    if busy <= 0:
        return f"wall {wall * 1e3:.1f} ms; device time not measured (no device rows)"
    own = []
    for kernel in kernels:
        t = sum(_self_device_us(e) for e in rows if kernel in e.key) / 1e6
        n = sum(e.count for e in rows if kernel in e.key)
        own.append(f"{kernel} {t * 1e3:.2f} ms x{n} ({100 * t / busy:.1f}% of device time)")
    top = sorted(rows, key=_self_device_us, reverse=True)[:3]
    top_s = "; ".join(f"{e.key[:60]} {_self_device_us(e) / 1e3:.2f} ms x{e.count}" for e in top)
    return (f"wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
            f"({100 * busy / wall:.1f}%, idle {100 * (1 - busy / wall):.1f}%), "
            f"{sum(e.count for e in rows)} device operations, {', '.join(own)}; costliest: "
            f"{top_s}")


def to_device(tree, dev):
    """A tensor, or a dict, list or tuple of them (other leaves kept), on
    ``dev``."""
    import torch

    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def forced_run(m, prompt, forced, calls=None):
    """The prefill of ``prompt`` (B, S) and one teacher-forced decode step
    for each row of ``forced`` (steps, B) -> [(logits (B, V) fp32, cache)]
    on the CPU; ``calls`` collects (layer, inputs, outputs) of each block
    call."""
    import torch

    s = prompt.shape[1]
    hooks = [blk.register_forward_hook(
             lambda mod, args, out, i=i: calls.append((i, args, out)))
             for i, blk in enumerate(m.layers)] if calls is not None else []
    with torch.inference_mode():
        lg, c = m.prefill({"tokens": torch.as_tensor(prompt, device=m.device)},
                          m.init_cache(prompt.shape[0], s + len(forced)))
        out = [(lg[:, 0], c)]
        for i, tok in enumerate(forced):
            out.append(m.decode_step(torch.as_tensor(tok, device=m.device), out[-1][1], s + i))
    for h in hooks:
        h.remove()
    return [(lg.float().cpu(), to_device(c, "cpu")) for lg, c in out]


def card_against_cpu(wk):
    """Phase 8: rwkv6-3b at full width cut to CHECK_LAYERS layers, on the
    card and in the port's CPU run with the same weights.

    Each layer is held to the CPU run on the CPU run's own inputs: every
    block call of the CPU's prefill and decode steps is recorded and
    replayed on the card's block, and the card's output head is given the
    CPU's last hidden state. Run freely, the two runs drift apart further:
    the residual stream is bf16, so an fp32 difference in the last bit
    (another summation order) can round a bf16 value the other way, and the
    next layer carries that on. That drift is printed beside the CPU run's
    own drift between one thread and all of them (another summation order
    on the same machine)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("rwkv6-3b"), num_layers=CHECK_LAYERS)
    gpu = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(1))
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, cfg.vocab_size, (CHECK_B, CHECK_PROMPT))
    forced = rng.randint(0, cfg.vocab_size, (CHECK_STEPS, CHECK_B))

    def drift(a, b):
        """(worst logits difference, worst wkv difference per layer)."""
        lg = max((x[0] - y[0]).abs().max().item() for x, y in zip(a, b))
        wkv = [max((x[1]["wkv"][i] - y[1]["wkv"][i]).abs().max().item() for x, y in zip(a, b))
               for i in range(CHECK_LAYERS)]
        return lg, wkv

    t0 = time.perf_counter()
    wk.rwkv6_scan.launches = 0
    free = forced_run(gpu, prompt, forced)
    calls = []
    ref = forced_run(cpu, prompt, forced, calls)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    one_thread = forced_run(cpu, prompt, forced)
    torch.set_num_threads(threads)

    # every layer of every call, on the CPU run's inputs
    worst_wkv = worst_lg = 0.0
    with torch.inference_mode():
        for i, (h, state), (h_out, st_out) in calls:
            _, st = gpu.layers[i](h.cuda(), {k: v.cuda() for k, v in state.items()})
            want, got = st_out["wkv"], st["wkv"].cpu()
            excess = ((got - want).abs() - 1e-3 * want.abs()).max().item()
            fail_if(not excess <= 1e-3,
                    f"check: layer {i} wkv state outside rtol = atol = 1e-3 on the CPU's inputs")
            worst_wkv = max(worst_wkv, (got - want).abs().max().item())
        finals = [h_out for i, _, (h_out, _) in calls if i == CHECK_LAYERS - 1]
        for h_last, (want, _) in zip(finals, ref):
            got = gpu._logits(h_last[:, -1:, :].cuda())[:, 0].float().cpu()
            fail_if(not bool(torch.isfinite(got).all()), "check: non-finite logits on the card")
            worst_lg = max(worst_lg, (got - want).abs().max().item())
    secs = time.perf_counter() - t0
    launches = wk.rwkv6_scan.launches
    want_launches = 2 * CHECK_LAYERS * (1 + CHECK_STEPS)
    fail_if(launches != want_launches, f"check: {launches} WKV launches, expected {want_launches}")
    free_lg, free_wkv = drift(free, ref)
    cpu_lg, cpu_wkv = drift(one_thread, ref)
    print(f"[check] rwkv6-3b full width cut to {CHECK_LAYERS} layers, card vs the port's CPU run "
          f"({secs:.1f}s): {CHECK_B} x {CHECK_PROMPT} prefill + {CHECK_STEPS} forced decode "
          f"steps; each layer on the CPU run's inputs: worst |wkv| difference {worst_wkv:.3g} "
          f"(limit 1e-3 + 1e-3 |x|), output head worst |logits| difference {worst_lg:.3g} "
          f"(limit 2e-2); WKV launches {launches}", flush=True)
    print(f"[check] free-running drift: card vs CPU worst |logits| {free_lg:.3g}, |wkv| by layer "
          f"{[float(f'{x:.3g}') for x in free_wkv]}; CPU 1 thread vs {threads} threads worst "
          f"|logits| {cpu_lg:.3g}, |wkv| by layer {[float(f'{x:.3g}') for x in cpu_wkv]}",
          flush=True)
    fail_if(not worst_lg <= 2e-2, f"check: logits differ by {worst_lg:.3g}")
    return launches


def hybrid_card_against_cpu(rg, fa):
    """Phase 10: recurrentgemma-9b at full width cut to one period (R, R,
    L), on the card and in the port's CPU run with the same weights. As in
    phase 8, every block call of the CPU's prefill and forced decode steps
    is replayed on the card's block on the CPU's inputs (state, caches and
    block output held to the CPU's), and the card's output head is given
    the CPU's last hidden state; the free-running drift is printed beside
    the CPU run's own drift between one thread and all of them. The card's
    run makes exactly one flash launch (the L layer's prefill, on the
    tensor cores). Returns the RG-LRU and the flash launch counts of the
    phase."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=HYB_CHECK_LAYERS)
    gpu = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(1))
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, cfg.vocab_size, (CHECK_B, CHECK_PROMPT))
    forced = rng.randint(0, cfg.vocab_size, (CHECK_STEPS, CHECK_B))

    def states(cache):
        """layer -> state, in layer order."""
        return cpu._layer_states(cache)

    def drift(a, b):
        """(worst logits difference, worst state difference per layer)."""
        lg = max((x[0] - y[0]).abs().max().item() for x, y in zip(a, b))
        per = [max(max((sx[k].float() - sy[k].float()).abs().max().item() for k in sx)
                   for sx, sy in ((states(x[1])[i], states(y[1])[i]) for x, y in zip(a, b)))
               for i in range(HYB_CHECK_LAYERS)]
        return lg, per

    t0 = time.perf_counter()
    rg.rglru_scan.launches = 0
    fa.flash_attention.launches = fa.flash_attention.tc_launches = 0
    free = forced_run(gpu, prompt, forced)
    n_att = HYB_CHECK_LAYERS - sum(t == "R" for t in cfg.layer_types())
    card_flash = (fa.flash_attention.launches, fa.flash_attention.tc_launches)
    fail_if(card_flash != (n_att, n_att),
            f"hybrid check: {card_flash[0]} flash launches in the card's run ({card_flash[1]} on "
            f"the tensor cores), expected {n_att} (the prefill of each L layer), all on the "
            "tensor cores")
    calls = []
    ref = forced_run(cpu, prompt, forced, calls)
    cpu_s = time.perf_counter() - t0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    one_thread = forced_run(cpu, prompt, forced)
    torch.set_num_threads(threads)
    one_s = time.perf_counter() - t0 - cpu_s

    # every layer of every call, on the CPU run's inputs
    tol = {"h": 1e-3, "conv": 1e-3, "k": 1e-2, "v": 1e-2}
    worst = {k: 0.0 for k in (*tol, "out")}
    with torch.inference_mode():
        for i, args, (h_out, st_out) in calls:
            got_h, st = gpu.layers[i](*to_device(args, "cuda"))
            got_h, st = got_h.cpu().float(), to_device(st, "cpu")
            # the block output is the bf16 sum h + mixer + FFN, three
            # roundings of terms that can be larger than the output itself,
            # so it is held normwise: within two bf16 ulps of its largest
            # magnitude (one ulp there is 2^-8 to 2^-7 of it)
            d = (got_h - h_out.float()).abs().max().item()
            ulp = top_ulp(h_out)
            worst["out"] = max(worst["out"], d / ulp)
            fail_if(not d <= 2 * ulp,
                    f"hybrid check: layer {i} output differs by {d:.3g}, more than two bf16 "
                    f"ulps ({ulp:.3g}) of its largest magnitude")
            for k, want in st_out.items():
                got = st[k]
                if k == "pos":
                    fail_if(not torch.equal(got, want), f"hybrid check: layer {i} positions differ")
                    continue
                d = (got.float() - want.float()).abs()
                excess = (d - tol[k] * want.float().abs()).max().item()
                fail_if(not excess <= tol[k],
                        f"hybrid check: layer {i} {k} outside rtol = atol = {tol[k]} on the CPU's inputs")
                worst[k] = max(worst[k], d.max().item())
        finals = [h_out for i, _, (h_out, _) in calls if i == HYB_CHECK_LAYERS - 1]
        worst_lg = 0.0
        for h_last, (want, _) in zip(finals, ref):
            got = gpu._logits(h_last[:, -1:, :].cuda())[:, 0].float().cpu()
            fail_if(not bool(torch.isfinite(got).all()), "hybrid check: non-finite logits on the card")
            worst_lg = max(worst_lg, (got - want).abs().max().item())
    secs = time.perf_counter() - t0
    launches = rg.rglru_scan.launches
    n_rec = sum(t == "R" for t in cfg.layer_types())
    want_launches = 2 * n_rec * (1 + CHECK_STEPS)
    fail_if(launches != want_launches, f"hybrid check: {launches} RG-LRU launches, expected {want_launches}")
    flash = fa.flash_attention.launches
    fail_if(flash != 2 * n_att, f"hybrid check: {flash} flash launches, expected {2 * n_att} (the "
            "card's prefill and the replay of its layers)")
    free_lg, free_st = drift(free, ref)
    cpu_lg, cpu_st = drift(one_thread, ref)
    print(f"[hybrid-check] recurrentgemma-9b full width cut to {HYB_CHECK_LAYERS} layers "
          f"({cfg.layer_types()}), card vs the port's CPU run ({secs:.1f}s; card and CPU runs "
          f"{cpu_s:.1f}s, 1-thread CPU run {one_s:.1f}s): {CHECK_B} x "
          f"{CHECK_PROMPT} prefill + {CHECK_STEPS} forced decode steps; each layer on the CPU "
          f"run's inputs: worst differences h {worst['h']:.3g}, conv {worst['conv']:.3g} (limit "
          f"1e-3 + 1e-3 |x|), k {worst['k']:.3g}, v {worst['v']:.3g} (limit 1e-2 + 1e-2 |x|), "
          f"block output {worst['out']:.3g} bf16 ulps of its largest magnitude (limit 2), "
          f"positions equal; output head worst "
          f"|logits| difference {worst_lg:.3g} (limit 2e-2); RG-LRU launches {launches}, flash "
          f"launches {flash} ({card_flash[0]} in the card's prefill, none in its decode steps)",
          flush=True)
    print(f"[hybrid-check] free-running drift: card vs CPU worst |logits| {free_lg:.3g}, worst "
          f"state difference by layer {[float(f'{x:.3g}') for x in free_st]}; CPU 1 thread vs "
          f"{threads} threads worst |logits| {cpu_lg:.3g}, by layer "
          f"{[float(f'{x:.3g}') for x in cpu_st]}", flush=True)
    fail_if(not worst_lg <= 2e-2, f"hybrid check: logits differ by {worst_lg:.3g}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return launches, flash


def serve_dense(fa, rg, wk):
    """Phase 11: gemma3-1b at full width and depth through ``generate``.
    Returns {run: flash launches of its generate}."""
    import numpy as np
    import torch

    from repro_torch.models.model import build_model
    from repro_torch.train.serve_step import generate, make_decode_step, make_prefill

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_model("gemma3-1b", device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    init_s = time.perf_counter() - t0
    cfg = model.cfg
    fail_if(n_params != 999_812_736, f"dense: {n_params:,} parameters")
    n_local = sum(t == "L" for t in cfg.layer_types())
    rng = np.random.RandomState(0)
    generate(model, torch.as_tensor(rng.randint(0, cfg.vocab_size, (2, 16)), device="cuda"), 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    print(f"[dense] gemma3-1b full width: {n_params:,} fp32 parameters (init {init_s:.2f}s), "
          f"{cfg.num_layers} layers ({n_local} local, window {cfg.window_size}; "
          f"{cfg.num_layers - n_local} global), {cfg.num_heads} heads of {cfg.head_dim}, "
          f"{cfg.num_kv_heads} KV head", flush=True)
    prefill, decode = make_prefill(model), make_decode_step(model)
    by_run = {}
    for b, s_len, new in DENSE_RUNS:
        prompt = torch.as_tensor(rng.randint(0, cfg.vocab_size, (b, s_len)), device="cuda")
        torch.cuda.synchronize()
        fa.flash_attention.launches = rg.rglru_scan.launches = wk.rwkv6_scan.launches = 0
        fa.flash_attention.tc_launches = 0
        t0 = time.perf_counter()
        tokens = generate(model, prompt, new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches, tc = fa.flash_attention.launches, fa.flash_attention.tc_launches
        other = rg.rglru_scan.launches + wk.rwkv6_scan.launches
        run = f"serve_{b}x{s_len}"
        by_run[f"dense_{run}"] = launches
        fail_if(tuple(tokens.shape) != (b, new), f"{run}: tokens {tuple(tokens.shape)}")
        fail_if(not (0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size),
                f"{run}: tokens out of the vocabulary")
        fail_if(launches != cfg.num_layers or tc != launches or other != 0,
                f"{run}: {launches} flash launches, {tc} on the tensor cores (expected "
                f"{cfg.num_layers}: one a layer in the prefill, none in decode, all on the "
                f"tensor cores), {other} recurrence launches")

        # prefill and decode timed apart, on the same prompts
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill({"tokens": prompt}, model.init_cache(b, s_len + new))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        fail_if(not bool(torch.isfinite(logits.float()).all()), f"{run}: non-finite prefill logits")
        tok = torch.argmax(logits[:, -1, :], dim=-1)
        fail_if(not torch.equal(tok, tokens[:, 0]), f"{run}: prefill token differs from generate's")
        t0 = time.perf_counter()
        for i in range(new - 1):
            tok, cache = decode(tok, cache, s_len + i)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        fail_if(not torch.equal(tok, tokens[:, -1]), f"{run}: decode tokens differ from generate's")
        for name, c in cache.items():
            fail_if(not bool(torch.isfinite(c[:, :, :s_len + new - 1].float()).all()),
                    f"{run}: non-finite {name} cache")
            fail_if(bool(c[:, :, s_len + new - 1:].any()), f"{run}: {name} cache written past the last step")
        steps = new - 1
        print(f"[dense] {b} requests x {s_len} prompt tokens, {new} new greedy tokens: generate "
              f"{gen_s:.3f}s, flash launches {launches} ({tc} on the tensor cores; = "
              f"{cfg.num_layers} layers x 1 prefill; decode attends with the plain attention); "
              f"prefill {prefill_s * 1e3:.1f} ms "
              f"({b * s_len / prefill_s:.0f} tokens/s); decode {steps} steps in "
              f"{decode_s * 1e3:.1f} ms ({decode_s / steps * 1e3:.2f} ms a step, "
              f"{b * steps / decode_s:.1f} tokens/s)", flush=True)
        cache0 = model.init_cache(b, s_len + new)
        print(f"[dense] profiled prefill {b} x {s_len}: "
              f"{profile_window(lambda: prefill({'tokens': prompt}, cache0), 'flash_fwd_sm90')}",
              flush=True)
        if (b, s_len, new) == DENSE_RUNS[0]:
            print(f"[dense] profiled 4 decode steps: "
                  f"{profile_window(lambda: [decode(tok, cache, s_len) for _ in range(4)], 'flash_fwd_sm90')}",
                  flush=True)
        del cache, cache0, logits
    peak = torch.cuda.max_memory_allocated()
    print(f"[dense] peak device memory {peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB)", flush=True)
    fail_if(not peak < CARD_BYTES, f"dense: peak device memory {peak / 1e9:.2f} GB")
    del model
    torch.cuda.empty_cache()
    return by_run


def top_ulp(x) -> float:
    """One bf16 ulp at the largest magnitude of ``x`` (8 significant bits)."""
    top = x.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def dense_card_against_cpu(fa):
    """Phase 12: gemma3-1b at full width cut to one period (L, L, L, L, L,
    G), on the card and in the port's CPU run with the same weights: one
    request of 640 tokens (the 'L' layers' window of 512 masks), then 4
    teacher-forced decode steps. As in phases 8 and 10, every block call of
    the CPU run is replayed on the card's block on the CPU's inputs, and the
    card's output head is given the CPU's last hidden state. Limits: k / v
    within one bf16 ulp of their largest magnitude, block outputs within
    two (both held normwise: rope and the residual sum cancel, so a one-ulp
    flip of an input can exceed an ulp of a small output), logits atol
    2e-2. The free-running card run is made a second time with the plain
    attention in place of the kernel (a diagnostic: which of the two
    carries the card's drift from the CPU). Returns the flash launch count
    of the phase."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("gemma3-1b"), num_layers=DENSE_CHECK_LAYERS)
    gpu = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(1))
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.RandomState(2)
    prompt = rng.randint(0, cfg.vocab_size, (DENSE_CHECK_B, DENSE_CHECK_PROMPT))
    forced = rng.randint(0, cfg.vocab_size, (CHECK_STEPS, DENSE_CHECK_B))

    def drift(a, b):
        """(worst logits difference, worst k / v difference per layer)."""
        lg = max((x[0] - y[0]).abs().max().item() for x, y in zip(a, b))
        per = [max((x[1][n][i].float() - y[1][n][i].float()).abs().max().item()
                   for x, y in zip(a, b) for n in ("k", "v"))
               for i in range(DENSE_CHECK_LAYERS)]
        return lg, per

    t0 = time.perf_counter()
    fa.flash_attention.launches = fa.flash_attention.tc_launches = 0
    free = forced_run(gpu, prompt, forced)
    card_launches = fa.flash_attention.launches
    fail_if(card_launches != DENSE_CHECK_LAYERS or fa.flash_attention.tc_launches != card_launches,
            f"dense check: {card_launches} flash launches in the card's run "
            f"({fa.flash_attention.tc_launches} on the tensor cores), expected "
            f"{DENSE_CHECK_LAYERS} (one a layer in the prefill, none in decode), all on the "
            "tensor cores")
    with attention_swapped(lambda q, k, v, **kw: flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw).transpose(1, 2)):
        free_plain = forced_run(gpu, prompt, forced)
    fail_if(fa.flash_attention.launches != card_launches,
            "dense check: the run with the plain attention launched the kernel")
    calls = []
    ref = forced_run(cpu, prompt, forced, calls)
    cpu_s = time.perf_counter() - t0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    one_thread = forced_run(cpu, prompt, forced)
    torch.set_num_threads(threads)
    one_s = time.perf_counter() - t0 - cpu_s

    # every layer of every call, on the CPU run's inputs
    worst = {"k": 0.0, "v": 0.0, "out": 0.0}
    with torch.inference_mode():
        for i, args, (h_out, st_out) in calls:
            got_h, st = gpu.layers[i](*to_device(args, "cuda"))
            got_h, st = got_h.cpu().float(), to_device(st, "cpu")
            d = (got_h - h_out.float()).abs().max().item()
            worst["out"] = max(worst["out"], d / top_ulp(h_out))
            fail_if(not d <= 2 * top_ulp(h_out),
                    f"dense check: layer {i} output differs by {d:.3g}, more than two bf16 ulps "
                    f"({top_ulp(h_out):.3g}) of its largest magnitude")
            for k, want in st_out.items():
                d = (st[k].float() - want.float()).abs().max().item()
                worst[k] = max(worst[k], d / top_ulp(want))
                fail_if(not d <= top_ulp(want),
                        f"dense check: layer {i} {k} differs by {d:.3g}, more than one bf16 ulp "
                        f"({top_ulp(want):.3g}) of its largest magnitude")
        finals = [h_out for i, _, (h_out, _) in calls if i == DENSE_CHECK_LAYERS - 1]
        worst_lg = 0.0
        for h_last, (want, _) in zip(finals, ref):
            got = gpu._logits(h_last[:, -1:, :].cuda())[:, 0].float().cpu()
            fail_if(not bool(torch.isfinite(got).all()), "dense check: non-finite logits on the card")
            worst_lg = max(worst_lg, (got - want).abs().max().item())
    secs = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    fail_if(launches != 2 * DENSE_CHECK_LAYERS,
            f"dense check: {launches} flash launches, expected {2 * DENSE_CHECK_LAYERS} (the "
            "card's prefill and the replay of its layers)")
    free_lg, free_kv = drift(free, ref)
    plain_lg, plain_kv = drift(free_plain, ref)
    cpu_lg, cpu_kv = drift(one_thread, ref)
    print(f"[dense-check] gemma3-1b full width cut to {DENSE_CHECK_LAYERS} layers "
          f"({''.join(cfg.layer_types())}), card vs the port's CPU run ({secs:.1f}s; card and CPU "
          f"runs {cpu_s:.1f}s, 1-thread CPU run {one_s:.1f}s): {DENSE_CHECK_B} x "
          f"{DENSE_CHECK_PROMPT} prefill + {CHECK_STEPS} forced decode steps; each layer on the "
          f"CPU run's inputs: worst differences k {worst['k']:.3g}, v {worst['v']:.3g} bf16 ulps "
          f"of their largest magnitude (limit 1), block output {worst['out']:.3g} (limit 2); "
          f"output head worst |logits| difference {worst_lg:.3g} (limit 2e-2); flash launches "
          f"{launches} ({card_launches} in the card's prefill, none in its decode steps, "
          f"{DENSE_CHECK_LAYERS} in the replay)", flush=True)
    print(f"[dense-check] free-running drift: card vs CPU worst |logits| {free_lg:.3g}, worst k / v "
          f"difference by layer {[float(f'{x:.3g}') for x in free_kv]}; card with the plain "
          f"attention in place of the kernel vs CPU worst |logits| {plain_lg:.3g}, by layer "
          f"{[float(f'{x:.3g}') for x in plain_kv]}; CPU 1 thread vs "
          f"{threads} threads worst |logits| {cpu_lg:.3g}, by layer "
          f"{[float(f'{x:.3g}') for x in cpu_kv]}", flush=True)
    fail_if(not worst_lg <= 2e-2, f"dense check: logits differ by {worst_lg:.3g}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return launches


#: step caps of phase 3's loop-kernel checks on the live default-grid state
ROUND_CHECK_STEPS = (1, 16, 256, 2048)


def live_round_state(scenarios, sweeps, widen=0):
    """The loop kernel's operands (cloned) of a driver on the card,
    ``sweeps`` one-step sweeps into its run, its channel axis doubled
    ``widen`` times (empty columns)."""
    from repro_torch.eval.fabric.driver import TorchFabricSimulation
    from repro_torch.eval.fabric.plan import build_plan

    drv = TorchFabricSimulation(build_plan(scenarios), device="cuda", fused_step="kernel")
    drv.start()
    for _ in range(sweeps):
        drv.step()
    for _ in range(widen):
        drv._grow()
    return {k: v.clone() for k, v in drv.round_operands(~drv.done).items()}


def full_chunk():
    """The full grid's first execution chunk as the runner cuts it (the
    1,024 cheapest rows by the plan's cost proxy; it holds the
    time-varying steppy-backbone rows)."""
    from repro_torch.eval.fabric.plan import build_plan
    from repro_torch.eval.runner import CHUNK_SIZE
    from repro_torch.eval.scenarios import full_matrix

    full = full_matrix()
    costs = build_plan(full).cost_proxy()
    order = sorted(range(len(full)), key=lambda i: costs[i])
    return [full[i] for i in order[:CHUNK_SIZE]]


def round_events(s, out):
    """What the rows of one loop-kernel launch met, from its operands ``s``
    and the plain version's results ``out``: each stop code, and what rows
    did inside the loop (chunk completions, ticks, ProMC ticks, moves and
    grants, SC waves, resume pushes, timeline samples and halvings,
    bandwidth-profile steps)."""
    import torch

    from repro_torch.eval.fabric import transition as tr

    act = s["act"]
    kind = s["kind"]
    crossed = (s["prof_t"] > s["t"].unsqueeze(-1)) & (s["prof_t"] < out["t"].unsqueeze(-1))
    masks = {
        "done": out["stop"] == tr.STOP_DONE,
        "cap": out["stop"] == tr.STOP_CAP,
        "guard": out["stop"] == tr.STOP_GUARD,
        "error": out["stop"] == tr.STOP_ERROR,
        "completion": (out["chunk_done"] & ~s["chunk_done"]).any(-1),
        "tick": out["next_tick"] > s["next_tick"],
        "promc_tick": (out["next_tick"] > s["next_tick"]) & (kind == tr.KIND_PROMC),
        "sc_wave": out["sc_cursor"] > s["sc_cursor"],
        "grant_or_move": out["n_moves"] > s["n_moves"],
        "resume_push": (out["prepend_sizes"] != s["prepend_sizes"]).flatten(1).any(-1),
        "timeline": out["tl_seen"] > s["tl_seen"],
        "halving": out["tl_stride"] > s["tl_stride"],
        "profile_step": crossed.any(-1),
    }
    return {k: int(torch.sum(act & m)) for k, m in masks.items()}


def pushed(s, reason):
    """A copy of the loop operands ``s`` with some rows pushed to
    ``reason``, and the events a launch on it must show."""
    import torch

    from repro_torch.eval.fabric import transition as tr

    s = {k: v.clone() for k, v in s.items()}
    kind, act = s["kind"], s["act"]
    must = {"max_time": ("error",), "stranded": ("error",), "sc_guard": ("guard",),
            "stack_guard": ("guard",), "resume": ("resume_push", "grant_or_move"),
            "timeline": ("timeline", "halving"),
            "multi_completion": ("completion", "done")}[reason]
    if reason == "max_time":
        s["max_time"].copy_(s["t"] + 1.0)
    elif reason == "multi_completion":  # idle rows whose queues ran dry: every
        s["busy"][::5] = False          # live chunk completes in one step
        s["qptr"][::5] = s["qlen"][::5]
    elif reason == "stranded":  # rows whose channels were all closed
        for name, empty in (("chunk_of", -1), ("busy", False), ("dead", 0.0), ("rem", 0.0),
                            ("cap", 0.0)):
            s[name][::7] = empty
    elif reason == "sc_guard":  # SC waves wider than the channel axis
        sc = kind == tr.KIND_SC
        s["conc"][sc] = s["busy"].shape[1] + 1
    elif reason == "stack_guard":  # ProMC rows ticking with a full stack
        pr = (kind == tr.KIND_PROMC) & act
        s["prepend_sizes"] = s["prepend_sizes"][..., :1].contiguous()
        s["prepend_sizes"].fill_(4.0e6)
        live = pr.unsqueeze(-1) & ~s["chunk_done"]
        s["prepend_n"][live] = 1000
        s["next_tick"][pr] = s["t"][pr]
    elif reason == "resume":  # resume files on the ProMC rows' live chunks
        pr = (kind == tr.KIND_PROMC) & act
        live = pr.unsqueeze(-1) & ~s["chunk_done"]
        size = torch.ceil(s["avg_fs_k"])
        s["prepend_sizes"][..., :2] = size.unsqueeze(-1)
        s["prepend_n"][live] = 2
        s["queue_bytes"] += torch.where(live, 2 * size, 0.0)
        s["promc_patience"][pr] = 1
        s["promc_ratio"][pr] = 1.2
    elif reason == "timeline":  # recording rows in a ring of 8 samples
        S = s["act"].shape[0]
        s["record_timeline"][::3] = True
        for name, shape, fill in (("tl_t", (S, 8), 0.0), ("tl_rate", (S, 8), 0.0),
                                  ("tl_len", (S,), 0), ("tl_stride", (S,), 1),
                                  ("tl_seen", (S,), 0), ("tl_last_t", (S,), 0.0),
                                  ("tl_last_rate", (S,), 0.0)):
            s[name] = torch.full(shape, fill, dtype=s[name].dtype, device=s[name].device)
    return s, must


def rounds_checks(fs, default_state, chunk_state):
    """Phase 3, the loop kernel: against the plain whole loop on the card,
    on the live default-grid state at each cap of ROUND_CHECK_STEPS, on
    states pushed to each stop (done, both capacity guards, max_time,
    stranded, cap) and with resume files and recording rows, on the
    default grid with 32 and 64 channel columns, on the live full-grid
    chunk, and on that chunk at the main path's cap (limit 1e-12 relative;
    bool and int64 exact, rings, stacks and chunk_of included); timed on
    the last, with the plain version and the bound. Returns the timing row
    (the kernels JSON line's)."""
    import torch

    cases = [(f"live default grid, cap {n}", default_state, n, ("done",) if n == 2048 else ())
             for n in ROUND_CHECK_STEPS]
    cases.append(("live default grid, cap 3", default_state, 3, ("cap",)))
    for reason in ("max_time", "stranded", "sc_guard", "stack_guard", "resume", "timeline",
                   "multi_completion"):
        s, must = pushed(default_state, reason)
        cases.append((f"default grid pushed to {reason}, cap 256", s, 256, must))
    # wider channel axes: one tile of 32, two tiles
    from repro_torch.eval.scenarios import default_matrix

    cases += [(f"live default grid widened {w}x, cap 256",
               live_round_state(default_matrix(), 20, widen=w), 256, ("done",)) for w in (1, 2)]
    cases.append(("live full-grid chunk, cap 256", chunk_state, 256, ("profile_step",)))
    seen, worst = {}, 0.0
    for label, s0, max_steps, must in cases:
        want = fs.fused_rounds_plain(s0, max_steps)
        got = {k: v.clone() for k, v in s0.items()}
        before = fs.fused_rounds.launches
        fs.fused_rounds(got, max_steps)
        torch.cuda.synchronize()
        fail_if(fs.fused_rounds.launches != before + 1, f"fused_rounds {label}: no launch")
        worst = max(worst, compare([got[k] for k in want], list(want.values()),
                                   f"fused_rounds {label}"))
        ev = round_events(s0, want)
        for k, n in ev.items():
            seen[k] = seen.get(k, 0) + n
        missing = [m for m in must if ev[m] == 0]
        fail_if(bool(missing), f"fused_rounds {label}: no row met {missing}")
        print(f"[kernels] fused_rounds {label}: S={s0['act'].shape[0]} C={s0['busy'].shape[1]} "
              f"K={s0['qptr'].shape[1]} B={s0['prof_t'].shape[1]} P={s0['prepend_sizes'].shape[2]} "
              f"T={s0['tl_t'].shape[1]}; {int(want['steps'].sum())} row steps (longest "
              f"{int(want['steps'].max())}); rows by stop and event {ev}; equal to the plain "
              "version", flush=True)
    missing = [k for k, n in seen.items() if n == 0]
    fail_if(bool(missing), f"fused_rounds: no check met {missing}")

    # timing on the full-grid chunk at the main path's cap
    s0, cap = chunk_state, fs.ROUND_CAP
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fs.fused_rounds_plain(s0, cap)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = {k: v.clone() for k, v in s0.items()}
    fs.fused_rounds(got, cap)
    torch.cuda.synchronize()
    err = compare([got[k] for k in want], list(want.values()), f"fused_rounds chunk, cap {cap}")
    rel = max(rel_err(got[k], want[k]) for k in want if want[k].dtype == torch.float64)
    steps = int(want["steps"].sum())
    longest = int(want["steps"].max())
    S, C = s0["busy"].shape
    fed = int((want["qptr"] - s0["qptr"]).sum())
    ev = round_events(s0, want)
    # each operand read once, the state and outputs written once, each fed
    # file size read once (not the whole buffer); 2 flops (min, add) a
    # channel a halving, 80 halvings a row step
    nbytes = sum(v.numel() * v.element_size() for k, v in s0.items() if k != "qsizes")
    nbytes += sum(v.numel() * v.element_size() for v in want.values()) + 8 * fed
    ops = 2 * 80 * C * steps
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP64_FLOPS * 1e3
    ms = device_ms(lambda: fs.fused_rounds({k: v.clone() for k, v in s0.items()}, cap), 5,
                   "fused_rounds_kernel")
    fail_if(ms <= 0.0, "fused_rounds: profiler recorded no device time")
    row = {
        "max_abs_err": max(worst, err), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "row_steps": steps, "longest": longest,
    }
    print(f"[kernels] fused_rounds full-grid chunk S={S} C={C} cap {cap}: {steps} row steps, "
          f"longest row {longest}; rows by stop and event {ev}; against the plain version: "
          f"worst relative {rel:.3g}, |error| {err:.3g}, bool / int64 equal | device {ms:.4f} ms "
          f"a launch, {ms / longest * 1e3:.3f} us a step of the longest row | plain "
          f"{plain_ms:.1f} ms | bound {row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}: "
          f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)", flush=True)
    return row


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
    counters = {"waterfill": wf.waterfill_bisect, "fused_step": fs.fused_step,
                "fused_rounds": fs.fused_rounds}
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_matrix(scenarios, device=device, fused_step=fused_step, stats=stats)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return results, stats, {k: c.launches for k, c in counters.items()}, seconds


def sweep_paths(wf, fs, by_path):
    """Phases 4-6: the default grid on the three routes against the
    golden, the full grid (the main path) on the "rounds" and "kernel"
    routes, and profiled sweeps. Fills ``by_path`` and returns each sweep
    kernel's launches on its path."""
    import numpy as np
    import torch

    from repro_torch.eval.runner import (
        compare_golden, load_golden, metrics_snapshot, run_matrix,
    )
    from repro_torch.eval.scenarios import default_matrix, full_matrix

    # ---- 4. the default grid on the three routes ----
    golden = load_golden(str(GOLDEN))
    scs = default_matrix()
    default_res = {}
    for route, must in (("rounds", "fused_rounds"), ("kernel", "fused_step"),
                        ("none", "waterfill")):
        res, st, lc, secs = run_grid(scs, "cuda", route, wf, fs)
        default_res[route] = res
        devs = compare_golden(golden, metrics_snapshot(scs, res))
        path = f"default_{route}"
        for k in lc:
            by_path[k][path] = lc[k]
        print(f"[default] fused_step={route}: {len(scs)} rows in {secs:.3f}s "
              f"({len(scs) / secs:.1f} rows/s), {st.sweeps} host rounds ({st.fused} fused, "
              f"{st.split} split), {st.steps} device row steps, {st.host_syncs} host syncs, "
              f"{st.host_transitions} host transitions, launches {lc}, {len(devs)} golden "
              "deviations", flush=True)
        for d in devs[:10]:
            print(f"[default] DEVIATION {d.scenario} {d.field}: golden={d.golden} "
                  f"observed={d.observed}", flush=True)
        fail_if(bool(devs), f"default grid ({route}): {len(devs)} golden deviations")
        fail_if(lc[must] == 0, f"default grid ({route}): {must} never launched")
        fail_if(st.host_transitions != 0,
                f"default grid ({route}): {st.host_transitions} rows left a transition to the host")

    # ---- 5. the main path: the full grid, "rounds" route, then "kernel" ----
    full = full_matrix()
    res, st, launches, secs = run_grid(full, "cuda", "rounds", wf, fs)
    res_k, st_k, launches_k, secs_k = run_grid(full, "cuda", "kernel", wf, fs)
    for k in launches:
        by_path[k]["full"] = launches[k]
        by_path[k]["full_kernel_route"] = launches_k[k]
    # the one-step kernel's own path is the "kernel" route, and so is the
    # water-fill kernel's: that route splits the sweeps of batches that
    # hold resume files, which the loop kernel feeds itself
    launches["fused_step"] = launches_k["fused_step"]
    launches["waterfill"] = launches_k["waterfill"]
    worst_route, differ = 0.0, []
    for i, (a, b) in enumerate(zip(res, res_k)):
        fail_if(a.total_bytes != b.total_bytes, f"full grid row {i}: total_bytes by route")
        pairs = [(a.total_time, b.total_time), (a.throughput, b.throughput)]
        pairs += [(a.per_chunk_bytes[c], b.per_chunk_bytes[c]) for c in b.per_chunk_bytes]
        worst_route = max([worst_route] + [abs(x - y) / max(abs(y), 1e-300) for x, y in pairs])
        if a.n_events != b.n_events:
            differ.append((full[i].name, a.n_events, b.n_events))
    # every host round after a runner chunk's first is a row at the step
    # cap: a chunk takes as many launches as its longest row needs
    from repro_torch.eval.fabric.bucketing import chunk_spans
    from repro_torch.eval.fabric.plan import build_plan
    from repro_torch.eval.runner import CHUNK_SIZE

    costs = build_plan(full).cost_proxy()
    order = sorted(range(len(full)), key=lambda i: costs[i])
    need = []
    for lo, hi in chunk_spans(len(order), CHUNK_SIZE):
        longest = max(res[i].n_events for i in order[lo:hi])
        need.append((hi - lo, longest, -(-longest // fs.ROUND_CAP)))
    print(f"[full] fused_step=rounds by runner chunk (rows, the longest row's steps, the "
          f"launches it needs at {fs.ROUND_CAP} steps a launch): {need}; host rounds "
          f"{st.sweeps}", flush=True)
    fail_if(st.sweeps != sum(n for _, _, n in need),
            "full grid: host rounds beyond the step cap's")
    for rt, stt, sec in (("rounds", st, secs), ("kernel", st_k, secs_k)):
        print(f"[full] fused_step={rt}: {len(full)} rows in {sec:.3f}s ({len(full) / sec:.1f} "
              f"rows/s), {stt.sweeps} host rounds ({stt.fused} fused, {stt.split} split), "
              f"{stt.steps} device row steps, {stt.host_syncs} host syncs, "
              f"{stt.host_transitions} host transitions", flush=True)
        fail_if(stt.host_transitions != 0,
                f"full grid ({rt}): {stt.host_transitions} rows left a transition to the host")
    print(f"[full] rounds vs kernel over all {len(full)} rows: worst relative difference "
          f"{worst_route:.3g} (total_time, throughput, per-chunk bytes; limit 1e-6); "
          f"{len(differ)} rows count other events: {differ[:12]}", flush=True)
    fail_if(not worst_route <= 1e-6, f"full grid: the routes differ ({worst_route:.3g})")
    finite = all(np.isfinite(r.total_time) and r.total_time > 0
                 and np.isfinite(r.throughput) for r in res)
    fail_if(not finite, "full grid: non-finite results")
    moved_ok = max(abs(sum(r.per_chunk_bytes.values()) - r.total_bytes) / r.total_bytes
                   for r in res if r.n_moves == 0)
    sample = sorted(np.random.RandomState(0).choice(len(full), 64, replace=False).tolist())
    t0 = time.perf_counter()
    cpu = run_matrix([full[i] for i in sample], device="cpu")
    cpu_secs = time.perf_counter() - t0
    worst = 0.0
    for i, c in zip(sample, cpu):
        g = res[i]
        fail_if(g.total_bytes != c.total_bytes, f"full grid row {i}: total_bytes")
        for a, b in ((g.total_time, c.total_time), (g.throughput, c.throughput)):
            worst = max(worst, abs(a - b) / abs(b))
    print(f"[full] main path (rounds): {len(full)} rows in {secs:.3f}s ({len(full) / secs:.1f} "
          f"rows/s), launches {launches}; worst byte-conservation error of rows "
          f"without moves {moved_ok:.3g}; {len(sample)} sampled rows vs the CPU run "
          f"({cpu_secs:.1f}s): worst relative difference {worst:.3g}", flush=True)
    fail_if(not moved_ok <= 1e-9, f"full grid: bytes not conserved ({moved_ok:.3g})")
    fail_if(not worst <= 1e-6, f"full grid: sample differs from the CPU run ({worst:.3g})")
    for k, n in launches.items():
        fail_if(n == 0, f"full grid: {k} was never launched on its path")

    # ---- 5b. the event simulator against every route ----
    event_against_routes(scs, default_res, full, {"rounds": res, "kernel": res_k})

    # ---- 6. profiled sweeps ----
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.eval.fabric.driver import SweepStats

    for label, grid, route in (("default grid", scs, "rounds"), ("default grid", scs, "kernel"),
                               ("full grid", full, "rounds")):
        stp = SweepStats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_matrix(grid, device="cuda", fused_step=route, stats=stp)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        avgs = _device_events(prof)
        busy_s = sum(_self_device_us(e) for e in avgs) / 1e6
        kern = {k: (sum(_self_device_us(e) for e in avgs if k in e.key) / 1e6,
                    sum(e.count for e in avgs if k in e.key))
                for k in ("fused_rounds_kernel", "fused_step_kernel")}
        n_ops = sum(e.count for e in avgs)
        if busy_s > 0:
            print(f"[profile] {label}, fused_step={route}, under the profiler: wall {wall:.3f}s, "
                  f"device busy {busy_s:.4f}s ({100 * busy_s / wall:.2f}%), idle "
                  f"{100 * (1 - busy_s / wall):.2f}%, {n_ops} device operations in "
                  f"{stp.sweeps} host rounds ({n_ops / stp.sweeps:.1f} a round); device "
                  + ", ".join(f"{k} {t:.4f}s x{n}" + (f" ({t / n * 1e3:.4f} ms each)" if n else "")
                              for k, (t, n) in kern.items())
                  + f", other {busy_s - sum(t for t, _ in kern.values()):.4f}s", flush=True)
        else:
            print(f"[profile] {label}, fused_step={route}: wall {wall:.3f}s; device time not "
                  "measured (the profiler recorded no device activity)", flush=True)
    return launches


#: phase 5b's limit on each route against the event leg: route agreement
#: (PERF.md section 2), far inside the difftest's own 2%
EVENT_ROUTE_TOL = 1e-6


def event_against_routes(scs, default_res, full, full_res):
    """Phase 5b: the port's event simulator over both grids, paired with
    the routes' results of phases 4 and 5 (no further card runs), then
    the difftest CLI on the smoke matrix in a subprocess on the card."""
    from repro_torch.eval import difftest
    from repro_torch.eval.runner import run_matrix

    for grid, scenarios, by_route in (("default", scs, default_res), ("full", full, full_res)):
        t0 = time.perf_counter()
        event = run_matrix(scenarios, backend="event")
        secs = time.perf_counter() - t0
        print(f"[event] {grid} grid: {len(scenarios)} rows, "
              f"{sum(r.n_events for r in event)} events in {secs:.3f}s on the host "
              f"({len(scenarios) / secs:.1f} rows/s)", flush=True)
        for route, results in by_route.items():
            reports = difftest.pair_results(scenarios, event, results, "event", route)
            worst = max(r.rel_err for r in reports)
            differ = difftest.event_count_differences(scenarios, event, results)
            print(f"[event] {grid} grid, route {route} vs the event leg: worst relative "
                  f"throughput error {worst:.3e} (limits {difftest.DEFAULT_RTOL:g} and "
                  f"{EVENT_ROUTE_TOL:g}); {len(differ)} rows count other events "
                  f"(event, {route}): {differ}", flush=True)
            try:
                difftest.assert_agreement(reports)
            except AssertionError as exc:
                raise SmokeFailure(f"{grid} grid, route {route}: {exc}") from None
            fail_if(not worst <= EVENT_ROUTE_TOL,
                    f"{grid} grid, route {route}: {worst:.3g} from the event leg")
            fail_if(any(a.total_bytes != b.total_bytes for a, b in zip(event, results)),
                    f"{grid} grid, route {route}: total_bytes differ from the event leg")

    cmd = [sys.executable, "-m", "repro_torch.eval.difftest", "--smoke", "--route", "all",
           "--expect-zero-replays"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True, text=True,
                         timeout=600)
    for line in out.stdout.splitlines():
        print(f"[difftest] {line}", flush=True)
    print(f"[difftest] {' '.join(cmd[1:])}: exit {out.returncode} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    fail_if(out.returncode != 0, f"the difftest CLI failed: {out.stderr[-2000:]}")


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
    from repro_torch import _cuda_build as _build
    from repro_torch.eval.fabric.kernels import fused_step as fs
    from repro_torch.eval.fabric.kernels import waterfill_bisect as wf
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as wk
    from repro_torch.kernels.ref import flash_attention_ref, rglru_scan_ref, rwkv6_scan_ref
    from repro_torch.eval.scenarios import default_matrix

    # ---- 1. environment ----
    smi = nvidia_smi_line()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True)
    print(f"[env] {smi} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"{nvcc.stdout.strip().splitlines()[-1]} | python {sys.version.split()[0]} | "
          f"fp32 matmul precision {torch.get_float32_matmul_precision()}, allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    from repro_torch.core.device import resolve_device

    resolve_device("cuda")
    fail_if(torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
            "bf16 matrix products would reduce partial sums in bf16")
    fail_if(torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest",
            "fp32 matrix products would run in TF32")

    # ---- 2. build ----
    t0 = time.perf_counter()
    sources = [wf.SOURCE, fs.SOURCE, wk.SOURCE, rg.SOURCE, fa.SOURCE, fa.SOURCE_SM90]
    _build.build(sources)
    print(f"[build] {len(sources)} kernels in {time.perf_counter() - t0:.2f}s", flush=True)
    for name, (secs, report) in _build.BUILD_LOG.items():
        print(f"[build] {name}: {secs:.2f}s; {report}", flush=True)
    # the tensor-core flash kernel must compile to Hopper's warpgroup MMA
    sass = subprocess.run([str(Path(_build._nvcc()).resolve().with_name("cuobjdump")), "-sass",
                           str(_build._target(fa.SOURCE_SM90))],
                          capture_output=True, text=True, check=True).stdout
    n_hgmma = sum("HGMMA" in line for line in sass.splitlines())
    print(f"[build] flash_attention_sm90: {n_hgmma} HGMMA instructions in its SASS", flush=True)
    fail_if(n_hgmma == 0, "flash_attention_sm90: no HGMMA instruction in the SASS")

    # ---- 3. kernels against their plain versions ----
    rows = kernel_checks(wf, fs, None if quick else live_default_state())
    chunk_state = live_round_state(full_chunk(), 8)
    rows["fused_rounds"] = {"chunk": None}
    rows["fused_rounds"]["chunk"] = rounds_checks(
        fs, live_round_state(default_matrix(), 20), chunk_state)
    del chunk_state
    rows["rwkv6_scan"] = wkv_checks(wk, rwkv6_scan_ref)
    rows["rglru_scan"] = rglru_checks(rg, rglru_scan_ref)
    fa_rows = flash_checks(fa, flash_attention_ref)
    rows["flash_attention_sm90"] = fa_rows[fa.TENSOR_CORES]
    rows["flash_attention"] = fa_rows[fa.CUDA_CORES]

    launches = {k: 0 for k in rows}
    by_path = {k: {} for k in rows}
    if not quick:
        launches.update(sweep_paths(wf, fs, by_path))

        # ---- 7. the serving path: rwkv6-3b at full width ----
        launches["rwkv6_scan"] = serve_full_width(wk)
        by_path["rwkv6_scan"]["serve"] = launches["rwkv6_scan"]

        # ---- 8. the card against the port's CPU run, 2 layers ----
        by_path["rwkv6_scan"]["card_vs_cpu"] = card_against_cpu(wk)

        # ---- 9. the hybrid serving path: recurrentgemma-9b at full width ----
        rg_runs, flash_runs = serve_hybrid(rg, wk, fa)
        by_path["rglru_scan"].update(rg_runs)
        by_path["flash_attention_sm90"].update(flash_runs)
        launches["rglru_scan"] = sum(by_path["rglru_scan"].values())

        # ---- 10. the card against the port's CPU run, one period ----
        by_path["rglru_scan"]["card_vs_cpu"], hybrid_check = hybrid_card_against_cpu(rg, fa)

        # ---- 11. the dense serving path: gemma3-1b at full width ----
        by_path["flash_attention_sm90"].update(serve_dense(fa, rg, wk))
        # the main path's count: the serving runs, not the phase-10 check
        launches["flash_attention_sm90"] = sum(by_path["flash_attention_sm90"].values())
        by_path["flash_attention_sm90"]["hybrid_card_vs_cpu"] = hybrid_check
        # every model path attends in bf16 with D % 8 == 0: none reaches the
        # CUDA-core kernel
        launches["flash_attention"] = sum(by_path["flash_attention"].values())

        # ---- 12. the card against the port's CPU run, one period ----
        by_path["flash_attention_sm90"]["card_vs_cpu"] = dense_card_against_cpu(fa)

    # ---- 13. summary lines ----
    kernels = []
    for name, src, replaces, pick, shape in (
        ("waterfill", "src/repro_torch/eval/fabric/csrc/waterfill.cu",
         "src/repro/eval/fabric/kernels/waterfill_pallas.py:40", JSON_SHAPE, "SCKQ"),
        ("fused_step", "src/repro_torch/eval/fabric/csrc/fused_step.cu",
         "src/repro/eval/fabric/kernels/fused_step_pallas.py:37", JSON_SHAPE, "SCKQ"),
        ("fused_rounds", "src/repro_torch/eval/fabric/csrc/fused_step.cu",
         "src/repro/eval/fabric/kernels/fused_step_pallas.py:37", "chunk", None),
        ("rwkv6_scan", "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
         "src/repro/kernels/rwkv6_scan.py:26", WKV_SHAPES[0], "BHTD"),
        ("rglru_scan", "src/repro_torch/kernels/csrc/rglru_scan.cu",
         "src/repro/kernels/rglru_scan.py:23", RG_SHAPES[0], "BTW"),
        ("flash_attention_sm90", "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
         "src/repro/kernels/flash_attention.py:33", FA_SERVING[0], "BHKSTD"),
        ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:33", FA_FP32, "BHKSTD"),
    ):
        row = rows[name][pick]
        dims = pick[0] if name == "rglru_scan" else pick
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "launches_by_path": by_path[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name].values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row.get("library_ms"),
            "shape": dict(zip(shape, dims)) if shape else {
                "full_grid_chunk_rows": 1024, "max_steps": fs.ROUND_CAP,
                "row_steps": row["row_steps"], "longest_row_steps": row["longest"]},
        })
        if name.startswith("flash_attention"):
            kernels[-1]["shape"].update(window=pick[7], dtype=pick[9])
        if name == "rwkv6_scan":  # the model's call, (B, T, H, D) in place
            kernels[-1]["model_layout_call_ms"] = row["model_call_ms"]
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
