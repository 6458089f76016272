"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase (the full check)
    python3 chip_smoke.py --quick    # build + kernel checks only
    python3 chip_smoke.py --parent DIR   # also against the loop kernels of
                                         # the checkout DIR (the parent commit)

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
     on both full-grid runner chunks (1,024 and 92 rows) at the main path's
     cap of 2,048 steps, timed (per launch and per step of the longest
     row), every case bit for bit with the level reuses equal to the plain
     count; the loop kernel's probe build on both chunks (SM cycles a step
     of the longest row by phase, beside the sampled SM clock; its results
     bit for bit the unprobed kernel's); the loop kernels' registers (no
     spill at C <= 32); with --parent DIR every loop-kernel case also bit
     for bit the parent checkout's kernels, timed against them in turns
     (and, after phase 5, the full grid and the oracle plane); the coupled
     loop kernel
     (fused_rounds_coupled, one block a fabric group) against its plain
     version bit for bit on a live tenant-smoke state at caps of 1, 16, 256
     and 2,048 steps, with members pushed to max_time and to the SC guard
     (their groups stop with them), on the default grid's uncoupled rows as
     groups of one (the uncoupled loop kernel's results) and on the live
     206-row tenant matrix at 64 and 2,048 steps, timed (the bound counts
     the Jacobi sweeps the kernel ran), its level reuses and reused solves
     the plain version's counts; the coupled kernel's probe build on the
     tenant matrix at 2,048 steps (bit for bit the unprobed kernel; SM
     cycles a group step of the longest group by phase, the barrier waits
     and the solve's sweeps included, beside the sampled SM clock, and as a
     yardstick the same rows through the uncoupled probe, each on its own
     pool); the loop kernel on a live mixed batch whose
     rows include custom-scheduler rows (each stops at its first callback
     event, transition.STOP_CUSTOM) bit for bit, the WKV-6 kernel at the serving
     run's prefill and decode
     shapes and a long prompt (rtol = atol = 1e-4, fp32), the RG-LRU
     kernel at recurrentgemma-9b's prefill, decode and long-prompt shapes,
     an odd width and bf16 inputs (rtol = atol = 1e-6), the two
     flash-attention kernels (bf16 with D % 8 == 0 on the tensor-core
     kernel, the rest on the CUDA-core kernel) at gemma3-1b's,
     recurrentgemma-9b's, deepseek-moe-16b's, paligemma-3b's and
     whisper-base's serving prefill shapes (whisper's encoder at T = 1,500,
     no multiple of a tile, and its cross attention of 64 queries over
     1,500 keys, both without a mask), the reference's FA cases in
     fp32 and bf16 and ragged and edge shapes (rtol = atol = 2e-5 fp32, 2e-2
     bf16, and bf16 also normwise within 2^-10 of the plain version's norm;
     window 1 returns v exactly; a query no key may attend gets zeros,
     on each kernel); each kernel's autograd Function (kernels/ops.py: the
     kernel forward, kernels/backward.py's gradients in torch ops, no
     launch in the backward) against torch.autograd through the plain
     version on the card: flash bf16 at (2, 4, 1, 256, 256, 256) with
     window 128 and softcap 50 (q scaled by 8, so the logits reach the
     cap: a backward without the softcap's 1 - tanh^2 factor, the plain
     version's autograd with the factor dropped, must part from the plain
     gradient by more than the limit) and at (2, 8, 8, 64, 300, 64)
     without a mask, dq, dk, dv each within 2^-7 normwise; WKV-6 at (2, 4, 64, 64)
     with s0 and the final state's gradient, rtol = atol = 1e-4; RG-LRU at
     (2, 64, 256), 1e-5; max error, device time, the plain version's time, one
     scaled_dot_product_attention call's time for each flash kernel, and the
     bound (bytes moved at 3.35 TB/s, or operations at 34 TFLOP/s float64 /
     67 TFLOP/s float32 / 989 TFLOP/s bf16 on the tensor cores, whichever
     is longer);
  4. the 276-row default grid on the loop kernel's route ("rounds", the
     default), the one-step fused route ("kernel") and the split route
     ("none"), each held to tests/golden/eval_matrix.json at rtol 1e-6;
     host rounds, device row steps, host syncs, host transitions (rows
     a capacity guard stopped) and post-row replays (custom rows stopped at
     a callback; the grids have none) of each, both 0;
  5. the main path: the 1116-row full grid on the "rounds" route, then on
     the "kernel" route, each with every launch count set to 0 just before
     and read just after; rows/s of each; the two held to each other over
     every row (total_time, throughput, per-chunk bytes within 1e-6
     relative; rows whose event counts differ are counted and listed);
     host transitions and post-row replays 0 on both, the level reuses of
     each printed; the "rounds" route's host rounds must be
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
  5c. the autotuner on the card: the full-grid oracle (16,675 static rows:
     64 candidates a context and the Algorithm-1 point) on the loop
     kernel's route, each context's best throughput within 1e-9 relative
     of tests/golden/tune_full_oracle.json (the reference's NumPy oracle,
     written on the CPU by tests/make_tune_golden.py) and its best
     parameters in the golden's tied set, the regret medians of phase 5's
     heuristic results within 1e-9 of the golden's; the smoke grid's
     oracle plane (2,061 rows) on the card against the port's CPU run,
     every row's events and time equal; successive halving
     and hill climbing on the smoke and full grids through the object
     ingest, each context within 0.95 of the card's oracle, their
     evaluation counts and decision paths the golden's except where a
     path meets a near-tie (named, its two scores within 1e-9); rows,
     wall time, plan ingest, host rounds, row steps, host syncs and host
     transitions (must be 0) of each, beside the card's name and power
     limit;
  5d. shared fabrics: the 206-row tenant matrix on the "rounds" route (the
     coupled loop kernel, launch counts zeroed just before and read just
     after) and the "none" route, each timed (host rounds, row steps, host
     syncs, host transitions (must be 0), plan build, rows/s, the kernel's
     time); both paired with the coupled event leg (the group's
     Simulations in lockstep, on the host) through eval.difftest, limits
     2% and 1e-6, and with each other (1e-6), rows whose event counts
     differ listed; `python -m repro_torch.eval.difftest --matrix
     tenant-smoke --route all --expect-zero-replays` in a subprocess must
     exit 0; single tenants (SC, MC, ProMC, static) on generous links bit
     for bit their uncoupled twins on both routes; the contention report on
     tenant-smoke and on the whole tenant matrix, each within 1e-9 of
     tests/golden/contention_tenant.json (the reference's NumPy reports,
     written by tests/make_contention_golden.py), with its wall time;
  5e. custom-scheduler rows: the smoke grid's Simulations with every other
     row's scheduler swapped for a class defined here (a no-override
     subclass of SC, MC and ProMC, a tick-driven mover, a closer that
     closes a busy channel of another chunk on each completion) and the
     no-override rows' built-in twins, through the object ingest on the
     "rounds", "kernel" and "none" routes (launch counts zeroed just before
     and read just after): every row held to the port's event leg (moves
     and bytes exact, throughput within 1e-9; rows whose event counts
     differ listed), each no-override row to its twin within 1e-9;
     post-row replays (the loop's stops at a callback), host rounds and
     wall seconds of each route; then the timeline matrix (the smoke grid,
     every row recording) on "rounds", each ring matched to the event
     leg's samples in order (rtol 1e-9, atol 1e-6; a row that counts more
     events than the event leg may leave that many zero-dt samples
     unmatched);
  5f. the runner's chunk executor: the full grid on "rounds", the
     full-grid oracle plane, successive halving on the full grid, the
     tenant matrix and phase 5e's 42-row custom batch, each under
     executor="serial" and "async" in turns (serial, async, async,
     serial): wall seconds, the SweepStats counters (equal in every run),
     the build / compute / download split, loop launches, and every
     SimResult field (timelines included; a search's tables, traces and
     entries) bit for bit the first run's; then the oracle plane profiled
     under each mode (device idle share); every line beside the card's
     name and power limit. Phases 4-6 run on the default mode ("serial");
     each line of phases 4, 5f and 6 gives the host seconds the garbage
     collector ran (a host stall by collection shows there);
  6. profiled runs of the sweep: the default grid on the "rounds" and
     "kernel" routes, the full grid on "rounds", the tenant matrix on
     "rounds" (the oracle plane's profiles are phase 5f's): device busy and
     idle share, device operations per host round, plan ingest, the wall
     split;
  7. the serving path: rwkv6-3b at full width (32 layers, fp32 weights
     from a seeded generator) serves 8 prompts of 512 tokens and 32 new
     greedy tokens through ``train.serve_step.generate``, with the WKV
     launch count set to 0 just before and read just after (it must be
     32 layers x 32 model calls); then prefill and decode are timed;
  8. the same model cut to 2 layers on the card against the port's CPU
     run on the same weights: prefill of 2 x 64 tokens, then 4
     teacher-forced decode steps; every layer of every call is replayed
     on the card on the CPU run's inputs (wkv state within rtol = atol =
     1e-3, logits within atol 2e-2); the free-running drift is printed;
  9. the hybrid serving path: recurrentgemma-9b at full width and depth
     (38 layers, 9,396,408,320 fp32 parameters from a seeded generator)
     serves 8 prompts of 512 tokens with 32 new greedy tokens (RG-LRU
     launches exactly 26 x 32) and 1 prompt of 3,072 tokens with 8 new
     tokens (the 2,048-token window wraps the rolling cache; 26 x 8
     launches); each prefill attends through the tensor-core flash kernel
     (exactly 12 launches a run, one a local-attention layer, decode none);
     prefill and decode timed, each prefill and 4 decode steps profiled,
     peak device memory under 80 GB;
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
     free-running drift printed;
 13. the MoE serving path: deepseek-moe-16b at full width and depth (28
     layers of 64 routed experts, top 6, and 2 shared; 16,879,568,896 fp32
     parameters from a seeded generator, 2,830,747,648 active a token)
     serves 8 prompts of 512 tokens with 32 new greedy tokens; each
     prefill layer attends through the tensor-core flash kernel at (8, 16,
     16, 512, 512, 128) causal (exactly 28 launches a run, decode none);
     prefill and decode timed, each profiled, peak device memory under 80
     GB (every earlier model freed first);
 14. deepseek-moe-16b cut to 2 layers at full width on the card against
     the port's CPU run: 2 x 64 prompt tokens, 4 forced steps, each block on
     the CPU's inputs with phase 12's limits; each MoE call's expert ids on
     the CPU's MoE input equal the CPU's but at near-ties (within 4 fp32
     ulps, listed); a token that keeps other experts in the card's replay
     (its own input) is listed and left out of the block output check, its
     flip explained by the input's change;
 15. the VLM serving path: paligemma-3b at full width and depth (18
     layers, 2,508,662,784 parameters) serves 8 requests of 256 seeded
     prefix rows and 512 text tokens with 32 new tokens (exactly 18 flash
     launches a run at (8, 8, 1, 768, 768, 256) causal); timed, profiled,
     peak memory;
 16. paligemma-3b cut to 2 layers on the card against the CPU run (1 x
     (256 + 64) prefill, 4 forced steps), as phase 14;
 17. the encoder-decoder serving path: whisper-base at full width and
     depth (6 + 6 layers, 70,611,456 parameters) serves 8 x 1,500 seeded
     frames with 64-token decoder prompts and 32 new tokens (exactly 18 flash
     launches a run: 6 encoder at (8, 8, 8, 1500, 1500, 64) and 6 cross at
     (8, 8, 8, 64, 1500, 64) without a mask, 6 decoder self at (8, 8, 8,
     64, 64, 64) causal); timed, profiled, peak memory;
 18. the whole whisper-base on the card against the CPU run (2 x 1,500
     frames, 2 x 16 prompt tokens, 4 forced steps), each encoder and decoder
     block on the CPU's inputs, as phase 14;
 19. training: gemma3-1b at full width and depth (999,812,736 fp32
     parameters from a seeded generator) through ``init_train_state`` and
     ``make_train_step``, 20 steps on SyntheticLM batches of 8 x 512 with
     the reference training test's AdamW (lr 3e-3, 5 warm-up steps, no
     weight decay): the first batch's gradient finite and non-zero in every
     parameter, its flash calls the prefill's shapes and none launched by
     the backward; exactly 26 tensor-core flash launches a step (counts set
     to 0 just before each step and read just after); the mean loss of the
     last two steps under 0.9 x that of the first two (the reference's
     bar); step time (median after the first), tokens/s, peak device memory
     and one profiled step;
 20. the same model cut to one period (L x 5, G) at full width, one train
     step of 2 x 64 tokens on the card against the port's CPU run from the
     same weights and batch: loss within atol 2e-2, every gradient leaf
     within 2^-5 normwise; each side's first update, from zero moments:
     each leaf's first moment within 2^-5 normwise, each parameter's
     change within 2^-4 normwise over the elements whose CPU gradient
     exceeds the card's error there (Adam's first step is lr x g / (|g| +
     eps), lr x sign(g) unless |g| is near eps, so an element whose
     gradient lies within its error of zero may move either way: the
     share of such elements and of the change's error on them is
     printed); then, from the card's state on both, a step on a second
     batch: loss within 2e-2, each parameter's change within 2^-4
     normwise;
 21. the fault-tolerant training loop: gemma3-1b at full width and depth
     through ``train.loop.train`` on a ``Prefetcher`` of the same batches
     and optimizer, 12 steps straight; then ``train_with_restarts`` around
     a fresh model's 12 steps with an asynchronous checkpoint every 8
     steps through ``checkpoint.ckpt`` on the transfer engine, under
     build/ (24 GB free needed, removed after), the first attempt crashing
     at step 10 (after the step-8 save, which it waits for), the second
     restoring step 8 and running steps 9-12: 2 attempts; after the crash
     only step_00000008 committed (35 leaf files and index.json, 11.998
     GB); the resumed final state (parameters, both moments, count, step)
     and the losses of steps 9-12 bit for bit the straight run's; exactly 26
     tensor-core flash launches in each of the 26 steps (counts set to 0
     after each step's metrics); peak device memory; each save's snapshot,
     serialize and engine seconds, bytes, files, throughput, chunks and
     moves, the restore's seconds and rate, the steps that overlap the
     asynchronous save against those that do not, the host's peak RSS and
     the free disk;
 22. gradient sync between ranks: 2 spawned ranks share the card
     (``distributed.pods.init_pods``: gloo over CUDA tensors, a file://
     store in a temporary directory under build/; started beside phase 21,
     they wait there for the phase), each with gemma3-1b at
     full width cut to 6 layers from the same seed, the global batch 8 x
     512 (4 rows a rank); one train step each of naive, sc, mc, promc (no
     compression), promc bf16 and promc int8 (``make_train_step(...,
     group=...)``), each from the same state, the counts set to 0 just
     before and read just after: exactly 6 tensor-core flash launches a
     rank a step; sc / mc / promc parameters bit for bit naive's; the two
     ranks' parameters the same bits; promc bf16 within 5e-3 max abs of
     naive (the reference's limit). Printed: int8's distance, the first
     gradient synced by the promc plan with bf16 or int8 forced on every
     class against the whole batch's gradient on one rank (the ranks'
     results the same bits, gated), the 2-rank naive step against one
     rank's step of the whole batch (normwise), each
     variant's step and sync seconds, wire bytes and collectives a rank,
     each rank's peak device memory, ``simulate_sync`` on DCN for gemma3-1b
     at full depth under sc / mc / promc with and without compression;
 23. a {"kernels": [...]} JSON line (the flash row's launches_by_path
     gains "train", "train_loop", "train_loop_resumed" and "grad_sync"),
     then the nvidia-smi name/power line, then the result line {"ok":
     true, "device": {...}}.

Any failure exits non-zero without the result line. The script imports
only the port (src/repro_torch) and needs the repository around it.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "golden" / "eval_matrix.json"
#: the reference's autotuner over the full and smoke grids, written on the
#: CPU by tests/make_tune_golden.py (the command is in the file)
TUNE_GOLDEN = ROOT / "tests" / "golden" / "tune_full_oracle.json"
#: phase 5c's limits: the card's oracle and regret against the golden, and
#: the near-tie that alone may change a search's decision path
TUNE_RTOL = 1e-9
#: each search's worst context against the card's oracle (the reference's
#: bar, tests/test_tune.py)
TUNE_BAR = 0.95

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
#: the prefill shapes of the MoE, VLM and encoder-decoder serving runs
#: (bf16, the tensor-core kernel), timed: deepseek-moe-16b (16 heads of 128,
#: 16 KV heads), paligemma-3b (256 prefix rows + 512 tokens, 8 heads of 256,
#: 1 KV head), whisper-base's encoder (1,500 frames: no multiple of a tile,
#: no mask), its decoder's self attention and its cross attention (64
#: queries over 1,500 keys, no mask)
FA_FAMILIES = [
    (8, 16, 16, 512, 512, 128, True, None, 0.0, "bfloat16"),
    (8, 8, 1, 768, 768, 256, True, None, 0.0, "bfloat16"),
    (8, 8, 8, 1500, 1500, 64, False, None, 0.0, "bfloat16"),
    (8, 8, 8, 64, 64, 64, True, None, 0.0, "bfloat16"),
    (8, 8, 8, 64, 1500, 64, False, None, 0.0, "bfloat16"),
]
FA_TIMED = FA_SERVING + FA_FP32_TIMED + FA_FAMILIES
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
] + FA_FP32_TIMED[1:] + FA_FAMILIES
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
#: the serving runs of the MoE, VLM and encoder-decoder families: (requests,
#: prompt tokens, new tokens); paligemma's requests carry 256 prefix rows
#: each, whisper's 1,500 frames
MOE_RUNS, VLM_RUNS, ENCDEC_RUNS = [(8, 512, 32)], [(8, 512, 32)], [(8, 64, 32)]
#: their card-against-CPU checks: (layers, requests, prompt tokens), 4
#: forced steps each; deepseek-moe-16b and paligemma-3b cut to 2 layers,
#: whisper-base whole (6 + 6)
MOE_CHECK, VLM_CHECK, ENCDEC_CHECK = (2, 2, 64), (2, 1, 64), (None, 2, 16)
#: a routing flip between the card and the CPU on the same MoE input is a
#: near-tie: the two experts' router probabilities within this many fp32
#: ulps of each other
ROUTE_ULPS = 4

#: phase 3's gradient checks of the kernels' autograd Functions (the kernel
#: forward, kernels/backward.py's gradients) against autograd through the
#: plain version. Flash, bf16 on the tensor-core kernel, (B, H, KV, S, T, D,
#: causal, window, softcap, q's scale): one KV head of 256 with a window and
#: a softcap, q scaled so the logits (std 8) reach the cap, and 64 queries
#: over 300 keys without a mask; dq, dk, dv each normwise
FA_GRAD_CHECKS = [(2, 4, 1, 256, 256, 256, True, 128, 50.0, 8.0),
                  (2, 8, 8, 64, 300, 64, False, None, 0.0, 1.0)]
FA_GRAD_NORMWISE = 2.0 ** -7
#: WKV-6 (B, H, T, D) with s0 and the final state's gradient, rtol = atol
WKV_GRAD_SHAPE, WKV_GRAD_TOL = (2, 4, 64, 64), 1e-4
#: RG-LRU (B, T, W) with h0 and the final state's gradient, rtol = atol
RG_GRAD_SHAPE, RG_GRAD_TOL = (2, 64, 256), 1e-5
#: phase 19, gemma3-1b trained at full width and depth: batch rows, tokens,
#: train steps; the optimizer of the reference's training test
#: (tests/test_train_and_ckpt.py _setup)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 512, 20
TRAIN_OPT = dict(lr=3e-3, warmup_steps=5, total_steps=200, weight_decay=0.0)
#: the reference's bar (test_loss_decreases): the mean loss of the last two
#: steps under this times that of the first two
TRAIN_LOSS_BAR = 0.9
#: phase 20, one period (L x 5, G) at full width: layers, batch rows,
#: tokens; limits on the loss, each gradient leaf (normwise) and each
#: parameter's change in a step (normwise)
TRAIN_CHECK_LAYERS, TRAIN_CHECK_B, TRAIN_CHECK_S = 6, 2, 64
TRAIN_LOSS_ATOL, TRAIN_GRAD_NORMWISE, TRAIN_CHANGE_NORMWISE = 2e-2, 2.0 ** -5, 2.0 ** -4
#: phase 21, the fault-tolerant loop: steps, checkpoint period, the step of
#: the injected crash, the checkpoint directory (under build/, which git
#: ignores) and the free disk it needs (two committed 12 GB train states)
RESUME_STEPS, RESUME_EVERY, RESUME_CRASH = 12, 8, 10
RESUME_DIR = ROOT / "build" / "phase21_ckpt"
RESUME_DISK_BYTES = 24e9
#: phase 22, gradient sync over ranks sharing the card: gemma3-1b at full
#: width cut to SYNC_LAYERS, the global batch (rows, tokens), the ranks; the
#: variants (StepConfig's sync options); the reference's limit on a
#: compressed sync against naive's parameters; the codecs forced on every
#: chunk class (the DCN's classes put every gemma3-1b leaf in Small, which
#: the reference's tables keep fp32), each with its limit on the synced
#: first gradient's distance (normwise) from the whole batch's gradient on
#: one rank: bf16 rounds each rank's gradient (H100 reading 0.00245), int8
#: quantizes an item to 127 levels of one scale (0.030); a rank's own
#: gradient, unsynced, must lie beyond both, or the limits tell nothing
SYNC_LAYERS, SYNC_B, SYNC_S, SYNC_RANKS = 6, 8, 512, 2
SYNC_VARIANTS = {
    "naive": dict(sync_algorithm="naive"),
    "sc": dict(sync_algorithm="sc", compress=False),
    "mc": dict(sync_algorithm="mc", compress=False),
    "promc": dict(sync_algorithm="promc", compress=False),
    "promc_bf16": dict(sync_algorithm="promc", compress=True, compress_codec="bf16"),
    "promc_int8": dict(sync_algorithm="promc", compress=True, compress_codec="int8"),
}
SYNC_COMPRESSED_MAX_ABS = 5e-3
SYNC_FORCED = {"bf16": 2.0 ** -7, "int8": 0.1}
#: the longest a started rank waits for phase 22 (phase 21 takes ~60 s)
SYNC_WAIT_S = 900


class SmokeFailure(RuntimeError):
    pass


class GcClock:
    """Host seconds the cyclic garbage collector has run in this process
    (``gc.callbacks``), to tell a host stall by collection from others."""

    def __init__(self):
        self.seconds = 0.0
        self._t0 = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self._t0 = None


GC = GcClock()


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
                    q, k, v, is_causal=causal, enable_gqa=True)
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
            print(f"[kernels] {name} B={B} H={H} KV={KV} S={S} T={T} D={D} causal={causal} "
                  f"window={window} {dtype}: "
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


def forced_run(m, prompt, forced, calls=None, extra=None, offset=0, blocks=None):
    """The prefill of ``prompt`` (B, S) (with the batch entries ``extra``:
    a VLM's ``prefix_embed``, an encoder-decoder's ``frames``) and one
    teacher-forced decode step for each row of ``forced`` (steps, B), at
    positions ``offset`` + S + i -> [(logits (B, V) fp32, cache)] on the
    CPU; ``calls`` collects (block, inputs, outputs) of each call of
    ``blocks`` (default ``m.layers``)."""
    import torch

    s = prompt.shape[1]
    blocks = m.layers if blocks is None else blocks
    hooks = [blk.register_forward_hook(
             lambda mod, args, out, i=i: calls.append((i, args, out)))
             for i, blk in enumerate(blocks)] if calls is not None else []
    batch = {"tokens": torch.as_tensor(prompt, device=m.device), **to_device(extra or {}, m.device)}
    with torch.inference_mode():
        lg, c = m.prefill(batch, m.init_cache(prompt.shape[0], offset + s + len(forced)))
        out = [(lg[:, 0], c)]
        for i, tok in enumerate(forced):
            out.append(m.decode_step(torch.as_tensor(tok, device=m.device), out[-1][1],
                                     offset + s + i))
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
    next layer carries that on. That drift is printed."""
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
    print(f"[check] rwkv6-3b full width cut to {CHECK_LAYERS} layers, card vs the port's CPU run "
          f"({secs:.1f}s): {CHECK_B} x {CHECK_PROMPT} prefill + {CHECK_STEPS} forced decode "
          f"steps; each layer on the CPU run's inputs: worst |wkv| difference {worst_wkv:.3g} "
          f"(limit 1e-3 + 1e-3 |x|), output head worst |logits| difference {worst_lg:.3g} "
          f"(limit 2e-2); WKV launches {launches}", flush=True)
    print(f"[check] free-running drift: card vs CPU worst |logits| {free_lg:.3g}, |wkv| by layer "
          f"{[float(f'{x:.3g}') for x in free_wkv]}", flush=True)
    fail_if(not worst_lg <= 2e-2, f"check: logits differ by {worst_lg:.3g}")
    return launches


def hybrid_card_against_cpu(rg, fa):
    """Phase 10: recurrentgemma-9b at full width cut to one period (R, R,
    L), on the card and in the port's CPU run with the same weights. As in
    phase 8, every block call of the CPU's prefill and forced decode steps
    is replayed on the card's block on the CPU's inputs (state, caches and
    block output held to the CPU's), and the card's output head is given
    the CPU's last hidden state; the free-running drift is printed. The card's
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
    print(f"[hybrid-check] recurrentgemma-9b full width cut to {HYB_CHECK_LAYERS} layers "
          f"({cfg.layer_types()}), card vs the port's CPU run ({secs:.1f}s; card and CPU runs "
          f"{cpu_s:.1f}s): {CHECK_B} x "
          f"{CHECK_PROMPT} prefill + {CHECK_STEPS} forced decode steps; each layer on the CPU "
          f"run's inputs: worst differences h {worst['h']:.3g}, conv {worst['conv']:.3g} (limit "
          f"1e-3 + 1e-3 |x|), k {worst['k']:.3g}, v {worst['v']:.3g} (limit 1e-2 + 1e-2 |x|), "
          f"block output {worst['out']:.3g} bf16 ulps of its largest magnitude (limit 2), "
          f"positions equal; output head worst "
          f"|logits| difference {worst_lg:.3g} (limit 2e-2); RG-LRU launches {launches}, flash "
          f"launches {flash} ({card_flash[0]} in the card's prefill, none in its decode steps)",
          flush=True)
    print(f"[hybrid-check] free-running drift: card vs CPU worst |logits| {free_lg:.3g}, worst "
          f"state difference by layer {[float(f'{x:.3g}') for x in free_st]}", flush=True)
    fail_if(not worst_lg <= 2e-2, f"hybrid check: logits differ by {worst_lg:.3g}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return launches, flash


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
    2e-2. The free-running card run's drift from the CPU is printed.
    Returns the flash launch count of the phase."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
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
    calls = []
    ref = forced_run(cpu, prompt, forced, calls)
    cpu_s = time.perf_counter() - t0

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
    print(f"[dense-check] gemma3-1b full width cut to {DENSE_CHECK_LAYERS} layers "
          f"({''.join(cfg.layer_types())}), card vs the port's CPU run ({secs:.1f}s; card and CPU "
          f"runs {cpu_s:.1f}s): {DENSE_CHECK_B} x "
          f"{DENSE_CHECK_PROMPT} prefill + {CHECK_STEPS} forced decode steps; each layer on the "
          f"CPU run's inputs: worst differences k {worst['k']:.3g}, v {worst['v']:.3g} bf16 ulps "
          f"of their largest magnitude (limit 1), block output {worst['out']:.3g} (limit 2); "
          f"output head worst |logits| difference {worst_lg:.3g} (limit 2e-2); flash launches "
          f"{launches} ({card_launches} in the card's prefill, none in its decode steps, "
          f"{DENSE_CHECK_LAYERS} in the replay)", flush=True)
    print(f"[dense-check] free-running drift: card vs CPU worst |logits| {free_lg:.3g}, worst k / v "
          f"difference by layer {[float(f'{x:.3g}') for x in free_kv]}", flush=True)
    fail_if(not worst_lg <= 2e-2, f"dense check: logits differ by {worst_lg:.3g}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def flash_calls():
    """Within the block, each call of the models' flash wrapper
    ``ops.flash_attention`` (q (B, S, H, D), k (B, T, KV, D)) is recorded
    as ((B, H, KV, S, T, D), causal, window) and passed on to it."""
    from repro_torch.kernels import ops

    real, seen = ops.flash_attention, []

    def spy(q, k, v, **kw):
        seen.append(((q.shape[0], q.shape[2], k.shape[2], q.shape[1], k.shape[1], q.shape[3]),
                     kw.get("causal", True), kw.get("window")))
        return real(q, k, v, **kw)

    ops.flash_attention = spy
    try:
        yield seen
    finally:
        ops.flash_attention = real


def family_flash_calls(cfg, b, s):
    """The flash calls one prefill of ``b`` requests of ``s`` tokens makes,
    as ``flash_calls`` records them: each decoder layer's causal
    self-attention over the prefix rows and the text; for an
    encoder-decoder first each encoder layer's unmasked attention over the
    frames, then each decoder layer's self and (unmasked) cross attention."""
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    n = cfg.num_prefix_tokens + s if cfg.frontend == "vision_stub" else s
    if not cfg.is_encdec:
        return [((b, h, kv, n, n, d), True, cfg.window_size if t == "L" else None)
                for t in cfg.layer_types()]
    f = cfg.encoder_seq
    return ([((b, h, kv, f, f, d), False, None)] * cfg.encoder_layers
            + [((b, h, kv, s, s, d), True, None), ((b, h, kv, s, f, d), False, None)]
            * cfg.num_layers)


def family_extra(cfg, b, device, seed):
    """The batch entries beside the tokens, normal draws from a seeded
    generator: a VLM's ``prefix_embed`` (B, 256, D), an encoder-decoder's
    ``frames`` (B, 1,500, D); none for a text-only model."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    if cfg.frontend == "vision_stub":
        return {"prefix_embed": torch.randn((b, cfg.num_prefix_tokens, cfg.d_model),
                                            generator=gen, device=device)}
    if cfg.is_encdec:
        return {"frames": torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen,
                                      device=device)}
    return {}


def serve_family(tag, arch, runs, fa, rg, wk, want_params, want_active):
    """Phases 11, 13, 15 and 17: ``arch`` at full width and depth through
    ``generate`` (fp32 weights from a seeded generator; seeded prompts,
    prefix rows or frames), one run a (requests, prompt tokens, new tokens)
    of ``runs``, every launch count set to 0 just before and read just
    after: each prefill attention goes through the tensor-core flash kernel
    at the shapes ``family_flash_calls`` names, decode attends with the
    plain attention, no recurrence kernel runs. Then prefill and decode timed
    apart, each prefill (and the first run's 4 decode steps) profiled, the
    peak device memory. Returns {run: flash launches of its generate}."""
    import numpy as np
    import torch

    from repro_torch.models.model import build_model, count_active_params
    from repro_torch.train.serve_step import generate, make_decode_step, make_prefill

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_model(arch, device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    init_s = time.perf_counter() - t0
    cfg = model.cfg
    active = count_active_params(cfg)
    fail_if((n_params, active) != (want_params, want_active),
            f"{tag}: {n_params:,} parameters, {active:,} active; expected {want_params:,}, "
            f"{want_active:,}")
    rng = np.random.RandomState(0)
    warm = torch.as_tensor(rng.randint(0, cfg.vocab_size, (2, 16)), device="cuda")
    generate(model, warm, 2, extra_batch=family_extra(cfg, 2, "cuda", 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    types = cfg.layer_types()
    print(f"[{tag}] {arch} full width and depth: {n_params:,} fp32 parameters ({active:,} "
          f"active a token; {n_params * 4 / 1e9:.1f} GB, init {init_s:.2f}s), {cfg.num_layers} "
          f"layers" + (f" + {cfg.encoder_layers} encoder layers" if cfg.is_encdec else "")
          + (f" ({types.count('L')} local, window {cfg.window_size}; {types.count('G')} global)"
             if "L" in types else "")
          + f", {cfg.num_heads} heads of {cfg.head_dim}, {cfg.num_kv_heads} KV heads"
          + (f", {cfg.num_experts} experts (top {cfg.top_k}, {cfg.num_shared_experts} shared)"
             if cfg.num_experts else ""), flush=True)
    prefill, decode = make_prefill(model), make_decode_step(model)
    offset = cfg.num_prefix_tokens if cfg.frontend == "vision_stub" else 0
    by_run = {}
    for b, s_len, new in runs:
        prompt = torch.as_tensor(rng.randint(0, cfg.vocab_size, (b, s_len)), device="cuda")
        extra = family_extra(cfg, b, "cuda", 2)
        torch.cuda.synchronize()
        fa.flash_attention.launches = fa.flash_attention.tc_launches = 0
        rg.rglru_scan.launches = wk.rwkv6_scan.launches = 0
        with flash_calls() as calls:
            t0 = time.perf_counter()
            tokens = generate(model, prompt, new, extra_batch=extra)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
        launches, tc = fa.flash_attention.launches, fa.flash_attention.tc_launches
        other = rg.rglru_scan.launches + wk.rwkv6_scan.launches
        want = family_flash_calls(cfg, b, s_len)
        label = f"{tag} {b}x{s_len}"
        by_run[f"{tag}_serve_{b}x{s_len}"] = launches
        fail_if(tuple(tokens.shape) != (b, new), f"{label}: tokens {tuple(tokens.shape)}")
        fail_if(not (0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size),
                f"{label}: tokens out of the vocabulary")
        fail_if(launches != len(want) or tc != launches or other != 0,
                f"{label}: {launches} flash launches, {tc} on the tensor cores (expected "
                f"{len(want)}: the prefill's attentions, none in decode, all on the tensor "
                f"cores), {other} recurrence launches")
        fail_if(calls != want,
                f"{label}: flash calls {sorted(set(calls), key=str)}, expected {sorted(set(want), key=str)}")

        # prefill and decode timed apart, on the same inputs
        batch = {"tokens": prompt, **extra}
        max_len = offset + s_len + new
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(batch, model.init_cache(b, max_len))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        fail_if(not bool(torch.isfinite(logits.float()).all()), f"{label}: non-finite prefill logits")
        tok = torch.argmax(logits[:, -1, :], dim=-1)
        fail_if(not torch.equal(tok, tokens[:, 0]), f"{label}: prefill token differs from generate's")
        t0 = time.perf_counter()
        for i in range(new - 1):
            tok, cache = decode(tok, cache, offset + s_len + i)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        fail_if(not torch.equal(tok, tokens[:, -1]), f"{label}: decode tokens differ from generate's")
        for name, c in cache.items():
            written = c if name == "enc_out" else c[:, :, :max_len - 1]
            fail_if(not bool(torch.isfinite(written.float()).all()),
                    f"{label}: non-finite {name} cache")
            fail_if(name != "enc_out" and bool(c[:, :, max_len - 1:].any()),
                    f"{label}: {name} cache written past the last step")
        steps = new - 1
        shapes = ", ".join(
            f"{want.count(k)} x {k[0]} {'causal' if k[1] else 'no mask'}"
            + (f" window {k[2]}" if k[2] is not None else "") for k in dict.fromkeys(want))
        print(f"[{tag}] {b} requests x {s_len} prompt tokens"
              + (f" (+ {offset} prefix rows each)" if offset else "")
              + (f" (+ {cfg.encoder_seq} frames each)" if cfg.is_encdec else "")
              + f", {new} new greedy tokens: generate {gen_s:.3f}s, flash launches {launches} "
              f"({tc} on the tensor cores: {shapes}, as (B, H, KV, S, T, D), in the prefill; "
              f"none in decode); prefill {prefill_s * 1e3:.1f} ms "
              f"({b * (offset + s_len) / prefill_s:.0f} tokens/s); decode {steps} steps in "
              f"{decode_s * 1e3:.1f} ms ({decode_s / steps * 1e3:.2f} ms a step, "
              f"{b * steps / decode_s:.1f} tokens/s)", flush=True)
        cache0 = model.init_cache(b, max_len)
        print(f"[{tag}] profiled prefill {b} x {s_len}: "
              f"{profile_window(lambda: prefill(batch, cache0), 'flash_fwd_sm90')}", flush=True)
        if (b, s_len, new) == runs[0]:
            print(f"[{tag}] profiled 4 decode steps: "
                  f"{profile_window(lambda: [decode(tok, cache, offset + s_len)[0] for _ in range(4)], 'flash_fwd_sm90')}",
                  flush=True)
        del cache, cache0, logits
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] peak device memory {peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB)", flush=True)
    fail_if(not peak < CARD_BYTES, f"{tag}: peak device memory {peak / 1e9:.2f} GB")
    del model
    torch.cuda.empty_cache()
    return by_run


def kept_experts(r, num_experts):
    """(tokens, E) bool: the experts that a routing's kept choices reach,
    token by token."""
    import torch

    k = r.ids.shape[-1]
    ids, keep = r.ids.reshape(-1, k), r.keep.reshape(-1, k)
    out = torch.zeros((ids.shape[0], num_experts), dtype=torch.bool, device=ids.device)
    return out.scatter_(1, ids, keep)


def routing_flips(r_card, r_cpu, where):
    """The tokens whose top-k expert ids (in order) differ between the
    card's and the CPU's routing of the same MoE input -> [(where, token,
    CPU ids, card ids, the widest CPU probability gap between two experts
    the runs swap, in fp32 ulps of the larger)]."""
    import numpy as np

    k = r_cpu.ids.shape[-1]
    a = r_cpu.ids.reshape(-1, k).numpy()
    b = r_card.ids.reshape(-1, k).cpu().numpy()
    probs = r_cpu.probs.reshape(a.shape[0], -1).numpy()
    out = []
    for t in np.nonzero((a != b).any(axis=1))[0]:
        ulps = max(abs(probs[t, x] - probs[t, y]) / np.spacing(max(probs[t, x], probs[t, y]))
                   for x, y in zip(a[t], b[t]) if x != y)
        out.append((where, int(t), a[t].tolist(), b[t].tolist(), float(ulps)))
    return out


def family_card_against_cpu(tag, arch, check, fa):
    """Phases 14, 16 and 18: ``arch`` at full width (cut to ``check[0]``
    layers; whisper-base whole), on the card and in the port's CPU run with
    the same weights: a prefill of check[1] requests of check[2] tokens (with
    seeded prefix rows or frames), then 4 teacher-forced decode steps. As in
    phases 8, 10 and 12, every block call of the CPU run (whisper: encoder
    and decoder blocks) is replayed on the card's block on the CPU's inputs,
    and the card's output head is given the CPU's last hidden state, with
    phase 12's limits: k / v within one bf16 ulp of their largest magnitude,
    block outputs within two, logits atol 2e-2.

    An MoE layer's routing is also computed on the card from the CPU's MoE
    input: its expert ids must equal the CPU's but at near-ties (the two
    experts' CPU probabilities within ROUTE_ULPS fp32 ulps), which are
    counted and listed. In the replay the card's block routes its own MoE
    input, which its attention rounds apart from the CPU's. A token whose
    kept experts differ from the CPU's there is left out of the block output
    check (routing is not continuous: one flip moves a row by far more than
    a bf16 ulp), counted and listed; the flip must be one the input's change
    explains: the swapped experts' CPU probabilities span no more than twice
    the largest change the card's input made to that token's probabilities.
    Returns the flash launch count of the phase."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    layers, b, s = check
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    gpu = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(1))
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, cfg.vocab_size, (b, s))
    forced = rng.randint(0, cfg.vocab_size, (CHECK_STEPS, b))
    extra = family_extra(cfg, b, "cpu", 4)
    offset = cfg.num_prefix_tokens if cfg.frontend == "vision_stub" else 0

    def blocks(m):
        return [*m.encoder, *m.decoder] if cfg.is_encdec else list(m.layers)

    gpu_blocks, cpu_blocks = blocks(gpu), blocks(cpu)
    t0 = time.perf_counter()
    fa.flash_attention.launches = fa.flash_attention.tc_launches = 0
    free = forced_run(gpu, prompt, forced, extra=extra, offset=offset, blocks=gpu_blocks)
    card_launches = fa.flash_attention.launches
    want = len(family_flash_calls(cfg, b, s))
    fail_if(card_launches != want or fa.flash_attention.tc_launches != want,
            f"{tag} check: {card_launches} flash launches in the card's run "
            f"({fa.flash_attention.tc_launches} on the tensor cores), expected {want} (the "
            "prefill's attentions, none in decode), all on the tensor cores")
    calls, moe_in = [], []
    hooks = [blk.moe.register_forward_hook(lambda mod, args, out: moe_in.append(args[0]))
             for blk in cpu_blocks if getattr(blk, "moe", None) is not None]
    ref = forced_run(cpu, prompt, forced, calls, extra=extra, offset=offset, blocks=cpu_blocks)
    for h in hooks:
        h.remove()
    cpu_s = time.perf_counter() - t0

    # the MoE input of each block call that has one, in call order
    moe_x = iter(moe_in)
    worst = {"k": 0.0, "v": 0.0, "out": 0.0}
    same_input, replay, routed = [], [], 0
    with torch.inference_mode():
        for n, (i, args, out) in enumerate(calls):
            block, where = gpu_blocks[i], f"block {i} call {n}"
            h_out, st_out = (out, {}) if isinstance(out, torch.Tensor) else out
            rows = None
            if getattr(block, "moe", None) is None:
                got = block(*to_device(args, "cuda"))
            else:
                x_cpu = next(moe_x)
                r_cpu = cpu_blocks[i].moe.route(x_cpu)
                flips = routing_flips(block.moe.route(x_cpu.cuda()), r_cpu, where)
                same_input += flips
                fail_if(any(f[-1] > ROUTE_ULPS for f in flips),
                        f"{tag} check: on the same MoE input the card routes past a near-tie: "
                        f"{[f for f in flips if f[-1] > ROUTE_ULPS][:5]}")
                seen = []
                hook = block.moe.register_forward_hook(lambda mod, a, o: seen.append(a[0]))
                got = block(*to_device(args, "cuda"))
                hook.remove()
                r_card = block.moe.route(seen[0])
                kept_cpu = kept_experts(r_cpu, cfg.num_experts)
                kept_card = kept_experts(r_card, cfg.num_experts).cpu()
                differ = (kept_cpu != kept_card).any(dim=1)
                routed += differ.numel()
                probs = r_cpu.probs.reshape(differ.numel(), -1)
                moved = (r_card.probs.cpu().reshape(differ.numel(), -1) - probs).abs().amax(dim=1)
                for t in torch.nonzero(differ).flatten().tolist():
                    swapped = torch.nonzero(kept_cpu[t] ^ kept_card[t]).flatten()
                    span = (probs[t, swapped].max() - probs[t, swapped].min()).item()
                    replay.append((where, t, swapped.tolist(), span, moved[t].item()))
                    fail_if(not span <= 2 * moved[t].item(),
                            f"{tag} check: {where} token {t} keeps experts {swapped.tolist()} "
                            f"apart on the card's input; their CPU probabilities span {span:.3g}, "
                            f"more than twice the input's change {moved[t].item():.3g}")
                rows = ~differ
            got_h, st = (got, {}) if isinstance(got, torch.Tensor) else got
            got_h, want_h = got_h.cpu().float(), h_out.float()
            if rows is not None:
                got_h = got_h.reshape(rows.numel(), -1)[rows]
                want_h = want_h.reshape(rows.numel(), -1)[rows]
            ulp = top_ulp(h_out)
            d = (got_h - want_h).abs().max().item() if got_h.numel() else 0.0
            worst["out"] = max(worst["out"], d / ulp)
            fail_if(not d <= 2 * ulp, f"{tag} check: {where} output differs by {d:.3g}, more than "
                    f"two bf16 ulps ({ulp:.3g}) of its largest magnitude")
            for k, w in st_out.items():
                d = (st[k].cpu().float() - w.float()).abs().max().item()
                worst[k] = max(worst[k], d / top_ulp(w))
                fail_if(not d <= top_ulp(w), f"{tag} check: {where} {k} differs by {d:.3g}, more "
                        f"than one bf16 ulp ({top_ulp(w):.3g}) of its largest magnitude")
        last = len(gpu_blocks) - 1
        finals = [out if isinstance(out, torch.Tensor) else out[0]
                  for i, _, out in calls if i == last]
        worst_lg = 0.0
        for h_last, (want_lg, _) in zip(finals, ref):
            got = gpu._logits(h_last[:, -1:, :].cuda())[:, 0].float().cpu()
            fail_if(not bool(torch.isfinite(got).all()), f"{tag} check: non-finite logits on the card")
            worst_lg = max(worst_lg, (got - want_lg).abs().max().item())
    secs = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    fail_if(launches != 2 * want, f"{tag} check: {launches} flash launches, expected {2 * want} "
            "(the card's prefill and the replay of its blocks)")
    free_lg = max((x[0] - y[0]).abs().max().item() for x, y in zip(free, ref))
    print(f"[{tag}-check] {arch} full width"
          + (f" cut to {layers} layers" if layers is not None else ", all layers")
          + f", card vs the port's CPU run ({secs:.1f}s; card and CPU runs {cpu_s:.1f}s): {b} x "
          f"{s} prefill" + (f" (+ {offset} prefix rows)" if offset else "")
          + (f" (+ {cfg.encoder_seq} frames)" if cfg.is_encdec else "")
          + f" + {CHECK_STEPS} forced decode steps; each of {len(gpu_blocks)} blocks on the CPU "
          f"run's inputs: worst differences k {worst['k']:.3g}, v {worst['v']:.3g} bf16 ulps of "
          f"their largest magnitude (limit 1), block output {worst['out']:.3g} (limit 2); output "
          f"head worst |logits| difference {worst_lg:.3g} (limit 2e-2); free-running card vs CPU "
          f"worst |logits| {free_lg:.3g}; flash launches {launches} ({card_launches} in the "
          f"card's prefill, none in its decode steps, {want} in the replay)", flush=True)
    if moe_in:
        print(f"[{tag}-check] routing of {len(moe_in)} MoE calls: on the CPU's MoE inputs "
              f"{len(same_input)} tokens take other expert ids on the card (near-ties, limit "
              f"{ROUTE_ULPS} fp32 ulps; where, token, CPU ids, card ids, ulps): "
              f"{same_input[:10]}; in the replay on the card's own inputs {len(replay)} of "
              f"{routed} tokens keep other experts, left out of the block output check (where, "
              f"token, swapped experts, their CPU probability span, the input's largest change "
              f"of that token's probabilities): {replay[:10]}", flush=True)
    fail_if(not worst_lg <= 2e-2, f"{tag} check: logits differ by {worst_lg:.3g}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return launches


def normwise(got, want) -> float:
    """||got - want|| / ||want|| of two tensors (0 where both are zero, inf
    where only the reference is), in fp32, the sums of squares by ``sum``
    (a cascade on the CPU): an fp32 ``norm`` on the CPU stalls past some
    2^24 terms a lane, so over the 463 M elements of phase 20's
    parameters it returns under half the true sum of squares."""
    got, want = got.float(), want.float()
    num = (got - want).pow(2).sum().sqrt().item()
    den = want.pow(2).sum().sqrt().item()
    return 0.0 if num == 0.0 else (num / den if den else math.inf)


def counts(fa, rg, wk):
    """(flash launches, of which on the tensor cores, scan launches) since
    the counts were last set to 0."""
    return (fa.flash_attention.launches, fa.flash_attention.tc_launches,
            rg.rglru_scan.launches + wk.rwkv6_scan.launches)


def zero_counts(fa, rg, wk):
    fa.flash_attention.launches = fa.flash_attention.tc_launches = 0
    rg.rglru_scan.launches = wk.rwkv6_scan.launches = 0


def softcap_factor_dropped(q, k, v, *, causal, window, logit_softcap):
    """kernels.ref.flash_attention_ref whose softcap passes its gradient
    straight through: the gradient of a backward that forgot the softcap's
    1 - tanh^2 factor (the forward is the plain version's)."""
    import numpy as np
    import torch

    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    f4 = torch.float32
    logits = torch.einsum("bkgsd,bktd->bkgst", q.reshape(b, kv, h // kv, s, d).to(f4), k.to(f4))
    logits = logits / float(np.sqrt(np.float32(d)))
    logits = logits + (torch.tanh(logits / logit_softcap) * logit_softcap - logits).detach()
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    p = torch.softmax(logits.masked_fill(~mask, -1e30), dim=-1)
    return torch.einsum("bkgst,bktd->bkgsd", p, v.to(f4)).reshape(b, h, s, d).to(q.dtype)


def grad_checks(fa, rg, wk):
    """Phase 3, gradients through the kernels: each autograd Function of
    kernels/ops.py on the card (its forward launches the kernel once, its
    backward, kernels/backward.py, launches none) against
    torch.autograd.grad through the plain version on the same inputs and
    output gradients: flash (bf16, FA_GRAD_CHECKS) each of dq, dk, dv within
    FA_GRAD_NORMWISE normwise; WKV-6 at WKV_GRAD_SHAPE with s0 and the final
    state's gradient within rtol = atol = WKV_GRAD_TOL; RG-LRU at
    RG_GRAD_SHAPE with h0 and the final state's gradient within
    RG_GRAD_TOL. A softcap check also fails unless a backward that dropped
    the softcap's 1 - tanh^2 factor would part from the plain gradient by
    more than FA_GRAD_NORMWISE. The backward and the plain version's
    autograd are timed. Returns {kernel: {check: row}}."""
    import torch

    from repro_torch.kernels import backward as bwd
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref, rglru_scan_ref, rwkv6_scan_ref

    def run(fn, plain, args, outs_grad, label, kernel):
        """(the Function's gradients, the plain version's), the Function
        launching its kernel once, in the forward."""
        leaves = [x.clone().requires_grad_() for x in args]
        zero_counts(fa, rg, wk)
        out = fn(*leaves)
        fwd = counts(fa, rg, wk)
        got = torch.autograd.grad(out, leaves, outs_grad)
        torch.cuda.synchronize()
        fail_if(counts(fa, rg, wk) != fwd, f"{label}: the backward launched a kernel")
        fail_if(fwd != kernel, f"{label}: launches {fwd} in the forward, expected {kernel}")
        ref_leaves = [x.clone().requires_grad_() for x in args]
        want = torch.autograd.grad(plain(*ref_leaves), ref_leaves, outs_grad)
        torch.cuda.synchronize()
        return got, want

    rows = {"flash_attention_sm90": {}, "rwkv6_scan": {}, "rglru_scan": {}}
    for i, check in enumerate(FA_GRAD_CHECKS):
        B, H, KV, S, T, D, causal, window, cap, q_scale = check
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        bf = torch.bfloat16
        q = (torch.randn((B, H, S, D), generator=gen, device="cuda") * q_scale).to(bf)
        k, v = (torch.randn((B, KV, T, D), generator=gen, device="cuda").to(bf) for _ in range(2))
        do = torch.randn((B, H, S, D), generator=gen, device="cuda").to(bf)
        kw = dict(causal=causal, window=window, logit_softcap=cap)
        label = f"flash gradient {(B, H, KV, S, T, D)} causal={causal} window={window} softcap={cap}"
        got, want = run(lambda *x: ops.FlashAttention.apply(*x, causal, window, cap),
                        lambda *x: flash_attention_ref(*x, **kw), (q, k, v), do, label, (1, 1, 0))
        errs = {}
        for name, g, w in zip("qkv", got, want):
            fail_if(g.dtype != bf or g.shape != w.shape, f"{label}: d{name} shape/dtype")
            errs[f"d{name}"] = normwise(g, w)
            fail_if(not errs[f"d{name}"] <= FA_GRAD_NORMWISE,
                    f"{label}: d{name} {errs[f'd{name}']:.3g} normwise > {FA_GRAD_NORMWISE:.3g}")
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        seen = ""
        if cap:  # what a backward without the softcap's factor would give
            dropped = torch.autograd.grad(
                softcap_factor_dropped(*leaves, **kw), leaves, do)
            errs["softcap_factor_dropped_dq"] = normwise(dropped[0], want[0])
            fail_if(not errs["softcap_factor_dropped_dq"] > FA_GRAD_NORMWISE,
                    f"{label}: dropping the softcap's factor moves dq by only "
                    f"{errs['softcap_factor_dropped_dq']:.3g}, within the limit")
            seen = (f"; a backward without the softcap's 1 - tanh^2 factor would be "
                    f"{errs['softcap_factor_dropped_dq']:.3g} off in dq")
        row = {"normwise": errs, "max_abs_err": max((g.float() - w.float()).abs().max().item()
                                                    for g, w in zip(got, want)),
               "backward_ms": event_ms(lambda: bwd.flash_attention_bwd(q, k, v, do, **kw), 5),
               "plain_backward_ms": event_ms(lambda: torch.autograd.grad(
                   flash_attention_ref(*leaves, **kw), leaves, do), 3)}
        rows["flash_attention_sm90"][check] = row
        print(f"[kernels] {label}: kernel forward + kernels/backward.py against autograd through "
              f"the plain version: normwise "
              f"{', '.join(f'{k} {errs[k]:.3g}' for k in ('dq', 'dk', 'dv'))} (limit {FA_GRAD_NORMWISE:.3g}){seen}; backward {row['backward_ms']:.3f} ms, the plain "
              f"version's autograd {row['plain_backward_ms']:.3f} ms", flush=True)

    B, H, T, D = WKV_GRAD_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(300)

    def draw(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    r, k, v = (draw(B, H, T, D, scale=0.5) for _ in range(3))
    w = torch.exp(-torch.exp(draw(B, H, T, D, scale=0.5)))
    args = (r, k, v, w, draw(H, D, scale=0.5), draw(B, H, D, D, scale=0.1))
    outs_grad = (draw(B, H, T, D), draw(B, H, D, D))
    label = f"WKV-6 gradient {WKV_GRAD_SHAPE}"
    got, want = run(ops.RwkvScan.apply, rwkv6_scan_ref, args, outs_grad, label, (0, 0, 1))
    excess = max(((g - x).abs() - WKV_GRAD_TOL * x.abs()).max().item() for g, x in zip(got, want))
    fail_if(not excess <= WKV_GRAD_TOL, f"{label}: outside rtol = atol = {WKV_GRAD_TOL}")
    row = {"max_abs_err": max((g - x).abs().max().item() for g, x in zip(got, want)),
           "backward_ms": event_ms(lambda: bwd.rwkv6_scan_bwd(*args, *outs_grad), 3)}
    rows["rwkv6_scan"][WKV_GRAD_SHAPE] = row
    print(f"[kernels] {label} (s0 and the final state's gradient): dr, dk, dv, dw, du, ds0 within "
          f"rtol = atol = {WKV_GRAD_TOL} of autograd through the plain version, max |error| "
          f"{row['max_abs_err']:.3g}; backward {row['backward_ms']:.3f} ms", flush=True)

    B, T, W = RG_GRAD_SHAPE
    args = (torch.sigmoid(draw(B, T, W)), draw(B, T, W, scale=0.5), draw(B, W, scale=0.5))
    outs_grad = (draw(B, T, W), draw(B, W))
    label = f"RG-LRU gradient {RG_GRAD_SHAPE}"
    got, want = run(ops.RglruScan.apply, rglru_scan_ref, args, outs_grad, label, (0, 0, 1))
    excess = max(((g - x).abs() - RG_GRAD_TOL * x.abs()).max().item() for g, x in zip(got, want))
    fail_if(not excess <= RG_GRAD_TOL, f"{label}: outside rtol = atol = {RG_GRAD_TOL}")
    h = rglru_scan_ref(*args)[0]
    row = {"max_abs_err": max((g - x).abs().max().item() for g, x in zip(got, want)),
           "backward_ms": event_ms(lambda: bwd.rglru_scan_bwd(args[0], args[2], h, *outs_grad), 3)}
    rows["rglru_scan"][RG_GRAD_SHAPE] = row
    print(f"[kernels] {label} (h0 and the final state's gradient): da, dx, dh0 within rtol = "
          f"atol = {RG_GRAD_TOL} of autograd through the plain version, max |error| "
          f"{row['max_abs_err']:.3g}; backward {row['backward_ms']:.3f} ms", flush=True)
    return rows


def train_full_width(fa, rg, wk):
    """Phase 19: gemma3-1b trained at full width and depth (999,812,736
    fp32 parameters from a seeded generator) through ``init_train_state``
    and ``make_train_step`` on SyntheticLM batches of TRAIN_B x TRAIN_S,
    with TRAIN_OPT. First the gradient of the first batch: the forward's
    flash calls recorded (one a layer, on the tensor cores, at the prefill's
    shapes), none launched by the backward, every parameter's gradient
    finite and non-zero (the tied table takes the head's gradient in every
    row). Then TRAIN_STEPS steps, each with the launch counts set to 0 just
    before and read just after (exactly one tensor-core flash launch a
    layer, no scan launch); the loss must fall by the reference's bar. Step
    time (median after the first), tokens/s, peak device memory and one
    profiled step. Returns the flash launches of the steps."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import (StepConfig, init_train_state, make_train_step,
                                              to_device_batch)

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_model("gemma3-1b", device="cuda")
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg, params = model.cfg, state["params"]
    n_params = sum(p.numel() for p in params.values())
    fail_if(n_params != 999_812_736, f"train: {n_params:,} parameters")
    t0 = time.perf_counter()
    batches = list(SyntheticLM(cfg, DataConfig(global_batch=TRAIN_B, seq_len=TRAIN_S))
                   .batches(TRAIN_STEPS))
    data_s = time.perf_counter() - t0
    layers = cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the first batch's gradient, the launch counts read between forward and backward
    batch = to_device_batch(batches[0], "cuda")
    zero_counts(fa, rg, wk)
    with flash_calls() as calls:
        loss, _ = model.loss(batch)
    fwd = counts(fa, rg, wk)
    grads = torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    fail_if(fwd != (layers, layers, 0) or counts(fa, rg, wk) != fwd,
            f"train: launches (flash, tensor cores, scans) {fwd} in the forward and "
            f"{counts(fa, rg, wk)} after the backward; expected ({layers}, {layers}, 0) in both")
    want = family_flash_calls(cfg, TRAIN_B, TRAIN_S)
    fail_if(calls != want, f"train: flash calls {sorted(set(calls), key=str)}, expected "
            f"{sorted(set(want), key=str)}")
    bad = [name for name, g in zip(params, grads)
           if not bool(torch.isfinite(g).all()) or not bool(g.any())]
    fail_if(bool(bad), f"train: non-finite or zero gradients: {bad}")
    first_loss = float(loss.detach())
    del grads, loss, batch

    step = make_train_step(model, StepConfig(optimizer=AdamWConfig(**TRAIN_OPT)))
    losses, secs, launches, log = [], [], 0, []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        zero_counts(fa, rg, wk)
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        got = counts(fa, rg, wk)
        fail_if(got != (layers, layers, 0),
                f"train step {i}: launches (flash, tensor cores, scans) {got}, expected "
                f"({layers}, {layers}, 0): one a layer's forward, none from the backward")
        launches += got[0]
        m = {k: float(x) for k, x in metrics.items()}
        fail_if(not all(math.isfinite(x) for x in m.values()), f"train step {i}: metrics {m}")
        losses.append(m["loss"])
        log.append(f"{m['loss']:.4f}/{m['grad_norm']:.3g}")
    peak = torch.cuda.max_memory_allocated()
    first, last = float(np.mean(losses[:2])), float(np.mean(losses[-2:]))
    med = float(np.median(secs[1:]))
    tokens = TRAIN_B * TRAIN_S
    print(f"[train] gemma3-1b full width and depth: {n_params:,} fp32 parameters (init with the "
          f"optimizer state {init_s:.2f}s), {layers} layers; {TRAIN_STEPS} steps of "
          f"{TRAIN_B} x {TRAIN_S} SyntheticLM tokens (made in {data_s:.2f}s), AdamW {TRAIN_OPT}; "
          f"first batch's loss {first_loss:.4f}, every gradient finite and non-zero; flash "
          f"launches {launches} ({layers} a step, all on the tensor cores, none from the "
          f"backward)", flush=True)
    print(f"[train] loss / grad norm by step: {' '.join(log)}; mean of the first two "
          f"{first:.4f}, of the last two {last:.4f} ({last / first:.3f}x, bar "
          f"{TRAIN_LOSS_BAR})", flush=True)
    print(f"[train] step time: first {secs[0] * 1e3:.1f} ms, median of the rest "
          f"{med * 1e3:.1f} ms (min {min(secs[1:]) * 1e3:.1f}, max {max(secs[1:]) * 1e3:.1f}); "
          f"{tokens / med:.0f} tokens/s; peak device memory {peak / 1e9:.2f} GB "
          f"({peak / 2**30:.2f} GiB)", flush=True)
    fail_if(not last < TRAIN_LOSS_BAR * first,
            f"train: the loss did not fall by the bar: {first:.4f} -> {last:.4f}")
    fail_if(not peak < CARD_BYTES, f"train: peak device memory {peak / 1e9:.2f} GB")
    print(f"[train] profiled step: {profile_window(lambda: step(state, batches[-1]), 'flash_fwd_sm90')}",
          flush=True)
    del model, state, step, params
    torch.cuda.empty_cache()
    return launches


def train_card_against_cpu(fa, rg, wk):
    """Phase 20: gemma3-1b cut to one period (L x 5, G) at full width, on
    the card and in the port's CPU run from the same weights, TRAIN_CHECK_B
    x TRAIN_CHECK_S tokens with TRAIN_OPT. The first batch: the loss within
    TRAIN_LOSS_ATOL and every gradient leaf within TRAIN_GRAD_NORMWISE
    normwise of the CPU's; then each side's AdamW update on its gradient
    (the train step's update, from the zero moments): each leaf's first
    moment (linear in the clipped gradient) within TRAIN_GRAD_NORMWISE
    normwise, and each parameter's change within TRAIN_CHANGE_NORMWISE
    normwise over the elements whose CPU gradient exceeds the card's error
    there. Adam's first step moves an element by lr x g / (|g| + eps), so
    an element whose gradient lies within its error of zero may move
    either way; the share of such elements, and the share of the change's
    squared error on them, are printed. The CPU then takes
    the card's state (weights, moments, count) and both take one train step
    on the second batch: its loss within TRAIN_LOSS_ATOL and each
    parameter's change within TRAIN_CHANGE_NORMWISE normwise of the CPU's.
    Returns the flash launches of the card's runs (kept out of the main
    path's count)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_update
    from repro_torch.train.train_step import (StepConfig, loss_and_grads, make_train_step,
                                              to_device_batch, train_state)

    t_start = time.perf_counter()
    cfg = dataclasses.replace(get_config("gemma3-1b"), num_layers=TRAIN_CHECK_LAYERS)
    gpu = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(1))
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    batch_a, batch_b = SyntheticLM(cfg, DataConfig(global_batch=TRAIN_CHECK_B,
                                                   seq_len=TRAIN_CHECK_S, seed=1)).batches(2)
    models = {"card": gpu, "cpu": cpu}
    states = {run: train_state(m) for run, m in models.items()}
    steps = {run: make_train_step(m, StepConfig(optimizer=AdamWConfig(**TRAIN_OPT)))
             for run, m in models.items()}

    def host(tree):
        return {n: t.detach().float().cpu().clone() for n, t in tree.items()}

    def changed(run, before):
        return {n: p - before[n] for n, p in host(states[run]["params"]).items()}

    zero_counts(fa, rg, wk)
    out, secs = {}, {}
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    for run, m in models.items():
        t0 = time.perf_counter()
        st = states[run]
        loss, _, grads = loss_and_grads(m, st["params"], to_device_batch(batch_a, m.device))
        before = host(st["params"])
        _, st["opt"], _ = adamw_update(opt_cfg, st["params"], grads, st["opt"])
        st["step"] = st["step"] + 1
        out[run] = (float(loss), host(grads), changed(run, before), host(st["opt"]["m"]))
        secs[run] = time.perf_counter() - t0
        del grads
    card = counts(fa, rg, wk)
    fail_if(card != (TRAIN_CHECK_LAYERS, TRAIN_CHECK_LAYERS, 0),
            f"train check: launches (flash, tensor cores, scans) {card} on the card, expected "
            f"{TRAIN_CHECK_LAYERS} flash on the tensor cores (one a layer's forward)")
    loss_err = abs(out["card"][0] - out["cpu"][0])
    grad_errs = {n: normwise(g, out["cpu"][1][n]) for n, g in out["card"][1].items()}
    moment_errs = {n: normwise(m, out["cpu"][3][n]) for n, m in out["card"][3].items()}
    # the first update's change over the elements whose gradient the card resolves
    cold, sq_err, sq_cpu, sq_unresolved, n_unresolved, n_all = {}, 0.0, 0.0, 0.0, 0, 0
    for n, g in out["card"][1].items():
        g_cpu, d_card, d_cpu = out["cpu"][1][n], out["card"][2][n], out["cpu"][2][n]
        resolved = g_cpu.abs() > (g - g_cpu).abs()
        cold[n] = normwise(d_card[resolved], d_cpu[resolved])
        sq = (d_card - d_cpu).pow(2)
        sq_err += sq.sum().item()
        sq_cpu += d_cpu.pow(2).sum().item()
        sq_unresolved += sq[~resolved].sum().item()
        n_unresolved += int((~resolved).sum())
        n_all += resolved.numel()
    bad = {n: e for n, e in grad_errs.items() if not e <= TRAIN_GRAD_NORMWISE}
    bad_moment = {n: e for n, e in moment_errs.items() if not e <= TRAIN_GRAD_NORMWISE}
    bad_cold = {n: e for n, e in cold.items() if not e <= TRAIN_CHANGE_NORMWISE}
    # the warm step: the CPU from the card's state
    with torch.no_grad():
        cpu.load_state_dict(gpu.state_dict())
    opt = states["card"]["opt"]
    states["cpu"]["opt"] = {"m": host(opt["m"]), "v": host(opt["v"]),
                            "count": opt["count"].cpu().clone()}
    states["cpu"]["step"] = states["card"]["step"].cpu().clone()
    warm = {}
    for run in models:
        before = host(states[run]["params"])
        states[run], metrics = steps[run](states[run], batch_b)
        warm[run] = (float(metrics["loss"]), changed(run, before))
    card = counts(fa, rg, wk)
    fail_if(card != (2 * TRAIN_CHECK_LAYERS, 2 * TRAIN_CHECK_LAYERS, 0),
            f"train check: launches (flash, tensor cores, scans) {card} on the card after the "
            f"second step, expected {2 * TRAIN_CHECK_LAYERS} flash on the tensor cores")
    warm_loss_err = abs(warm["card"][0] - warm["cpu"][0])
    warm_errs = {n: normwise(c, warm["cpu"][1][n]) for n, c in warm["card"][1].items()}
    worst = lambda errs: max(errs.items(), key=lambda kv: kv[1])  # noqa: E731
    print(f"[train-check] gemma3-1b full width cut to {TRAIN_CHECK_LAYERS} layers "
          f"({''.join(cfg.layer_types())}), card vs the port's CPU run "
          f"({time.perf_counter() - t_start:.1f}s; the first batch's gradient and update: card "
          f"{secs['card']:.1f}s, CPU {secs['cpu']:.1f}s), {TRAIN_CHECK_B} x {TRAIN_CHECK_S} "
          f"tokens: loss {out['card'][0]:.5f} / {out['cpu'][0]:.5f} (difference {loss_err:.3g}, "
          f"limit {TRAIN_LOSS_ATOL}); gradient leaves normwise worst {worst(grad_errs)} (limit "
          f"{TRAIN_GRAD_NORMWISE:.3g}), median "
          f"{sorted(grad_errs.values())[len(grad_errs) // 2]:.3g}", flush=True)
    print(f"[train-check] the first update from zero moments: first moment normwise worst leaf "
          f"{worst(moment_errs)} (limit {TRAIN_GRAD_NORMWISE:.3g}); change normwise over the "
          f"elements whose CPU gradient exceeds the card's error there, worst leaf {worst(cold)} "
          f"(limit {TRAIN_CHANGE_NORMWISE:.3g}); over all elements "
          f"{math.sqrt(sq_err / sq_cpu):.3g}, {100 * sq_unresolved / max(sq_err, 1e-300):.2f}% "
          f"of its square on the {n_unresolved} of {n_all} elements "
          f"({100 * n_unresolved / n_all:.3f}%) whose gradient lies within its error of zero",
          flush=True)
    print(f"[train-check] the step from the card's state on the second batch: loss difference "
          f"{warm_loss_err:.3g} (limit {TRAIN_LOSS_ATOL}), change normwise worst leaf "
          f"{worst(warm_errs)} (limit {TRAIN_CHANGE_NORMWISE:.3g}), median "
          f"{sorted(warm_errs.values())[len(warm_errs) // 2]:.3g}; flash launches on the card "
          f"{card[0]}", flush=True)
    fail_if(not loss_err <= TRAIN_LOSS_ATOL, f"train check: loss differs by {loss_err:.3g}")
    fail_if(bool(bad), f"train check: gradient leaves past {TRAIN_GRAD_NORMWISE:.3g} "
            f"normwise: {bad}")
    fail_if(bool(bad_moment), f"train check: first moments past {TRAIN_GRAD_NORMWISE:.3g} "
            f"normwise: {bad_moment}")
    fail_if(bool(bad_cold), f"train check: the first update's change past "
            f"{TRAIN_CHANGE_NORMWISE:.3g} normwise where the gradient is resolved: {bad_cold}")
    fail_if(not warm_loss_err <= TRAIN_LOSS_ATOL,
            f"train check: the second step's loss differs by {warm_loss_err:.3g}")
    bad = {n: e for n, e in warm_errs.items() if not e <= TRAIN_CHANGE_NORMWISE}
    fail_if(bool(bad), f"train check: parameter changes past {TRAIN_CHANGE_NORMWISE:.3g} "
            f"normwise: {bad}")
    del gpu, cpu, states, steps
    torch.cuda.empty_cache()
    return card[0]


class RssPeak:
    """The process's peak resident memory while it runs, sampled from
    /proc/self/statm every 20 ms on a thread of its own (the kernel's
    high-water mark covers the whole process's life)."""

    def __init__(self):
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def sample() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, self.sample())
            self._stop.wait(0.02)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.sample())


def train_resume_full_width(fa, rg, wk):
    """Phase 21: gemma3-1b's fault-tolerant training loop at full width and
    depth. A straight run of RESUME_STEPS steps through ``train.loop.train``;
    then ``train_with_restarts`` (one failure allowed) around a fresh
    model's run of RESUME_STEPS with an asynchronous checkpoint every
    RESUME_EVERY steps in RESUME_DIR: its first attempt crashes at step
    RESUME_CRASH, its second restores and finishes. Each run takes a
    ``Prefetcher`` of phase 19's batches and TRAIN_OPT; the launch counts
    are set to 0 before each run and after each step's metrics are read.
    Gates: 2 attempts; after the crash only the step-RESUME_EVERY
    checkpoint committed, a file a leaf and the state's bytes; the final
    state and the resumed steps' losses bit for bit the straight run's; one
    tensor-core flash launch a layer in every step; peak device memory.
    Returns the flash launches of the straight and the supervised runs."""
    import resource
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.distributed.fault import RestartPolicy
    from repro_torch.models.model import build_model, is_param_leaf, tree_leaves
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import LoopConfig, train, train_with_restarts
    from repro_torch.train.train_step import StepConfig

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    d = RESUME_DIR
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    steps, reports, attempts, prefetchers, models = [], [], [], [], []

    def on_metrics(run):
        def record(step, entry):
            steps.append((run, step, counts(fa, rg, wk), time.monotonic(), entry))
            zero_counts(fa, rg, wk)
        return record

    def batches():
        prefetchers.append(Prefetcher(data.batches()))
        return prefetchers[-1]

    def fresh_model():
        gc.collect()
        torch.cuda.empty_cache()
        return build_model("gemma3-1b", device="cuda")

    def run_once(batch_iter):
        n = len(attempts) + 1
        models.clear()  # the crashed attempt's model goes before the next is built
        models.append(fresh_model())
        committed = {p.name: sorted(os.listdir(p)) for p in sorted(d.iterdir())}
        sizes = sum(f.stat().st_size for p in d.iterdir() for f in p.iterdir()
                    if f.name != "index.json")
        attempts.append({"committed": committed, "leaf_bytes": sizes})
        zero_counts(fa, rg, wk)
        try:
            result = train(models[-1], step_cfg, batch_iter, LoopConfig(
                total_steps=RESUME_STEPS, ckpt_every=RESUME_EVERY, ckpt_dir=str(d),
                async_ckpt=True, log_every=1), crash_at=RESUME_CRASH if n == 1 else None,
                on_metrics=on_metrics(f"attempt{n}"), on_checkpoint=reports.append)
        except RuntimeError:
            steps.append((f"attempt{n}", "crash", counts(fa, rg, wk), time.monotonic(), None))
            raise
        finally:
            prefetchers[-1].close()
        return result

    try:
        free = shutil.disk_usage(d).free
        fail_if(free < RESUME_DISK_BYTES,
                f"resume: {free / 1e9:.1f} GB free at {d}; the phase needs "
                f"{RESUME_DISK_BYTES / 1e9:.0f} GB (two committed gemma3-1b train states)")
        data = SyntheticLM(get_config("gemma3-1b"),
                           DataConfig(global_batch=TRAIN_B, seq_len=TRAIN_S))
        step_cfg = StepConfig(optimizer=AdamWConfig(**TRAIN_OPT))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with RssPeak() as rss:
            straight_model = fresh_model()
            zero_counts(fa, rg, wk)
            t0 = time.perf_counter()
            straight = train(straight_model, step_cfg, batches(),
                             LoopConfig(total_steps=RESUME_STEPS, ckpt_dir=None, log_every=1),
                             on_metrics=on_metrics("straight"))
            prefetchers[-1].close()
            straight_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            resumed = train_with_restarts(batches, run_once, RestartPolicy(max_failures=1))
            supervised_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(d, ignore_errors=True)

    # ---- gates ----
    layers = straight_model.cfg.num_layers
    model = models[-1]
    n_leaves = 3 * len(tree_leaves(model.param_tree(), is_param_leaf)) + 2
    n_params = sum(p.numel() for p in model.parameters())
    state_bytes = 3 * 4 * n_params + 2 * 4 + n_leaves * 128  # fp32 / int32, npy headers
    fail_if(len(attempts) != 2, f"resume: {len(attempts)} attempts, expected 2")
    after_crash = attempts[1]["committed"]
    want_dir = f"step_{RESUME_EVERY:08d}"
    fail_if(list(after_crash) != [want_dir] or len(after_crash[want_dir]) != n_leaves + 1
            or "index.json" not in after_crash[want_dir]
            or attempts[1]["leaf_bytes"] != state_bytes,
            f"resume: after the crash the checkpoint directory held {after_crash} "
            f"({attempts[1]['leaf_bytes']:,} bytes of leaves), expected only {want_dir} with "
            f"{n_leaves} leaf files ({state_bytes:,} bytes) and index.json")
    runs = {}
    for run, step, got, _, _ in steps:
        runs.setdefault(run, []).append(step)
        fail_if(got != (layers, layers, 0),
                f"resume: {run} step {step}: launches (flash, tensor cores, scans) {got}, "
                f"expected ({layers}, {layers}, 0)")
    want_steps = {"straight": list(range(1, RESUME_STEPS + 1)),
                  "attempt1": list(range(1, RESUME_CRASH)) + ["crash"],
                  "attempt2": list(range(RESUME_EVERY + 1, RESUME_STEPS + 1))}
    fail_if(runs != want_steps, f"resume: steps by run {runs}, expected {want_steps}")
    losses = {run: [e["loss"] for r, _, _, _, e in steps if r == run and e]
              for run in ("straight", "attempt2")}
    resumed_losses = losses["straight"][RESUME_EVERY:]
    bad_losses = [(RESUME_EVERY + 1 + i, a, b) for i, (a, b) in
                  enumerate(zip(resumed_losses, losses["attempt2"])) if a != b]
    a_state, b_state = straight["state"], resumed["state"]
    leaves = {("params", n): (p, dict(model.named_parameters())[n])
              for n, p in straight_model.named_parameters()}
    for part in ("m", "v"):
        leaves.update({(part, n): (t, b_state["opt"][part][n])
                       for n, t in a_state["opt"][part].items()})
    leaves["count"] = (a_state["opt"]["count"], b_state["opt"]["count"])
    leaves["step"] = (a_state["step"], b_state["step"])
    differ = [k for k, (a, b) in leaves.items()
              if not (a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b))]
    n_elems = sum(a.numel() for a, _ in leaves.values())
    print(f"[resume] gemma3-1b full width and depth, {layers} layers, {n_params:,} parameters; "
          f"straight: {RESUME_STEPS} steps in {straight_s:.1f}s; supervised: {len(attempts)} "
          f"attempts in {supervised_s:.1f}s (crash at step {RESUME_CRASH} after the asynchronous "
          f"save of step {RESUME_EVERY}; then {want_dir} alone committed, {n_leaves} leaf files, "
          f"{attempts[1]['leaf_bytes']:,} bytes); resumed at step {RESUME_EVERY}: the final state "
          f"against the straight run's, {len(leaves)} leaves ({n_elems:,} values): "
          f"{len(differ)} differ; the losses of steps {RESUME_EVERY + 1}-{RESUME_STEPS}: "
          f"{' '.join(f'{x:.6f}' for x in losses['attempt2'])} ({len(bad_losses)} differ); "
          f"flash launches {layers} in each of the {len(steps)} steps, all on the tensor cores",
          flush=True)

    # ---- readings ----
    saves = [r for r in reports if r.kind == "save"]
    (restore,) = [r for r in reports if r.kind == "restore"]
    for r in saves:
        e = r.engine
        chunks = "; ".join(f"{name} {n} files {b / 1e9:.3f} GB (pp, p, cc) {params}"
                           for name, n, b, params in r.chunks)
        print(f"[resume] save of step {r.step} "
              f"({'asynchronous' if r.snapshot_s else 'synchronous, at the end'}): snapshot to "
              f"the host {r.snapshot_s:.2f}s on the loop thread; the save {r.seconds:.2f}s "
              f"(the leaves to the host and serialized {r.serialize_s:.2f}s, the engine "
              f"{e.total_time:.2f}s) for {r.files} files, {r.bytes:,} bytes, the engine "
              f"{e.throughput / 1e9:.3f} GB/s ({e.scheduler}, {e.n_moves} moves); chunks: "
              f"{chunks} | {smi}", flush=True)
    print(f"[resume] restore of step {restore.step}: {restore.seconds:.2f}s for {restore.files} "
          f"files, {restore.bytes:,} bytes, {restore.bytes / restore.seconds / 1e9:.3f} GB/s "
          f"(warm: the files were just written) | {smi}", flush=True)
    (async_save,) = [r for r in saves if r.snapshot_s]
    overlap, alone = [], []
    for run, step, _, t_end, entry in steps:
        if entry is None or step == 1 or (run == "attempt2" and step == RESUME_EVERY + 1):
            continue  # the crashed step has no metrics; a run's first step warms up
        dt = entry["time_s"]
        # a step after the saved one that starts before the save has ended
        # (the metrics of the saved step are read after its snapshot)
        hit = run == "attempt1" and step > async_save.step and t_end - dt < async_save.end
        (overlap if hit else alone).append(dt)
    print(f"[resume] step time: median {np.median(alone) * 1e3:.1f} ms over the {len(alone)} "
          f"steps without a save beside them (each run's first left out), "
          f"{np.median(overlap) * 1e3 if overlap else math.nan:.1f} ms over the {len(overlap)} "
          f"that overlap the asynchronous save "
          f"({', '.join(f'{x * 1e3:.1f}' for x in overlap)} ms) | {smi}", flush=True)
    print(f"[resume] host peak RSS {rss.peak / 1e9:.2f} GB in the phase (the process's "
          f"high-water mark {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9:.2f}"
          f" GB); free disk at the checkpoint directory {free / 1e9:.1f} GB; peak device memory "
          f"{peak / 1e9:.2f} GB; the phase {time.perf_counter() - t_start:.1f}s", flush=True)
    fail_if(bool(differ), f"resume: the resumed state differs from the straight run's in "
            f"{len(differ)} leaves: {differ[:8]}")
    fail_if(bool(bad_losses), f"resume: resumed losses differ (step, straight, resumed): "
            f"{bad_losses}")
    fail_if(not peak < CARD_BYTES, f"resume: peak device memory {peak / 1e9:.2f} GB")
    launches = {run: sum(got[0] for r, _, got, _, _ in steps if r.startswith(run))
                for run in ("straight", "attempt")}
    del straight, resumed, straight_model, model, models, leaves, a_state, b_state
    torch.cuda.empty_cache()
    return launches["straight"], launches["attempt"]


def bit_fingerprint(tensors) -> list:
    """Two int64 sums a 16 M-element block of each tensor's fp32 bits (as
    int32), one of them position-weighted (weights 1..65,521): equal bits
    give equal lists, and a flipped bit changes both sums of its block."""
    import torch

    out = []
    for t in tensors:
        bits = t.detach().reshape(-1).view(torch.int32)
        for lo in range(0, bits.numel(), 1 << 24):
            b = bits[lo:lo + (1 << 24)].to(torch.int64)
            w = torch.arange(lo, lo + b.numel(), device=b.device, dtype=torch.int64) % 65521 + 1
            out += [int(b.sum()), int((b * w).sum())]
    return out


def sync_rank(rank, out_dir):
    """Phase 22's rank ``rank`` of SYNC_RANKS (a spawned process, started
    ahead by ``start_sync_ranks``): joins the group through a ``file://``
    store in ``out_dir`` (``init_pods`` on the card: the ranks share it, so
    gloo over CUDA tensors) and makes its context on the card, waits for
    the file ``go`` there (SYNC_WAIT_S at most), then builds gemma3-1b at
    full width cut to
    SYNC_LAYERS from seed 0, then one train step of each SYNC_VARIANTS
    entry from that state on the global batch (its rows of the rank), the
    launch counts set to 0 just before and read just after. Then rank 0
    alone takes the whole batch's gradient and one step from the same
    state (the other rank frees its memory meanwhile), and both sync their
    first gradient by the promc plan with each SYNC_FORCED codec on every
    class; rank 0 holds each result, and its own gradient unsynced (the
    limits' control), to the whole batch's gradient. Writes its readings
    as JSON to ``out_dir``."""
    import dataclasses

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.core.types import ChunkType
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.distributed import grad_sync
    from repro_torch.distributed.pods import close_pods, init_pods, local_rows
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import build_model, leaf_paths
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import (StepConfig, loss_and_grads, make_train_step,
                                              to_device_batch, train_state, tree_of)

    pods = init_pods(rank, SYNC_RANKS, init_method=f"file://{os.path.join(out_dir, 'store')}")
    out = {"rank": rank, "backend": pods.backend, "device": str(pods.device),
           "variants": {}, "forced": {}}
    try:
        dev = pods.device
        torch.zeros(1, device=dev)  # the context on the card, before the wait
        waited = time.perf_counter()
        while not os.path.exists(os.path.join(out_dir, "go")):
            if time.perf_counter() - waited > SYNC_WAIT_S:
                raise TimeoutError(f"rank {rank}: no go after {SYNC_WAIT_S}s")
            time.sleep(0.05)
        t_start = time.perf_counter()
        cfg = dataclasses.replace(get_config("gemma3-1b"), num_layers=SYNC_LAYERS)
        model = build_model(cfg, device=dev)
        names = sorted(n for n, _ in model.named_parameters())
        batch = next(SyntheticLM(cfg, DataConfig(global_batch=SYNC_B, seq_len=SYNC_S)).batches(1))

        def reset():
            """The phase's start: seed 0's weights, zero moments, step 0."""
            model.init(torch.Generator(device=dev).manual_seed(0))
            return train_state(model)

        def flat(tree):
            return [t for _, leaf in leaf_paths(tree)
                    for t in (leaf if isinstance(leaf, list) else [leaf])]

        def from_whole(got):
            """(normwise, max abs) distance of ``got`` from ``whole``."""
            num = sum((g - r).double().pow(2).sum().item() for g, r in zip(got, whole))
            den = sum(r.double().pow(2).sum().item() for r in whole)
            return math.sqrt(num / den), max((g - r).abs().max().item()
                                             for g, r in zip(got, whole))

        out["setup_s"] = time.perf_counter() - t_start
        naive = None
        for name, kw in SYNC_VARIANTS.items():
            state = reset()
            step = make_train_step(model, StepConfig(optimizer=AdamWConfig(**TRAIN_OPT), **kw),
                                   group=pods.group)
            torch.cuda.synchronize(dev)
            dist.barrier()
            fa.flash_attention.launches = fa.flash_attention.tc_launches = 0
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize(dev)
            secs = time.perf_counter() - t0
            launches = (fa.flash_attention.launches, fa.flash_attention.tc_launches)
            params = [state["params"][n] for n in names]
            if naive is None:
                naive = [p.detach().clone() for p in params]
            rep = step.last_sync
            out["variants"][name] = {
                "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                "step_s": secs, "sync_s": rep.seconds, "collectives": rep.collectives,
                "max_outstanding": rep.max_outstanding, "wire_bytes": rep.wire_bytes,
                "launches": launches,
                "same_as_naive": all(torch.equal(p, q) for p, q in zip(params, naive)),
                "max_abs_from_naive": max((p - q).abs().max().item()
                                          for p, q in zip(params, naive)),
                "fingerprint": bit_fingerprint(params),
            }
            del state, step, metrics, params
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)

        # rank 0: the whole batch's gradient and one step of it alone
        whole = None
        if rank != 0:
            del naive
            torch.cuda.empty_cache()
        else:
            from repro_torch.optim.adamw import adamw_update

            state = reset()
            init = [state["params"][n].detach().clone() for n in names]
            fa.flash_attention.launches = 0
            t0 = time.perf_counter()
            loss, _, grads = loss_and_grads(model, state["params"],
                                            to_device_batch(batch, dev))
            _, state["opt"], _ = adamw_update(AdamWConfig(**TRAIN_OPT), state["params"], grads,
                                              state["opt"])
            torch.cuda.synchronize(dev)
            secs = time.perf_counter() - t0
            whole = flat(tree_of(model, grads))
            del grads
            num = den = 0.0
            for n, q, i in zip(names, naive, init):
                d1, d2 = state["params"][n] - i, q - i
                num += (d2 - d1).double().pow(2).sum().item()
                den += d1.double().pow(2).sum().item()
            out["one_rank"] = {"loss": float(loss), "step_s": secs,
                               "launches": fa.flash_attention.launches,
                               "change_normwise": math.sqrt(num / den)}
            del naive, init, state
            torch.cuda.empty_cache()
        dist.barrier()

        # the codecs on every class of the promc plan, on this rank's first gradient
        state = reset()
        _, _, grads = loss_and_grads(model, state["params"], to_device_batch(
            local_rows(batch, rank, SYNC_RANKS), dev))
        tree = tree_of(model, grads)
        if whole is not None:
            out["local_from_whole"] = from_whole(flat(tree))
        for codec in SYNC_FORCED:
            plan = grad_sync.build_sync_plan(
                tree, algorithm="promc", compress_by_class={t: codec for t in ChunkType})
            rep = grad_sync.SyncReport()
            torch.cuda.synchronize(dev)
            dist.barrier()
            synced, _ = grad_sync.apply_sync(plan, tree, group=pods.group, report=rep)
            torch.cuda.synchronize(dev)
            got = flat(synced)
            row = {"sync_s": rep.seconds, "collectives": rep.collectives,
                   "wire_bytes": rep.wire_bytes,
                   "finite": all(bool(torch.isfinite(g).all()) for g in got),
                   "fingerprint": bit_fingerprint(got)}
            if whole is not None:
                row["normwise_from_whole"], row["max_abs_from_whole"] = from_whole(got)
            out["forced"][codec] = row
            del synced, got
        dist.barrier()
        out["seconds"] = time.perf_counter() - t_start
    finally:
        close_pods()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def start_sync_ranks():
    """Start phase 22's ranks (``sync_rank``, spawned daemons, so they end
    with this process): their interpreter, torch, the group's rendezvous and
    their context on the card take ~10 s, which they spend beside the
    phases before 22. -> (their process context, their directory under
    build/)."""
    import tempfile

    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(prefix="phase22_", dir=ROOT / "build")
    # the ranks' allocators map growing segments (less held and unused)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ctx = mp.start_processes(sync_rank, args=(out_dir,), nprocs=SYNC_RANKS, join=False,
                                 daemon=True, start_method="spawn")
    finally:
        del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
    return ctx, out_dir


def grad_sync_phase(ranks_started, smi):
    """Phase 22: gradient sync over SYNC_RANKS ranks that share the card
    (``ranks_started``: ``start_sync_ranks``'s; the ranks start at the file
    ``go``). Gates: every variant's step made exactly SYNC_LAYERS flash
    launches a rank, all on the tensor cores; sc / mc / promc parameters
    bit for bit naive's on each rank; each variant's parameters (and each
    forced codec's synced gradient) the same bits on both ranks (by
    ``bit_fingerprint``); promc bf16 within SYNC_COMPRESSED_MAX_ABS of
    naive (the reference's limit); each forced codec's synced gradient
    within its SYNC_FORCED limit of the whole batch's gradient on one rank,
    and rank 0's own gradient unsynced beyond every limit; every value
    finite. Printed: the rest (int8's distance, the 2-rank naive step against one rank's step of the
    whole batch, each variant's step and sync seconds, wire bytes and
    collectives a rank, each rank's peak device memory) and
    ``simulate_sync`` on DCN for gemma3-1b at full depth. Returns the flash
    launches of the variant steps (both ranks)."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import grad_sync
    from repro_torch.models.model import build_model

    ctx, out_dir = ranks_started
    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"[sync] before the ranks: this process holds {torch.cuda.memory_allocated() / 1e9:.2f} "
          f"GB ({torch.cuda.memory_reserved() / 1e9:.2f} GB reserved); the card has "
          f"{free / 1e9:.2f} of {total / 1e9:.2f} GB free", flush=True)
    open(os.path.join(out_dir, "go"), "w").close()
    # the schedules on the reference's DCN for gemma3-1b at full depth (host
    # arithmetic, beside the ranks' run)
    tree = build_model(dataclasses.replace(get_config("gemma3-1b")), device="meta").param_tree()
    plan = grad_sync.build_sync_plan(tree)
    sims = {(alg, comp): grad_sync.simulate_sync(
        tree, algorithm=alg, compress_by_class=None if comp else grad_sync.NO_COMPRESSION).total_time
        for alg in ("sc", "mc", "promc") for comp in (False, True)}
    try:
        while not ctx.join():
            pass
    except Exception as exc:  # a rank's failure fails the phase
        raise SmokeFailure(f"grad sync: a rank failed: {exc}") from exc
    ranks = []
    for r in range(SYNC_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(out_dir)
    spawn_s = time.perf_counter() - t_start
    r0 = ranks[0]
    print(f"[sync] gemma3-1b full width cut to {SYNC_LAYERS} layers on {SYNC_RANKS} ranks "
          f"sharing {r0['device']} (backend {r0['backend']}), the global batch {SYNC_B} x "
          f"{SYNC_S} ({SYNC_B // SYNC_RANKS} rows a rank), TRAIN_OPT; ranks' setup "
          f"{', '.join(f'{r['setup_s']:.1f}' for r in ranks)}s, the phase {spawn_s:.1f}s (the ranks "
          f"started beside phase 21) | {smi}",
          flush=True)
    launches, bad = 0, []
    for name in SYNC_VARIANTS:
        rows = [r["variants"][name] for r in ranks]
        for r, v in enumerate(rows):
            if tuple(v["launches"]) != (SYNC_LAYERS, SYNC_LAYERS):
                bad.append(f"{name} rank {r}: launches {v['launches']}")
            if not (math.isfinite(v["loss"]) and math.isfinite(v["grad_norm"])):
                bad.append(f"{name} rank {r}: loss {v['loss']}, grad norm {v['grad_norm']}")
            launches += v["launches"][0]
        if any(v["fingerprint"] != rows[0]["fingerprint"] for v in rows):
            bad.append(f"{name}: the ranks' parameters differ")
        if name in ("sc", "mc", "promc") and not all(v["same_as_naive"] for v in rows):
            bad.append(f"{name}: parameters differ from naive's")
        if name == "promc_bf16" and not rows[0]["max_abs_from_naive"] <= SYNC_COMPRESSED_MAX_ABS:
            bad.append(f"promc bf16: {rows[0]['max_abs_from_naive']:.3g} from naive")
        v = rows[0]
        print(f"[sync] {name}: loss {v['loss']:.6f}, grad norm {v['grad_norm']:.6g}; step "
              f"{', '.join(f'{x['step_s'] * 1e3:.1f}' for x in rows)} ms, of it the sync "
              f"{', '.join(f'{x['sync_s'] * 1e3:.1f}' for x in rows)} ms (rank 0, 1); "
              f"{v['collectives']} collectives, at most {v['max_outstanding']} outstanding; "
              f"wire bytes a rank {v['wire_bytes']} ({sum(v['wire_bytes'].values()) / 1e9:.4f} "
              f"GB); parameters bit for bit naive's: {v['same_as_naive']}, max |difference| "
              f"{v['max_abs_from_naive']:.3g}; ranks bit for bit: "
              f"{all(x['fingerprint'] == v['fingerprint'] for x in rows)}", flush=True)
    for codec in SYNC_FORCED:
        rows = [r["forced"][codec] for r in ranks]
        v = rows[0]
        if any(x["fingerprint"] != v["fingerprint"] for x in rows):
            bad.append(f"forced {codec}: the ranks' synced gradients differ")
        if not all(x["finite"] for x in rows):
            bad.append(f"forced {codec}: non-finite synced gradients")
        if not v["normwise_from_whole"] <= SYNC_FORCED[codec]:
            bad.append(f"forced {codec}: {v['normwise_from_whole']:.3g} normwise from the whole "
                       f"batch's gradient, over {SYNC_FORCED[codec]:.3g}")
        print(f"[sync] promc plan with {codec} on every class, the first gradient: sync "
              f"{', '.join(f'{x['sync_s'] * 1e3:.1f}' for x in rows)} ms, {v['collectives']} "
              f"collectives, wire bytes a rank {v['wire_bytes']} "
              f"({sum(v['wire_bytes'].values()) / 1e9:.4f} GB); against the whole batch's "
              f"gradient on one rank normwise {v['normwise_from_whole']:.3g} (limit "
              f"{SYNC_FORCED[codec]:.3g}), max |difference| "
              f"{v['max_abs_from_whole']:.3g}; ranks bit for bit: "
              f"{all(x['fingerprint'] == v['fingerprint'] for x in rows)}", flush=True)
    local, local_max = r0["local_from_whole"]
    if not local > max(SYNC_FORCED.values()):
        bad.append(f"rank 0's gradient unsynced is {local:.3g} normwise from the whole batch's: "
                   f"the forced codecs' limits would not tell a sync that did nothing")
    print(f"[sync] the control, rank 0's gradient unsynced: normwise {local:.3g} from the whole "
          f"batch's gradient, max |difference| {local_max:.3g}", flush=True)
    one = r0["one_rank"]
    print(f"[sync] one rank, the whole batch, the same start: loss {one['loss']:.6f} (2-rank "
          f"naive {r0['variants']['naive']['loss']:.6f}), step {one['step_s'] * 1e3:.1f} ms, "
          f"{one['launches']} flash launches; the 2-rank naive step's parameter change against "
          f"it normwise {one['change_normwise']:.3g}", flush=True)
    print(f"[sync] peak device memory a rank (the variant steps) "
          f"{', '.join(f'{r['peak_bytes'] / 1e9:.2f}' for r in ranks)} GB; the ranks' whole "
          f"runs {', '.join(f'{r['seconds']:.1f}' for r in ranks)}s", flush=True)
    print(f"[sync] {plan.summary()}".replace("\n", " |"), flush=True)
    print("[sync] simulate_sync on DCN, gemma3-1b full depth (s): " + ", ".join(
        f"{alg}{' compressed' if comp else ''} {t:.6f}" for (alg, comp), t in sims.items()),
        flush=True)
    fail_if(bool(bad), "grad sync: " + "; ".join(bad))
    torch.cuda.empty_cache()
    return launches


#: step caps of phase 3's loop-kernel checks on the live default-grid state
ROUND_CHECK_STEPS = (1, 16, 256, 2048)
#: group steps of the coupled loop kernel's timed launch on the whole
#: tenant matrix: its plain version there takes some 30 ms a step on the card
COUPLED_TIMING_STEPS = 64
#: comparators of the smallest sorting networks of 0..8 keys
SORT_COMPARATORS = (0, 0, 1, 3, 5, 9, 12, 16, 19)


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


def full_chunks():
    """The full grid's execution chunks as the runner cuts them: the 1,024
    cheapest rows by the plan's cost proxy (they hold the time-varying
    steppy-backbone rows), then the other 92 (they hold the longest rows,
    lossy-transatlantic|uniform_huge|untuned, 14,834 steps)."""
    from repro_torch.eval.fabric.bucketing import chunk_spans
    from repro_torch.eval.fabric.plan import build_plan
    from repro_torch.eval.runner import CHUNK_SIZE
    from repro_torch.eval.scenarios import full_matrix

    full = full_matrix()
    costs = build_plan(full).cost_proxy()
    order = sorted(range(len(full)), key=lambda i: costs[i])
    return [[full[i] for i in order[lo:hi]] for lo, hi in chunk_spans(len(full), CHUNK_SIZE)]


def sm_clock_mhz():
    """The card's SM clock and its maximum (MHz), as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return tuple(float(x) for x in out.stdout.strip().splitlines()[0].split(","))


def sampled_sm_clock(fn, n):
    """Run ``fn`` ``n`` times (then synchronize) while a thread samples the
    SM clock through nvidia-smi; returns (the highest sample, the maximum
    clock)."""
    import threading

    import torch

    samples, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            samples.append(sm_clock_mhz())

    th = threading.Thread(target=poll)
    th.start()
    try:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    finally:
        stop.set()
        th.join()
    samples.append(sm_clock_mhz())
    return max(x for x, _ in samples), samples[-1][1]


def probe_split(fs, cases):
    """Phase 3, the loop kernel's step split by phase: on each ``(label,
    operands, cap)`` case the probe build (fs.fused_rounds_probe) runs on
    a copy beside the unprobed kernel on another, and its results must
    equal the unprobed kernel's bit for bit; then, for the row of most
    steps, its cycles a step by phase (fs.PROBE_PHASES), beside the SM
    clock nvidia-smi samples while the probe runs and the clock its cycles
    and the launch's device time give. Returns {label: row}."""
    import torch

    out = {}
    for label, s0, cap in cases:
        want = {k: v.clone() for k, v in s0.items()}
        got = {k: v.clone() for k, v in s0.items()}
        fs.fused_rounds(want, cap)
        cycles = fs.fused_rounds_probe(got, cap)
        torch.cuda.synchronize()
        identical(got, list(want.values()), f"fused_rounds_probe {label}")
        steps = want["steps"]
        r = int(torch.argmax(steps))
        n = int(steps[r])
        per = (cycles[r].double() / max(n, 1)).tolist()
        total = sum(per)
        ms = device_ms(lambda: fs.fused_rounds_probe({k: v.clone() for k, v in s0.items()}, cap),
                       3, "fused_rounds_kernel")
        mhz, max_mhz = sampled_sm_clock(
            lambda: fs.fused_rounds_probe({k: v.clone() for k, v in s0.items()}, cap), 5)
        eff = int(cycles[r].sum()) / (ms * 1e3) if ms > 0 else float("nan")
        row = {"steps": n, "cycles_a_step": dict(zip(fs.PROBE_PHASES, per)),
               "sm_mhz": mhz, "max_mhz": max_mhz, "launch_ms": ms, "cycles_per_us": eff}
        out[label] = row
        split = ", ".join(f"{k} {v:.0f}" for k, v in row["cycles_a_step"].items())
        print(f"[probe] fused_rounds {label}: longest row {r} ({n} steps): {total:.0f} cycles a "
              f"step = {split} | probe launch {ms:.4f} ms, {eff:.0f} cycles/us from its cycles; "
              f"nvidia-smi SM clock {mhz:.0f} MHz sampled (max {max_mhz:.0f}) -> "
              f"{total / mhz:.3f} us a step at the sampled clock; bit for bit the unprobed "
              "kernel", flush=True)
    return out


def coupled_probe_split(fs, tenant_state, cap):
    """Phase 3, the coupled loop kernel's group step split by phase: the
    probe build (fs.fused_rounds_coupled_probe) on a copy of the live tenant
    matrix at ``cap`` group steps beside the unprobed kernel on another, its
    results and sweeps bit for bit the unprobed kernel's; then, for the
    longest group (the block of most group steps), SM cycles a group step by
    phase (fs.COUPLED_PROBE_PHASES): the slowest member's and the members'
    mean, the waits at the block's barriers included, beside the SM clock
    nvidia-smi samples while the probe runs. As a yardstick only, the same
    rows through the uncoupled probe (fs.fused_rounds_probe), each on its
    own pool and its own SM's share: cycles a step by phase (the members'
    mean and the slowest member's), what a member's own step costs when it
    shares no barrier. Returns the split's row."""
    import torch

    s0, fab = tenant_state
    want = {k: v.clone() for k, v in s0.items()}
    got = {k: v.clone() for k, v in s0.items()}
    fs.fused_rounds_coupled(want, fab, cap)
    want_counts = [fs.fused_rounds_coupled.sweeps.clone(),
                   fs.fused_rounds_coupled.solve_reuses.clone()]
    before = fs.fused_rounds_coupled_probe.launches
    cycles = fs.fused_rounds_coupled_probe(got, fab, cap)
    torch.cuda.synchronize()
    fail_if(fs.fused_rounds_coupled_probe.launches != before + 1,
            "fused_rounds_coupled_probe: no launch")
    label = f"fused_rounds_coupled_probe tenant matrix, cap {cap}"
    identical(got, list(want.values()), label)
    identical({"sweeps": fs.fused_rounds_coupled_probe.sweeps,
               "solve_reuses": fs.fused_rounds_coupled_probe.solve_reuses}, want_counts, label)
    rows_of = fab["layout"]["rows"].cpu()
    steps = want["steps"].cpu()
    gsteps = [int(steps[r[r >= 0]].max()) for r in rows_of]
    g = max(range(len(gsteps)), key=gsteps.__getitem__)
    members = rows_of[g][rows_of[g] >= 0]
    n = gsteps[g]
    per = cycles.cpu()[members].double() / n  # (members, phases)
    slowest, mean = per.max(dim=0).values.tolist(), per.mean(dim=0).tolist()
    total = float(per.sum(dim=1).mean())

    def clone_run(fn):
        return lambda: fn({k: v.clone() for k, v in s0.items()}, fab, cap)

    probe_ms = device_ms(clone_run(fs.fused_rounds_coupled_probe), 3,
                         "fused_rounds_coupled_kernel")
    kernel_ms = device_ms(clone_run(fs.fused_rounds_coupled), 3, "fused_rounds_coupled_kernel")
    mhz, max_mhz = sampled_sm_clock(clone_run(fs.fused_rounds_coupled_probe), 5)
    split = ", ".join(f"{k} {a:.0f} / {b:.0f}" for k, a, b in
                      zip(fs.COUPLED_PROBE_PHASES, slowest, mean))
    print(f"[probe] fused_rounds_coupled tenant matrix, cap {cap}: longest group {g} "
          f"({len(members)} members, {n} group steps): {total:.0f} cycles a group step = "
          f"{split} (phase: slowest member / members' mean) | probe launch {probe_ms:.4f} ms, "
          f"unprobed {kernel_ms:.4f} ms; nvidia-smi SM clock {mhz:.0f} MHz sampled (max "
          f"{max_mhz:.0f}) -> {total / mhz:.3f} us a group step at the sampled clock; bit for "
          "bit the unprobed kernel, sweeps and reused solves included", flush=True)

    # the yardstick: the same rows uncoupled, each on its own pool
    solo = {k: v.clone() for k, v in s0.items()}
    ycycles = fs.fused_rounds_probe(solo, cap).cpu()
    torch.cuda.synchronize()
    ysteps = solo["steps"].cpu()[members].double().clamp(min=1.0)
    yper = ycycles[members].double() / ysteps.unsqueeze(-1)
    ytotal = float(yper.sum(dim=1).mean())
    ysplit = ", ".join(f"{k} {a:.0f} / {b:.0f}" for k, a, b in zip(
        fs.PROBE_PHASES, yper.max(dim=0).values.tolist(), yper.mean(dim=0).tolist()))
    print(f"[probe] yardstick: the longest group's {len(members)} rows uncoupled "
          f"(fused_rounds_probe, each on its own pool; steps {ysteps.long().tolist()}): "
          f"{ytotal:.0f} cycles a step (members' mean) = {ysplit} (phase: slowest member / "
          f"members' mean); {ytotal / mhz:.3f} us a step at the sampled clock", flush=True)
    return {
        "entry": "fused_rounds_coupled_probe_f64", "group": g, "members": len(members),
        "group_steps": n, "cycles_a_group_step": total,
        "slowest_member": dict(zip(fs.COUPLED_PROBE_PHASES, slowest)),
        "members_mean": dict(zip(fs.COUPLED_PROBE_PHASES, mean)),
        "yardstick_cycles_a_step": ytotal,
        "yardstick_mean": dict(zip(fs.PROBE_PHASES, yper.mean(dim=0).tolist())),
        "sm_mhz": mhz, "probe_ms": probe_ms, "kernel_ms": kernel_ms,
    }


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
        "custom": out["stop"] == tr.STOP_CUSTOM,
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


#: custom class -> the built-in algorithm whose chunks it runs on (phase
#: 3's mixed state and phase 5e)
CUSTOM_BASES = {"NoOverrideSC": "sc", "NoOverrideMC": "mc", "NoOverrideProMC": "promc",
                "Mover": "mc", "Closer": "mc"}
#: phase 5e's limit on every row against the event leg and on a no-override
#: row against its built-in twin
CUSTOM_RTOL = 1e-9


def custom_classes():
    """The custom scheduler classes of phases 3 and 5e: a subclass of each
    built-in class with no method of its own (a custom row all the same,
    whose callbacks run on the host), a mover and a closer."""
    from repro_torch.core import schedulers as sch

    class NoOverrideSC(sch.SingleChunkScheduler):
        pass

    class NoOverrideMC(sch.MultiChunkScheduler):
        pass

    class NoOverrideProMC(sch.ProActiveMultiChunkScheduler):
        pass

    class Mover(sch.MultiChunkScheduler):
        """Each tick, one channel from the live chunk with the least ETA
        (holding two or more) to the one with the most."""

        name = "Mover"

        def on_tick(self, view):
            live = [v for v in view if not v.done and v.bytes_remaining > 0 and v.n_channels > 0]
            src = min((v for v in live if v.n_channels > 1), key=lambda v: v.eta, default=None)
            dst = max(live, key=lambda v: v.eta, default=None)
            if src is None or dst is None or src.index == dst.index:
                return []
            return [sch.Move(src=src.index, dst=dst.index, n=1)]

    class Closer(sch.MultiChunkScheduler):
        """On each completion, first one busy channel of the live chunk
        with the most channels closes (a resume push), then MC's
        redistribution."""

        name = "Closer"

        def on_chunk_complete(self, view, chunk):
            others = [v for v in view if v.index != chunk and not v.done and v.n_channels > 1]
            acts = []
            if others:
                acts.append(sch.Close(chunk=max(others, key=lambda v: v.n_channels).index, n=1))
            return acts + super().on_chunk_complete(view, chunk)

    return {c.__name__: c for c in (NoOverrideSC, NoOverrideMC, NoOverrideProMC, Mover, Closer)}


def custom_batch():
    """``(sims, names, twins)``: the smoke grid's Simulations, every other
    row's scheduler swapped for a custom class in turn (on the chunks of
    its base algorithm), then the no-override rows' built-in twins
    (``twins``: custom row -> twin row)."""
    import dataclasses

    from repro_torch.core.simulator import Simulation
    from repro_torch.eval.scenarios import build_simulation, smoke_matrix

    classes = custom_classes()
    cycle = tuple(CUSTOM_BASES)
    sims, names, twin_of = [], [], []
    for i, sc in enumerate(smoke_matrix()):
        if i % 2 == 0:
            sims.append(build_simulation(sc))
            names.append(sc.name)
            continue
        cname = cycle[(i // 2) % len(cycle)]
        base = dataclasses.replace(sc, algorithm=CUSTOM_BASES[cname])
        ref = build_simulation(base)
        new = classes[cname](ref.scheduler.chunks, ref.network, base.max_cc)
        sims.append(Simulation(new.chunks, ref.network, new, tick_period=ref.tick_period))
        names.append(f"{sc.name}:{cname}")
        if cname.startswith("NoOverride"):
            twin_of.append((len(sims) - 1, base))
    twins = {}
    for row, base in twin_of:
        twins[row] = len(sims)
        sims.append(build_simulation(base))
        names.append(base.name)
    return sims, names, twins


def live_custom_state(sweeps):
    """The loop kernel's operands (cloned) of the mixed custom batch on the
    card, ``sweeps`` split sweeps into its run (its custom rows' callbacks
    run on the host there)."""
    from repro_torch.eval.fabric.driver import TorchFabricSimulation
    from repro_torch.eval.fabric.plan import from_simulations

    sims, names, _ = custom_batch()
    drv = TorchFabricSimulation(from_simulations(sims, names), device="cuda", fused_step="none")
    drv.start()
    for _ in range(sweeps):
        drv.step()
    return {k: v.clone() for k, v in drv.round_operands(~drv.done).items()}


def loop_registers():
    """Phase 3: the loop kernels' registers and spills from ``ptxas -v``
    (this process's build). The loop kernel (fused_rounds_kernel, the
    unprobed build) and the coupled one must not spill at C <= 32 (one
    tile; wider rows spilled before this design too). Returns the
    instances that do, which fail phase 3 after its checks."""
    import re

    report = ptxas_of("fused_step", "fused_rounds")
    print(f"[build] loop kernels' registers and spills: {report}", flush=True)
    faults = []
    for entry in report.split("; "):
        m = re.match(r"(fused_rounds(?:_coupled)?_kernel<[^>]*>): (\d+) registers, (\d+) bytes "
                     r"spill stores", entry)
        if m is None:
            continue
        name, stores = m.group(1), int(m.group(3))
        one_tile = name.startswith("fused_rounds_coupled") or name.startswith(
            "fused_rounds_kernel<1,")
        if one_tile and "true" not in name and stores > 0:
            faults.append(f"{name} spills {stores} bytes at C <= 32")
    return faults


def sweeps_against_parent(fs, parent):
    """With --parent: the full grid on "rounds" and the full-grid oracle
    plane, each profiled in turns parent, new, new, parent: the loop
    kernel's device time over the run's launches, the launches and the wall
    seconds, beside the card's name and power limit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.eval import tune
    from repro_torch.eval.runner import run_matrix
    from repro_torch.eval.scenarios import full_matrix

    full = full_matrix()
    runs = (("full grid, rounds", lambda: run_matrix(full, device="cuda", fused_step="rounds")),
            ("full-grid oracle plane", lambda: tune.oracle_search(full, device="cuda")))
    smi = nvidia_smi_line()
    for label, run in runs:
        out = {"new": [], "parent": []}
        for who in ("parent", "new", "new", "parent"):
            ctx = parent_kernels(fs, parent) if who == "parent" else contextlib.nullcontext()
            with ctx:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            evs = [e for e in _device_events(prof) if "fused_rounds_kernel" in e.key]
            kern = sum(_self_device_us(e) for e in evs) / 1e6
            out[who].append((kern, sum(e.count for e in evs), wall))
        for who in ("new", "parent"):
            print(f"[parent] {label}, {who} loop kernel: " + "; ".join(
                f"{k:.4f} s in {n} launches, wall {w:.3f} s" for k, n, w in out[who])
                + f" | {smi}", flush=True)


#: the loop kernels' C entry points (the parent's take this tree's operand
#: array: it reads the operands before ``reuses``, the last)
LOOP_ENTRIES = ("fused_rounds_f64", "fused_rounds_coupled_f64")


def parent_source(parent_dir):
    """The parent checkout's loop-kernel source, copied with the headers
    beside it under build/parent_kernels as fused_step_parent.cu (so its
    build keeps a name of its own), or None without --parent."""
    import shutil

    if parent_dir is None:
        return None
    csrc = Path(parent_dir).resolve() / "src" / "repro_torch" / "eval" / "fabric" / "csrc"
    fail_if(not (csrc / "fused_step.cu").is_file(), f"--parent: no {csrc / 'fused_step.cu'}")
    dst = ROOT / "build" / "parent_kernels"
    dst.mkdir(parents=True, exist_ok=True)
    for f in csrc.glob("*.cuh"):
        shutil.copy(f, dst / f.name)
    shutil.copy(csrc / "fused_step.cu", dst / "fused_step_parent.cu")
    return dst / "fused_step_parent.cu"


@contextlib.contextmanager
def parent_kernels(fs, src):
    """Within the block the loop wrappers (fs.fused_rounds,
    fs.fused_rounds_coupled) launch the parent's kernels built from
    ``src``; their launch counts still count."""
    import ctypes

    from repro_torch import _cuda_build as _build

    lib = _build.load(src)
    own = fs._entry

    def entry(name):
        if name not in LOOP_ENTRIES:
            return own(name)
        fn = getattr(lib, name)
        fn.argtypes = fs._ARGTYPES[name]
        fn.restype = ctypes.c_int
        return fn

    fs._entry = entry
    try:
        yield
    finally:
        fs._entry = own


def same_as_parent(fs, parent, got, s0, label, run):
    """``run(operands)`` (a loop-kernel launch) on a copy of ``s0`` under
    the parent's kernels: every state and output but ``reuses`` (which the
    parent does not write) bit for bit ``got``'s. Nothing without a
    parent."""
    import torch

    if parent is None:
        return
    theirs = {k: v.clone() for k, v in s0.items()}
    with parent_kernels(fs, parent):
        run(theirs)
    torch.cuda.synchronize()
    names = [k for k in got if k != "reuses"]
    identical({k: got[k] for k in names}, [theirs[k] for k in names],
              f"{label}: against the parent's kernel")


def ab_ms(fs, parent, fn, n, kernel):
    """Device ms a launch of ``fn`` (the profiler, ``n`` calls a window)
    in turns parent, new, new, parent; without a parent, new twice.
    Returns (new ms list, parent ms list)."""
    new, old = [], []
    order = ("parent", "new", "new", "parent") if parent is not None else ("new", "new")
    for who in order:
        if who == "new":
            new.append(device_ms(fn, n, kernel))
        else:
            with parent_kernels(fs, parent):
                old.append(device_ms(fn, n, kernel))
    fail_if(min(new + old) <= 0.0, f"{kernel}: the profiler recorded no device time")
    return new, old


def ab_text(new, old, unit=1.0, fmt=".4f", label="ms") -> str:
    """``new`` and ``old`` (the parent's) times as text."""
    txt = f"new {', '.join(f'{x * unit:{fmt}}' for x in new)} {label}"
    if old:
        txt += (f", the parent {', '.join(f'{x * unit:{fmt}}' for x in old)} {label} (same "
                f"call; new / parent {min(new) / min(old):.3f})")
    return txt


def rounds_checks(fs, default_state, chunk_state, tail_state, parent=None):
    """Phase 3, the loop kernel: against the plain whole loop on the card,
    on the live default-grid state at each cap of ROUND_CHECK_STEPS, on
    states pushed to each stop (done, both capacity guards, max_time,
    stranded, cap) and with resume files and recording rows, on the
    default grid with 32 and 64 channel columns, on a live mixed batch
    with custom-scheduler rows (each stops at its next callback event), on
    the live full-grid chunk, and on both full-grid runner chunks at the
    main path's cap: bit for bit (rings, stacks, chunk_of and the level
    reuses included), and with ``parent`` (the parent's kernel source) bit
    for bit the parent's kernel too; timed on the runner chunks, with the
    plain version, the parent's kernel and the bound. Returns the timing
    rows by chunk ("chunk" is the kernels JSON line's)."""
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
    custom_state = live_custom_state(10)
    cases += [(f"live mixed batch with custom rows, cap {n}", custom_state, n,
               ("custom", "done") if n == 2048 else ("custom",)) for n in (16, 2048)]
    cases.append(("live full-grid chunk, cap 256", chunk_state, 256, ("profile_step",)))
    seen, worst = {}, 0.0
    for label, s0, max_steps, must in cases:
        want = fs.fused_rounds_plain(s0, max_steps)
        got = {k: v.clone() for k, v in s0.items()}
        before = fs.fused_rounds.launches
        fs.fused_rounds(got, max_steps)
        torch.cuda.synchronize()
        fail_if(fs.fused_rounds.launches != before + 1, f"fused_rounds {label}: no launch")
        worst = max(worst, identical({k: got[k] for k in want}, list(want.values()),
                                     f"fused_rounds {label}"))
        same_as_parent(fs, parent, got, s0, f"fused_rounds {label}",
                       lambda x: fs.fused_rounds(x, max_steps))
        ev = round_events(s0, want)
        for k, n in ev.items():
            seen[k] = seen.get(k, 0) + n
        missing = [m for m in must if ev[m] == 0]
        fail_if(bool(missing), f"fused_rounds {label}: no row met {missing}")
        print(f"[kernels] fused_rounds {label}: S={s0['act'].shape[0]} C={s0['busy'].shape[1]} "
              f"K={s0['qptr'].shape[1]} B={s0['prof_t'].shape[1]} P={s0['prepend_sizes'].shape[2]} "
              f"T={s0['tl_t'].shape[1]}; {int(want['steps'].sum())} row steps (longest "
              f"{int(want['steps'].max())}), {int(want['reuses'].sum())} level reuses; rows by "
              f"stop and event {ev}; bit for bit the plain version, the reuses its count"
              + ("" if parent is None else " and the parent's kernel"), flush=True)
    missing = [k for k, n in seen.items() if n == 0]
    fail_if(bool(missing), f"fused_rounds: no check met {missing}")

    # timing on the full-grid chunks at the main path's cap
    rows = {label: rounds_timing(fs, s0, label, worst, parent)
            for label, s0 in (("chunk", chunk_state), ("chunk92", tail_state))}
    return rows


def rounds_timing(fs, s0, label, worst, parent=None):
    """The loop kernel on the operands ``s0`` at the main path's cap:
    against its plain version (and the parent's kernel), timed (device time
    a launch and a step of the longest row, new against the parent in one
    call, the plain version's time, the bound). Returns the timing row."""
    import torch

    cap = fs.ROUND_CAP
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fs.fused_rounds_plain(s0, cap)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = {k: v.clone() for k, v in s0.items()}
    fs.fused_rounds(got, cap)
    torch.cuda.synchronize()
    err = identical({k: got[k] for k in want}, list(want.values()),
                    f"fused_rounds {label}, cap {cap}")
    same_as_parent(fs, parent, got, s0, f"fused_rounds {label}, cap {cap}",
                   lambda x: fs.fused_rounds(x, cap))
    rel = max(rel_err(got[k], want[k]) for k in want if want[k].dtype == torch.float64)
    steps = int(want["steps"].sum())
    reuses = int(want["reuses"].sum())
    longest = int(want["steps"].max())
    S, C = s0["busy"].shape
    fed = int((want["qptr"] - s0["qptr"]).sum())
    ev = round_events(s0, want)
    # each operand read once, the state and outputs written once, each fed
    # file size read once (not the whole buffer); 2 flops (min, add) a
    # channel a halving, 80 halvings a level descent, one descent a row step
    # but those that reuse the last step's level (the inputs need no other)
    nbytes = sum(v.numel() * v.element_size() for k, v in s0.items() if k != "qsizes")
    nbytes += sum(v.numel() * v.element_size() for v in want.values()) + 8 * fed
    ops = 2 * 80 * C * (steps - reuses)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP64_FLOPS * 1e3
    new, old = ab_ms(fs, parent, lambda: fs.fused_rounds({k: v.clone() for k, v in s0.items()},
                                                         cap), 5, "fused_rounds_kernel")
    ms = min(new)
    row = {
        "max_abs_err": max(worst, err), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "row_steps": steps, "longest": longest, "level_reuses": reuses,
        "parent_ms": min(old) if old else None,
    }
    print(f"[kernels] fused_rounds full-grid {label} S={S} C={C} cap {cap}: {steps} row steps, "
          f"longest row {longest}, {reuses} level reuses ({steps - reuses} descents); rows by "
          f"stop and event {ev}; against the plain version: worst relative {rel:.3g}, |error| "
          f"{err:.3g}, bool / int64 equal | device {ab_text(new, old)} a launch; "
          f"{ab_text([x / longest for x in new], [x / longest for x in old], 1e3, '.3f', 'us')} "
          f"a step of the longest row | plain {plain_ms:.1f} ms | bound "
          f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}: {nbytes / 1e6:.2f} MB, "
          f"{ops / 1e9:.3f} GFLOP)", flush=True)
    return row


def live_coupled_state(scenarios, sweeps):
    """The coupled loop kernel's operands (cloned) and fabric of a driver
    on the card, ``sweeps`` split sweeps into its run."""
    from repro_torch.eval.fabric.driver import TorchFabricSimulation
    from repro_torch.eval.fabric.plan import build_plan

    drv = TorchFabricSimulation(build_plan(scenarios), device="cuda", fused_step="none")
    drv.start()
    for _ in range(sweeps):
        drv.step()
    ops = {k: v.clone() for k, v in drv.round_operands(~drv.done).items()}
    return ops, drv._fab


def identical(outs, refs, label):
    """Hold kernel outputs to the plain version's bit for bit (NaN equal
    to NaN); returns 0.0, the max abs error."""
    import torch

    for (name, o), r in zip(outs.items(), refs):
        fail_if(o.shape != r.shape or o.dtype != r.dtype, f"{label}: {name} shape/dtype")
        same = (o == r) | (torch.isnan(o) & torch.isnan(r)) if o.is_floating_point() else o == r
        fail_if(not bool(same.all()), f"{label}: {name} differs from the plain version "
                f"(max abs error {abs_err(o, r) if o.is_floating_point() else 'int'})")
    return 0.0


def coupled_against_plain(fs, s0, fab, max_steps, label):
    """The coupled loop kernel on a copy of ``s0`` against its plain version
    (the host's wall time of which is timed), bit for bit, its level reuses
    and its reused solves (fs.fused_rounds_coupled.solve_reuses) the plain
    version's counts. Returns (the plain results, the kernel's operands,
    the plain version's ms)."""
    import torch

    counts = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fs.fused_rounds_coupled_plain(s0, fab, max_steps, counts=counts)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = {k: v.clone() for k, v in s0.items()}
    before = fs.fused_rounds_coupled.launches
    fs.fused_rounds_coupled(got, fab, max_steps)
    torch.cuda.synchronize()
    fail_if(fs.fused_rounds_coupled.launches != before + 1,
            f"fused_rounds_coupled {label}: no launch")
    identical({k: got[k] for k in want}, list(want.values()), f"fused_rounds_coupled {label}")
    identical({"solve_reuses": fs.fused_rounds_coupled.solve_reuses}, [counts["solve_reuses"]],
              f"fused_rounds_coupled {label}: reused solves")
    return want, got, plain_ms


def coupling_ops(sweeps, lay) -> int:
    """Floating-point operations of the group solves of a launch: each
    Jacobi sweep a block ran (the kernel's count, ``sweeps`` (G,)) solves
    each of its links over the link's m rows: a sort (the smallest sorting
    network's comparators, a min and a max each), m prefix sums and m
    candidate tests (5 operations each)."""
    sweeps = sweeps.cpu().numpy()
    mask = lay["mask"].cpu().numpy()
    ops = 0
    for g in range(mask.shape[0]):
        per_sweep = sum(2 * SORT_COMPARATORS[m] + 6 * m
                        for m in (bin(int(x)).count("1") for x in mask[g]))
        ops += int(sweeps[g]) * per_sweep
    return ops


def coupled_rounds_checks(fs, smoke_state, tenant_state, default_state, parent=None):
    """Phase 3, the coupled loop kernel: against its plain version on the
    card, bit for bit, on the live tenant-smoke state at each cap of
    ROUND_CHECK_STEPS, with members pushed to max_time and to the SC guard
    (their groups stop with them), on the default grid's uncoupled rows as
    groups of one (the uncoupled loop kernel's results), and on the live
    206-row tenant matrix at COUPLED_TIMING_STEPS group steps, timed there
    against the plain version and the bound, and at the main path's cap
    (the plain version untimed); the level reuses and reused solves the
    plain version's counts on every case; with ``parent`` also bit for bit
    the parent's kernel on every case, and timed against it at
    COUPLED_TIMING_STEPS and at the main path's cap. Returns the timing
    row."""
    import numpy as np
    import torch

    from repro_torch.eval.fabric import transition as tr

    ops0, fab0 = smoke_state
    cases = [(f"live tenant-smoke, cap {n}", ops0, fab0, n, ("done",) if n == 2048 else ())
             for n in ROUND_CHECK_STEPS]
    pushed_err = {k: v.clone() for k, v in ops0.items()}
    pushed_err["max_time"][::5] = pushed_err["t"][::5] + 1.0
    cases.append(("tenant-smoke, every fifth row pushed to max_time, cap 256", pushed_err,
                  fab0, 256, ("error", "group")))
    pushed_sc = {k: v.clone() for k, v in ops0.items()}
    sc = pushed_sc["kind"] == tr.KIND_SC
    pushed_sc["conc"][sc] = pushed_sc["busy"].shape[1] + 1
    cases.append(("tenant-smoke, SC waves wider than the channel axis, cap 2048", pushed_sc,
                  fab0, 2048, ("guard", "group")))
    worst = 0.0
    for label, s0, fab, max_steps, must in cases:
        want, got, _ = coupled_against_plain(fs, s0, fab, max_steps, label)
        n_sweeps = int(fs.fused_rounds_coupled.sweeps.sum())
        n_reused = int(fs.fused_rounds_coupled.solve_reuses.sum())
        same_as_parent(fs, parent, got, s0, f"fused_rounds_coupled {label}",
                       lambda x: fs.fused_rounds_coupled(x, fab, max_steps))
        ev = round_events(s0, want)
        ev["group"] = int(torch.sum(s0["act"] & (want["stop"] == tr.STOP_GROUP)))
        missing = [m for m in must if ev[m] == 0]
        fail_if(bool(missing), f"fused_rounds_coupled {label}: no row met {missing}")
        print(f"[kernels] fused_rounds_coupled {label}: S={s0['act'].shape[0]} "
              f"C={s0['busy'].shape[1]} K={s0['qptr'].shape[1]}; {int(want['steps'].sum())} row "
              f"steps (longest {int(want['steps'].max())}), {int(want['reuses'].sum())} level "
              f"reuses, {n_sweeps} Jacobi sweeps, {n_reused} reused solves; rows by stop and "
              f"event {ev}; bit for bit the plain version, the reuses its counts"
              + ("" if parent is None else " and the parent's kernel"), flush=True)

    # rows outside every group: groups of one, the uncoupled loop kernel's
    # results; their level reuses (the level memory's) the plain count
    S = default_state["act"].shape[0]
    solo = fs.fabric_operands(np.full(S, -1), np.zeros((0, S), dtype=bool), np.zeros(0), "cuda")
    label = f"the live default grid's {S} uncoupled rows (one block each), cap 256"
    b = coupled_against_plain(fs, default_state, solo, 256, label)[1]
    a = {k: v.clone() for k, v in default_state.items()}
    fs.fused_rounds(a, 256)
    torch.cuda.synchronize()
    names = [k for k in a if k != "reuses"]
    identical({k: b[k] for k in names}, [a[k] for k in names],
              "fused_rounds_coupled on uncoupled rows against fused_rounds")
    same_as_parent(fs, parent, b, default_state, f"fused_rounds_coupled {label}",
                   lambda x: fs.fused_rounds_coupled(x, solo, 256))
    print(f"[kernels] fused_rounds_coupled on {label}: bit for bit the plain version, the "
          f"reuses its count ({int(b['reuses'].sum())}; the uncoupled kernel's "
          f"{int(a['reuses'].sum())}), and the uncoupled loop kernel's results"
          + ("" if parent is None else " and the parent's kernel"), flush=True)

    # timing on the live tenant matrix
    s0, fab = tenant_state
    cap = COUPLED_TIMING_STEPS
    want, got, plain_ms = coupled_against_plain(fs, s0, fab, cap,
                                                f"tenant matrix, cap {cap}")
    sweeps = fs.fused_rounds_coupled.sweeps
    solve_reuses = int(fs.fused_rounds_coupled.solve_reuses.sum())
    same_as_parent(fs, parent, got, s0, f"fused_rounds_coupled tenant matrix, cap {cap}",
                   lambda x: fs.fused_rounds_coupled(x, fab, cap))
    steps = int(want["steps"].sum())
    reuses = int(want["reuses"].sum())
    longest = int(want["steps"].max())
    S, C = s0["busy"].shape
    fed = int((want["qptr"] - s0["qptr"]).sum())
    ev = round_events(s0, want)
    lay = fab["layout"]
    nbytes = sum(v.numel() * v.element_size() for k, v in s0.items() if k != "qsizes")
    nbytes += sum(v.numel() * v.element_size() for v in want.values()) + 8 * fed
    nbytes += sum(v.numel() * v.element_size() for v in lay.values())
    n_sweeps = int(sweeps.sum())
    rows_of = lay["rows"].cpu().numpy()
    steps_of = want["steps"].cpu().numpy()
    group_steps = sum(int(steps_of[r[r >= 0]].max()) for r in rows_of)
    ops = 2 * 80 * C * (steps - reuses) + coupling_ops(sweeps, lay)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP64_FLOPS * 1e3
    new, old = ab_ms(fs, parent, lambda: fs.fused_rounds_coupled(
        {k: v.clone() for k, v in s0.items()}, fab, cap), 5, "fused_rounds_coupled_kernel")
    ms = min(new)
    row = {
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "row_steps": steps, "longest": longest, "level_reuses": reuses,
        "groups": int(lay["rows"].shape[0]), "jacobi_sweeps": n_sweeps,
        "solve_reuses": solve_reuses, "group_steps": group_steps,
        "ptxas": ptxas_of("fused_step", "fused_rounds_coupled_kernel"),
        "parent_ms": min(old) if old else None,
    }
    print(f"[kernels] fused_rounds_coupled tenant matrix S={S} C={C} in {row['groups']} blocks, "
          f"cap {cap}: {steps} row steps, longest row {longest}, {reuses} level reuses, "
          f"{n_sweeps} Jacobi sweeps over {group_steps} group steps "
          f"({n_sweeps / max(group_steps, 1):.3f} a step; {solve_reuses} group steps reused the "
          f"last solve); rows by stop and event {ev}; "
          f"bit for bit the plain version | device {ab_text(new, old)} a launch; "
          f"{ab_text([x / longest for x in new], [x / longest for x in old], 1e3, '.3f', 'us')} "
          f"a group step of the longest | plain {plain_ms:.1f} ms | "
          f"bound {row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}: {nbytes / 1e6:.2f} MB, "
          f"{ops / 1e9:.4f} GFLOP) | ptxas {row['ptxas']}", flush=True)

    # the main path's cap (the plain version takes ~30 ms a group step here,
    # some 25 s in all: run once, not timed), and timed against the parent
    cap = fs.ROUND_CAP
    got = coupled_against_plain(fs, s0, fab, cap, f"tenant matrix, cap {cap}")[1]
    cap_sweeps = int(fs.fused_rounds_coupled.sweeps.sum())
    cap_reused = int(fs.fused_rounds_coupled.solve_reuses.sum())
    cap_group_steps = sum(int(got["steps"].cpu()[r[r >= 0]].max()) for r in rows_of)
    same_as_parent(fs, parent, got, s0, f"fused_rounds_coupled tenant matrix, cap {cap}",
                   lambda x: fs.fused_rounds_coupled(x, fab, cap))
    longest = int(got["steps"].max())
    new, old = ab_ms(fs, parent, lambda: fs.fused_rounds_coupled(
        {k: v.clone() for k, v in s0.items()}, fab, cap), 3, "fused_rounds_coupled_kernel")
    row["cap_ms"], row["cap_parent_ms"] = min(new), (min(old) if old else None)
    row.update(cap_group_steps=cap_group_steps, cap_jacobi_sweeps=cap_sweeps,
               cap_solve_reuses=cap_reused)
    print(f"[kernels] fused_rounds_coupled tenant matrix, cap {cap}: {int(got['steps'].sum())} "
          f"row steps, longest row {longest}, {int(got['reuses'].sum())} level reuses, "
          f"{cap_sweeps} Jacobi sweeps over {cap_group_steps} group steps, {cap_reused} reused "
          "solves; bit for bit the plain version, the reuses its counts"
          + ("" if parent is None else ", and the parent's kernel")
          + f" | device {ab_text(new, old)} a launch; "
          f"{ab_text([x / longest for x in new], [x / longest for x in old], 1e3, '.3f', 'us')} "
          "a group step of the longest", flush=True)
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
                "fused_rounds": fs.fused_rounds, "fused_rounds_coupled": fs.fused_rounds_coupled}
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
        compare_golden, load_golden, metrics_snapshot, run_matrix, wall_breakdown,
    )
    from repro_torch.eval.scenarios import default_matrix, full_matrix

    # ---- 4. the default grid on the three routes ----
    from repro_torch.eval.fabric.executor import executor_mode

    print(f"[default] phases 4-5 run on the runner's default executor: {executor_mode()}",
          flush=True)
    golden = load_golden(str(GOLDEN))
    scs = default_matrix()
    default_res = {}
    for route, must in (("rounds", "fused_rounds"), ("kernel", "fused_step"),
                        ("none", "waterfill")):
        gc0 = GC.seconds
        res, st, lc, secs = run_grid(scs, "cuda", route, wf, fs)
        gc_s = GC.seconds - gc0
        default_res[route] = res
        devs = compare_golden(golden, metrics_snapshot(scs, res))
        path = f"default_{route}"
        for k in lc:
            by_path[k][path] = lc[k]
        print(f"[default] fused_step={route}: {len(scs)} rows in {secs:.3f}s "
              f"({len(scs) / secs:.1f} rows/s), {st.sweeps} host rounds ({st.fused} fused, "
              f"{st.split} split), {st.steps} device row steps, {st.host_syncs} host syncs, "
              f"{st.host_transitions} host transitions, {st.post_row_replays} post-row "
              f"replays, {st.level_reuses} level reuses, launches {lc}, {len(devs)} golden "
              f"deviations; {wall_breakdown(st)}; gc {gc_s:.4f}s", flush=True)
        for d in devs[:10]:
            print(f"[default] DEVIATION {d.scenario} {d.field}: golden={d.golden} "
                  f"observed={d.observed}", flush=True)
        fail_if(bool(devs), f"default grid ({route}): {len(devs)} golden deviations")
        fail_if(lc[must] == 0, f"default grid ({route}): {must} never launched")
        fail_if(st.host_transitions != 0 or st.post_row_replays != 0,
                f"default grid ({route}): {st.host_transitions + st.post_row_replays} rows left a "
                "transition to the host")

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
    # the full grid has no shared fabric: the coupled kernel's path is phase 5d's
    fail_if(launches.pop("fused_rounds_coupled") != 0, "full grid: the coupled kernel launched")
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
              f"{stt.host_transitions} host transitions, {stt.post_row_replays} post-row "
              f"replays, {stt.level_reuses} level reuses", flush=True)
        fail_if(stt.host_transitions != 0 or stt.post_row_replays != 0,
                f"full grid ({rt}): {stt.host_transitions + stt.post_row_replays} rows left a "
                "transition to the host")
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

    # ---- 5c. the autotuner on the card ----
    tune_phase(full, res, fs, by_path, nvidia_smi_line())

    # ---- 5d. shared fabrics: the tenant matrix and the contention report ----
    launches["fused_rounds_coupled"] = tenant_phase(wf, fs, by_path, nvidia_smi_line())

    # ---- 5e. custom-scheduler rows and the timeline matrix ----
    t0 = time.perf_counter()
    custom_phase(wf, fs, by_path, nvidia_smi_line())
    print(f"[custom] phase 5e in {time.perf_counter() - t0:.1f}s", flush=True)

    # ---- 5f. the chunk executor: serial against async ----
    t0 = time.perf_counter()
    executor_phase(full, fs, nvidia_smi_line())
    print(f"[executor] phase 5f in {time.perf_counter() - t0:.1f}s", flush=True)

    # ---- 6. profiled sweeps ----
    from repro_torch.eval.scenarios import tenant_matrix

    def sweep(grid, route):
        return lambda st: run_matrix(grid, device="cuda", fused_step=route, stats=st)

    for label, run in (
        ("default grid, fused_step=rounds", sweep(scs, "rounds")),
        ("default grid, fused_step=kernel", sweep(scs, "kernel")),
        ("full grid, fused_step=rounds", sweep(full, "rounds")),
        ("tenant matrix, fused_step=rounds", sweep(tenant_matrix(), "rounds")),
    ):
        profile_sweep(label, run)
    return launches


def profile_sweep(label, run):
    """One sweep ``run(stats)`` under the profiler: wall, device busy and
    idle share (the device rows' time summed; rows on two streams at once
    count twice), device operations a host round, the sweep kernels' time,
    the plan ingest and the wall split."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.eval.fabric.stats import SweepStats
    from repro_torch.eval.runner import wall_breakdown

    stp = SweepStats()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gc0 = GC.seconds
        t0 = time.perf_counter()
        run(stp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gc_s = GC.seconds - gc0
    avgs = _device_events(prof)
    busy_s = sum(_self_device_us(e) for e in avgs) / 1e6
    kern = {k: (sum(_self_device_us(e) for e in avgs if k in e.key) / 1e6,
                sum(e.count for e in avgs if k in e.key))
            for k in ("fused_rounds_kernel", "fused_step_kernel",
                      "fused_rounds_coupled_kernel")}
    n_ops = sum(e.count for e in avgs)
    if busy_s > 0:
        print(f"[profile] {label}, under the profiler: wall {wall:.3f}s (plan ingest "
              f"{stp.ingest_s:.3f}s), "
              f"device busy {busy_s:.4f}s ({100 * busy_s / wall:.2f}%), idle "
              f"{100 * (1 - busy_s / wall):.2f}%, {n_ops} device operations in "
              f"{stp.sweeps} host rounds ({n_ops / stp.sweeps:.1f} a round); device "
              + ", ".join(f"{k} {t:.4f}s x{n}" + (f" ({t / n * 1e3:.4f} ms each)" if n else "")
                          for k, (t, n) in kern.items())
              + f", other {busy_s - sum(t for t, _ in kern.values()):.4f}s; "
              + wall_breakdown(stp) + f"; gc {gc_s:.4f}s", flush=True)
    else:
        print(f"[profile] {label}: wall {wall:.3f}s; device time not "
              f"measured (the profiler recorded no device activity); gc {gc_s:.4f}s",
              flush=True)


def fingerprint(out) -> list:
    """Every field of a run's results as exact text (``repr`` of a float
    is exact): a list of SimResults, or a search's TuneResult."""
    import dataclasses

    if isinstance(out, list):
        return [repr(dataclasses.asdict(r)) for r in out]
    return [repr((out.evals, out.equivalent_evals, out.tables, out.trace, out.entries))]


def executor_phase(full, fs, smi):
    """Phase 5f: the runner's chunk executor. Each workload runs under
    ``executor="serial"`` and ``"async"`` in turns (serial, async, async,
    serial): wall seconds (host clock, ending in a synchronize), the
    counters (equal in every run), the wall split, the loop kernels'
    launches, and every result field against the first run, bit for bit.
    Then the oracle plane profiled once under each mode."""
    import torch

    from repro_torch.eval import tune
    from repro_torch.eval.fabric.stats import SweepStats
    from repro_torch.eval.runner import run_matrix, run_simulations, wall_breakdown
    from repro_torch.eval.scenarios import tenant_matrix

    tenants = tenant_matrix()

    def custom(mode, st):
        sims, names, _ = custom_batch()
        return run_simulations(sims, names, device="cuda", executor=mode, stats=st)

    workloads = (
        ("full grid, rounds",
         lambda mode, st: run_matrix(full, device="cuda", executor=mode, stats=st)),
        ("full-grid oracle plane",
         lambda mode, st: tune.oracle_search(full, device="cuda", executor=mode, stats=st)),
        ("full-grid successive halving",
         lambda mode, st: tune.successive_halving(full, device="cuda", executor=mode, stats=st)),
        ("tenant matrix, rounds",
         lambda mode, st: run_matrix(tenants, device="cuda", executor=mode, stats=st)),
        ("custom batch (42 rows), rounds", custom),
    )
    for label, run in workloads:
        first, walls = None, {"serial": [], "async": []}
        for mode in ("serial", "async", "async", "serial"):
            st = SweepStats()
            fs.fused_rounds.launches = fs.fused_rounds_coupled.launches = 0
            torch.cuda.synchronize()
            gc0 = GC.seconds
            t0 = time.perf_counter()
            out = run(mode, st)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            gc_s = GC.seconds - gc0
            walls[mode].append(secs)
            got = (fingerprint(out), st.counters())
            if first is None:
                first = got
            same = got[0] == first[0]
            print(f"[executor] {label}, executor={mode}: {secs:.4f}s wall; counters "
                  f"{st.counters()}; loop launches "
                  f"{fs.fused_rounds.launches + fs.fused_rounds_coupled.launches}; "
                  f"{wall_breakdown(st)}; gc {gc_s:.4f}s; results bit for bit the first "
                  f"run's: {same} | {smi}",
                  flush=True)
            fail_if(not same, f"executor, {label}: {mode} results differ from the first run's")
            fail_if(got[1] != first[1], f"executor, {label}: {mode} counters differ")
            fail_if(st.host_transitions != 0, f"executor, {label}: a capacity guard fired")
        print(f"[executor] {label}: serial {min(walls['serial']):.4f}-{max(walls['serial']):.4f}s, "
              f"async {min(walls['async']):.4f}-{max(walls['async']):.4f}s | {smi}", flush=True)
    for mode in ("serial", "async"):
        profile_sweep(f"full-grid oracle plane, executor={mode}",
                      lambda st, mode=mode: tune.oracle_search(full, device="cuda", executor=mode,
                                                               stats=st))


def _ctx(key) -> str:
    return "/".join(str(part) for part in key)


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def sha_path_ties(result, golden_kept):
    """Contexts whose kept sets leave the golden's: at the first rung that
    differs, each (card-only, golden-only) survivor pair with its two
    scores on the card. Returns {context: (rung, pairs)}."""
    out = {}
    for key, rungs in result.trace.items():
        want = golden_kept[_ctx(key)]
        for r, rung in enumerate(rungs):
            if r < len(want) and rung["kept"] == want[r]:
                continue
            theirs = set(want[r]) if r < len(want) else set()
            mine = set(rung["kept"]) - theirs
            sc = rung["scores"]
            out[key] = (r, [(a, b, sc[a], sc.get(b, float("nan")))
                            for a in mine for b in theirs - set(rung["kept"])])
            break
        else:
            if len(rungs) != len(want):
                out[key] = (len(rungs), [])
    return out


def hill_path_ties(result, golden_walk):
    """Contexts whose climb leaves the golden's: at the first iteration
    whose next point differs, the card's and the golden's next points with
    their scores on the card. Returns {context: (iteration, pairs)}."""
    out = {}
    for key, its in result.trace.items():
        want = [tuple(p) for p in golden_walk[_ctx(key)]]
        mine = [it["current"] for it in its]
        for j in range(min(len(mine), len(want))):
            if mine[j] != want[j]:
                out[key] = (j, [])  # an earlier decision differed unseen
                break
            nxt_mine = mine[j + 1] if j + 1 < len(mine) else mine[j]
            nxt_want = want[j + 1] if j + 1 < len(want) else want[j]
            if nxt_mine != nxt_want:
                fr = its[j]["frontier"]
                out[key] = (j, [(nxt_mine, nxt_want, fr[nxt_mine], fr.get(nxt_want, float("nan")))])
                break
    return out


def tune_phase(full, full_res, fs, by_path, smi):
    """Phase 5c: the autotuner on the card. The full-grid oracle (16,675
    static rows on the loop kernel's route) against the reference's golden
    (each context's best within 1e-9 relative, its best parameters in the
    golden's tied set; the regret medians from phase 5's heuristic results
    within 1e-9), then successive halving and hill climbing on the smoke
    and full grids through the object ingest, each context within 0.95 of
    the card's oracle, evaluation counts and decision paths the golden's
    except at a near-tie (named, its two scores within 1e-9)."""
    import torch

    from repro_torch.bench.card_vs_cpu import plane_apart
    from repro_torch.eval import tune
    from repro_torch.eval.fabric.driver import SweepStats
    from repro_torch.eval.scenarios import smoke_matrix

    golden = json.loads(TUNE_GOLDEN.read_text())
    launches = {}

    def timed(label, search, scenarios):
        stats = SweepStats()
        fs.fused_rounds.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = search(scenarios, device="cuda", stats=stats)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = fs.fused_rounds.launches
        print(f"[tune] {label}: {len(result.tables)} contexts, {result.evals} rows "
              f"({result.equivalent_evals:.1f} at full fidelity) in {secs:.3f}s "
              f"({result.evals / secs:.1f} rows/s), plan ingest {stats.ingest_s:.3f}s, the "
              f"rest {secs - stats.ingest_s:.3f}s; {stats.sweeps} host rounds, {stats.steps} row "
              f"steps, {stats.host_syncs} host syncs, {stats.host_transitions} host "
              f"transitions, {n} loop launches | {smi}", flush=True)
        fail_if(stats.host_transitions != 0,
                f"{label}: {stats.host_transitions} rows left a transition to the host")
        fail_if(n == 0, f"{label}: the loop kernel was never launched")
        return result, n

    # ---- the full-grid oracle against the golden ----
    oracle, launches["tune_oracle"] = timed("oracle, full grid", tune.oracle_search, full)
    fail_if(oracle.evals != golden["oracle"]["evals"], f"oracle: {oracle.evals} evaluations")
    worst, off = 0.0, []
    for key, table in oracle.tables.items():
        want = golden["oracle"]["contexts"][_ctx(key)]
        worst = max(worst, _rel(table.best_throughput, want["best_throughput"]))
        if list(table.best_params) not in want["tied_best"]:
            off.append((_ctx(key), table.best_params, want["tied_best"]))
    fail_if(len(oracle.tables) != len(golden["oracle"]["contexts"]), "oracle: contexts")
    report = tune.regret_report(full, full_res, oracle)
    medians = {a: (agg["median"], golden["regret"][a]["median"])
               for a, agg in report.per_algorithm.items()}
    worst_median = max(_rel(a, b) for a, b in medians.values())
    print(f"[tune] oracle vs the reference's golden over {len(oracle.tables)} contexts: worst "
          f"relative difference of the best throughput {worst:.3g} (limit {TUNE_RTOL:g}); "
          f"{len(off)} contexts whose best parameters leave the golden's tied set: {off[:5]}",
          flush=True)
    print(f"[tune] regret medians (card, golden): "
          + ", ".join(f"{a} {m:.4f} / {g:.4f}" for a, (m, g) in sorted(medians.items()))
          + f"; worst relative difference {worst_median:.3g}", flush=True)
    print("[tune] " + report.format_table().replace("\n", "\n[tune] "), flush=True)
    fail_if(not worst <= TUNE_RTOL, f"oracle: {worst:.3g} from the golden")
    fail_if(bool(off), f"oracle: best parameters off the golden's tied set in {len(off)} contexts")
    fail_if(sorted(medians) != sorted(golden["regret"]), "regret: algorithms")
    fail_if(not worst_median <= TUNE_RTOL, f"regret medians: {worst_median:.3g} from the golden")

    # ---- successive halving and hill climbing, smoke and full grids ----
    smoke = smoke_matrix()
    smoke_oracle, _ = timed("oracle, smoke grid", tune.oracle_search, smoke)
    # the plain loop on the CPU sums the water level in the kernel's order:
    # the smoke plane's rows count the card's events, times bit for bit
    t0 = time.perf_counter()
    plane, apart = plane_apart()
    print(f"[tune] smoke oracle plane, {len(plane)} rows, card vs the port's CPU run "
          f"({time.perf_counter() - t0:.1f}s): {len(apart)} rows count other events or "
          f"times: {[(sc.name, a, b) for sc, a, b in apart[:8]]}", flush=True)
    fail_if(bool(apart), f"smoke oracle plane: {len(apart)} rows part from the CPU run")
    for grid, scs, orc in (("smoke", smoke, smoke_oracle), ("full", full, oracle)):
        best = {e.context: e.best_throughput for e in orc.entries}
        want = golden[grid]
        for name, search, ties_of, path, counts in (
            ("sha", tune.successive_halving, sha_path_ties, "kept", ("evals", "equivalent_evals")),
            ("hill", tune.hill_climb, hill_path_ties, "walk", ("evals",)),
        ):
            result, n = timed(f"{name}, {grid} grid", search, scs)
            launches[f"tune_{name}"] = launches.get(f"tune_{name}", 0) + n
            ratios = [e.best_throughput / best[e.context] for e in result.entries]
            ties = ties_of(result, want[name][path])
            got = {"evals": result.evals, "equivalent_evals": result.equivalent_evals}
            print(f"[tune] {name}, {grid} grid: " + ", ".join(
                f"{c} {got[c]:g} (golden {want[name][c]:g})" for c in counts)
                + f"; worst context {min(ratios):.5f} of the card's oracle (golden "
                f"{want[name]['worst_vs_oracle']:.5f} of the reference's; bar {TUNE_BAR}); "
                f"{len(ties)} contexts leave the golden's path: "
                + "; ".join(f"{_ctx(k)} at {j}: {p}" for k, (j, p) in ties.items()), flush=True)
            fail_if(min(ratios) < TUNE_BAR, f"{name}, {grid} grid: a context below {TUNE_BAR}")
            for key, (j, pairs) in ties.items():
                fail_if(not pairs or not all(_rel(x, y) <= TUNE_RTOL for _, _, x, y in pairs),
                        f"{name}, {grid} grid, {_ctx(key)}: the path leaves the golden's at "
                        f"{j} off a near-tie: {pairs}")
            if not ties:
                for c in counts:
                    fail_if(_rel(got[c], want[name][c]) > 1e-12,
                            f"{name}, {grid} grid: {c} {got[c]} against {want[name][c]}")
    by_path["fused_rounds"].update(launches)
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


#: the reference's contention reports on tenant matrices, written on the
#: CPU by tests/make_contention_golden.py (the command is in the file)
CONTENTION_GOLDEN = ROOT / "tests" / "golden" / "contention_tenant.json"
#: phase 5d's limit on the card's contention reports against the golden
CONTENTION_RTOL = 1e-9


def contention_against_golden(report, case, label):
    """The largest relative difference of a contention report's aggregate,
    per-algorithm and per-group numbers from the golden ``case``; the
    oracle's evaluation count and chosen settings must be the golden's."""
    a, b = report.to_json(), case["report"]
    fail_if(a["aggregate"]["oracle_evals"] != b["aggregate"]["oracle_evals"],
            f"{label}: {a['aggregate']['oracle_evals']} oracle evaluations, the golden's "
            f"{b['aggregate']['oracle_evals']}")
    pairs = [(a["aggregate"][k], b["aggregate"][k]) for k in b["aggregate"]]
    for algo, agg in b["per_algorithm"].items():
        pairs += [(a["per_algorithm"][algo][k], agg[k]) for k in agg]
    for x, y in zip(a["per_group"], b["per_group"]):
        fail_if(x["group"] != y["group"] or x["oracle_params"] != y["oracle_params"],
                f"{label}: group {y['group']}'s oracle settings differ from the golden's")
        pairs += [(x[k], y[k]) for k in ("heuristic_bps", "oracle_bps", "isolated_bps",
                                         "regret", "contention_factor")]
    return max(abs(x - y) / max(abs(y), 1e-300) for x, y in pairs)


def tenant_phase(wf, fs, by_path, smi):
    """Phase 5d: shared fabrics on the card. The 206-row tenant matrix on
    the "rounds" route (the coupled loop kernel; launch counts zeroed just
    before, read just after) and the "none" route, then each against the
    coupled event leg on the host and against each other; the difftest CLI
    on tenant-smoke; single tenants on generous links against their
    uncoupled twins; the contention report on tenant-smoke against the
    golden, and on the whole tenant matrix. Returns the coupled kernel's
    launches on its path."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.eval import difftest
    from repro_torch.eval.fabric.driver import SweepStats, TorchFabricSimulation
    from repro_torch.eval.fabric.plan import build_plan
    from repro_torch.eval.fabric.shared import SharedFabric
    from repro_torch.eval.runner import run_matrix
    from repro_torch.eval.scenarios import tenant_matrix
    from repro_torch.eval.tune import contention_report

    ten = tenant_matrix()
    res, launches = {}, {}
    for route in ("rounds", "none"):
        out, st, lc, secs = run_grid(ten, "cuda", route, wf, fs)
        res[route] = out
        for k in lc:
            by_path[k][f"tenant_{route}"] = lc[k]
        launches[route] = lc
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run_matrix(ten, device="cuda", fused_step=route)
            torch.cuda.synchronize()
        kern = sum(_self_device_us(e) for e in _device_events(prof)
                   if "fused_rounds_coupled_kernel" in e.key) / 1e3
        print(f"[tenant] fused_step={route}: {len(ten)} rows in {secs:.3f}s "
              f"({len(ten) / secs:.1f} rows/s; plan build {st.ingest_s:.3f}s), {st.sweeps} host "
              f"rounds, {st.steps} row steps, {st.host_syncs} host syncs, {st.host_transitions} "
              f"host transitions, launches {lc}; coupled loop kernel {kern:.3f} ms (a second "
              f"run, profiled) | {smi}", flush=True)
        fail_if(st.host_transitions != 0,
                f"tenant matrix ({route}): {st.host_transitions} rows left a transition to the host")
        if route == "rounds":
            # the launch's least time: the halvings of the descents its
            # inputs need (row steps less level reuses) and the Jacobi
            # sweeps its blocks ran (the profiled run's count)
            drv = TorchFabricSimulation(build_plan(ten), device="cuda")
            sweeps = fs.fused_rounds_coupled.sweeps
            descents = st.steps - st.level_reuses
            ops = 2 * 80 * drv.C * descents + coupling_ops(sweeps, drv._fab["layout"])
            print(f"[tenant] the coupled loop kernel's launch: {int(sweeps.sum())} Jacobi sweeps "
                  f"in {sweeps.numel()} blocks, "
                  f"{int(fs.fused_rounds_coupled.solve_reuses.sum())} group steps reused the last "
                  f"solve; bound {ops / FP64_FLOPS * 1e6:.3f} us "
                  f"(operations: {descents} descents ({st.steps} row steps less "
                  f"{st.level_reuses} level reuses) x 80 halvings x {drv.C} channels x 2 and "
                  f"the sweeps' solves, {ops / 1e9:.4f} GFLOP)", flush=True)
    fail_if(launches["rounds"]["fused_rounds_coupled"] == 0,
            "tenant matrix: the coupled loop kernel was never launched on its path")
    fail_if(launches["rounds"]["fused_rounds"] != 0,
            "tenant matrix: coupled rows reached the uncoupled loop kernel")

    t0 = time.perf_counter()
    event = run_matrix(ten, backend="event")
    secs = time.perf_counter() - t0
    print(f"[tenant] coupled event leg: {len(ten)} rows, {sum(r.n_events for r in event)} events "
          f"in {secs:.3f}s on the host", flush=True)
    for route, out in res.items():
        reports = difftest.pair_results(ten, event, out, "event", route)
        worst = max(r.rel_err for r in reports)
        differ = difftest.event_count_differences(ten, event, out)
        print(f"[tenant] route {route} vs the coupled event leg: worst relative throughput "
              f"error {worst:.3e} (limits {difftest.DEFAULT_RTOL:g} and {EVENT_ROUTE_TOL:g}); "
              f"{len(differ)} rows count other events (event, {route}): {differ[:20]}", flush=True)
        try:
            difftest.assert_agreement(reports)
        except AssertionError as exc:
            raise SmokeFailure(f"tenant matrix, route {route}: {exc}") from None
        fail_if(not worst <= EVENT_ROUTE_TOL,
                f"tenant matrix, route {route}: {worst:.3g} from the coupled event leg")
    agree = max(abs(a.throughput - b.throughput) / b.throughput
                for a, b in zip(res["rounds"], res["none"]))
    print(f"[tenant] rounds vs none over {len(ten)} rows: worst relative throughput difference "
          f"{agree:.3e} (limit {EVENT_ROUTE_TOL:g})", flush=True)
    fail_if(not agree <= EVENT_ROUTE_TOL, f"tenant matrix: the routes differ ({agree:.3g})")

    cmd = [sys.executable, "-m", "repro_torch.eval.difftest", "--matrix", "tenant-smoke",
           "--route", "all", "--expect-zero-replays"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=600)
    for line in out.stdout.splitlines():
        print(f"[difftest] {line}", flush=True)
    print(f"[difftest] {' '.join(cmd[1:])}: exit {out.returncode} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    fail_if(out.returncode != 0, f"the tenant difftest CLI failed: {out.stderr[-2000:]}")

    # single tenants on generous links against their uncoupled twins
    smoke = tenant_matrix(n_groups=6)
    picks = {}
    for sc in smoke:
        picks.setdefault(sc.algorithm, sc)
    twins = [dataclasses.replace(sc, shared_fabric=None) for sc in picks.values()]
    solos = [dataclasses.replace(sc, shared_fabric=SharedFabric(
        group=f"solo{i}", links=("bb",), capacity=(1e15,), tenant="t0"))
        for i, sc in enumerate(twins)]
    for route in ("rounds", "none"):
        a = run_matrix(twins, device="cuda", fused_step=route)
        b = run_matrix(solos, device="cuda", fused_step=route)
        for x, y, sc in zip(a, b, twins):
            fail_if((x.total_time, x.throughput, x.n_events, x.n_moves, x.per_chunk_bytes)
                    != (y.total_time, y.throughput, y.n_events, y.n_moves, y.per_chunk_bytes),
                    f"{sc.name} on a generous link ({route}) differs from its uncoupled twin")
        print(f"[tenant] single tenants on generous links ({', '.join(picks)}), route {route}: "
              "bit for bit their uncoupled twins", flush=True)

    golden = json.loads(CONTENTION_GOLDEN.read_text())["cases"]
    for case, matrix in (("tenant-smoke", smoke), ("full", ten)):
        st = SweepStats()
        t0 = time.perf_counter()
        report = contention_report(matrix, device="cuda", stats=st,
                                   n_candidates=golden.get(case, golden["tenant-smoke"])["n_candidates"])
        secs = time.perf_counter() - t0
        agg = report.aggregate
        line = (f"[contention] {case}: {len(matrix)} rows, {secs:.3f}s on the card "
                f"({st.sweeps} host rounds, {st.steps} row steps, {st.host_transitions} host "
                f"transitions, plan build {st.ingest_s:.3f}s); regret median "
                f"{agg['regret_median']!r}, mean {agg['regret_mean']!r}, min "
                f"{agg['regret_min']!r}, contention factor median "
                f"{agg['contention_factor_median']!r}, {agg['oracle_evals']} oracle evaluations; "
                f"by algorithm { {a: v['median'] for a, v in report.per_algorithm.items()} }")
        if case in golden:
            worst = contention_against_golden(report, golden[case], f"contention {case}")
            print(f"{line}; against the golden (the reference's NumPy run, "
                  f"{golden[case]['wall_s']:.1f}s on a CPU): worst relative {worst:.3e} "
                  f"(limit {CONTENTION_RTOL:g}) | {smi}", flush=True)
            fail_if(not worst <= CONTENTION_RTOL, f"contention {case}: {worst:.3g} from the golden")
        else:
            print(f"{line}; no golden (not gated) | {smi}", flush=True)
    return launches["rounds"]["fused_rounds_coupled"]


def custom_phase(wf, fs, by_path, smi):
    """Phase 5e: custom-scheduler rows on the card. The mixed batch
    (:func:`custom_batch`) through the object ingest on the "rounds",
    "kernel" and "none" routes, launch counts zeroed just before and read
    just after; each route's rows against the port's event leg and the
    no-override rows against their built-in twins; post-row replays, host
    rounds and wall seconds of each. Then the timeline matrix on "rounds"
    against the event leg's samples."""
    import copy

    import torch

    from repro_torch.eval import difftest
    from repro_torch.eval.fabric.driver import SweepStats, TorchFabricSimulation
    from repro_torch.eval.fabric.plan import from_simulations
    from repro_torch.eval.runner import run_matrix, run_simulations
    from repro_torch.eval.scenarios import timeline_matrix

    sims, names, twins = custom_batch()
    t0 = time.perf_counter()
    event = run_simulations(copy.deepcopy(sims), names, backend="event")
    print(f"[custom] {len(sims)} rows ({sum(1 for n in names if ':' in n)} custom, "
          f"{len(twins)} built-in twins); event leg {sum(r.n_events for r in event)} events in "
          f"{time.perf_counter() - t0:.3f}s on the host", flush=True)
    counters = {"waterfill": wf.waterfill_bisect, "fused_step": fs.fused_step,
                "fused_rounds": fs.fused_rounds, "fused_rounds_coupled": fs.fused_rounds_coupled}
    for route in ("rounds", "kernel", "none"):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drv = TorchFabricSimulation(from_simulations(sims, names), device="cuda",
                                    fused_step=route)
        res = drv.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        st = drv.stats
        lc = {k: c.launches for k, c in counters.items()}
        if route == "rounds":
            by_path["fused_rounds"]["custom"] = lc["fused_rounds"]
        reports = difftest.pair_results(names, event, res, "event", route)
        worst = max(r.rel_err for r in reports)
        differ = difftest.event_count_differences(names, event, res)
        twin = max(abs(res[r].throughput - res[t].throughput) / res[t].throughput
                   for r, t in twins.items())
        print(f"[custom] fused_step={route}: {len(sims)} rows in {secs:.3f}s, {st.sweeps} host "
              f"rounds, {st.post_row_replays} post-row replays, {st.host_transitions} host "
              f"transitions, {st.host_syncs} host syncs, {st.steps} row steps, launches {lc} | "
              f"{smi}", flush=True)
        print(f"[custom] fused_step={route} vs the event leg: worst relative throughput error "
              f"{worst:.3e} (limit {CUSTOM_RTOL:g}); no-override rows vs their twins "
              f"{twin:.3e}; {len(differ)} rows count other events (event, {route}): {differ}",
              flush=True)
        fail_if(not worst <= CUSTOM_RTOL, f"custom rows ({route}): {worst:.3g} from the event leg")
        fail_if(not twin <= CUSTOM_RTOL, f"custom rows ({route}): {twin:.3g} from the twins")
        for n, a, e in zip(names, res, event):
            fail_if((a.n_moves, a.total_bytes) != (e.n_moves, e.total_bytes),
                    f"custom rows ({route}) {n}: moves or bytes differ from the event leg")
        fail_if(st.host_transitions != 0, f"custom rows ({route}): a capacity guard fired")
        if route == "rounds":
            fail_if(lc["fused_rounds"] == 0, "custom rows: the loop kernel never launched")
            fail_if(st.post_row_replays == 0, "custom rows: the loop never stopped at a callback")
        else:
            fail_if(st.post_row_replays != 0, f"custom rows ({route}): post-row replays")

    # the timeline matrix: each ring against the event leg's samples
    scs = timeline_matrix()
    t0 = time.perf_counter()
    ev = run_matrix(scs, backend="event")
    event_s = time.perf_counter() - t0
    st = SweepStats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_matrix(scs, device="cuda", fused_step="rounds", stats=st)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    split = {}
    for sc, r, e in zip(scs, res, ev):
        tr, te = r.timeline, e.timeline
        fail_if(not tr or tr[0] != te[0], f"timeline {sc.name}: first sample differs")
        fail_if(abs(len(tr) - len(te)) > max(2, len(te) // 20),
                f"timeline {sc.name}: {len(tr)} samples, the event leg {len(te)}")
        fail_if(not all(abs(x - y) <= 1e-6 + 1e-9 * abs(y) for x, y in zip(tr[-1], te[-1])),
                f"timeline {sc.name}: last sample differs")
        unmatched = ordered_submatch(tr, te, sc.name, spare=max(0, r.n_events - e.n_events))
        if unmatched:
            split[sc.name] = unmatched
    print(f"[timeline] {len(scs)} recording rows on fused_step=rounds in {secs:.3f}s "
          f"({st.sweeps} host rounds; the event leg {event_s:.3f}s on the host), "
          f"{sum(len(r.timeline) for r in res)} ring samples, each matched in order to the "
          f"event leg's (rtol 1e-9, atol 1e-6); zero-dt samples of rows counting more events "
          f"left unmatched: {split}", flush=True)


def ordered_submatch(sub, full, name, rtol=1e-9, atol=1e-6, spare=0):
    """Every (t, rate) of ``sub`` matches a sample of ``full`` in order
    (tests/test_timeline_ring.py's rule); up to ``spare`` samples at a
    zero-dt boundary (the next sample's time) may go unmatched, where a
    route counts that many more events than the event leg. Returns them."""
    def close(a, b):
        return all(abs(x - y) <= atol + rtol * abs(y) for x, y in zip(a, b))

    i, unmatched = 0, []
    for j, s in enumerate(sub):
        k = i
        while k < len(full) and not close(s, full[k]):
            k += 1
        if k < len(full):
            i = k + 1
            continue
        zero_dt = j + 1 < len(sub) and abs(sub[j + 1][0] - s[0]) <= atol
        fail_if(not (zero_dt and len(unmatched) < spare),
                f"timeline {name}: ring sample {s} not found in order in the event timeline")
        unmatched.append(s)
    return unmatched


def main(argv) -> int:
    quick = "--quick" in argv
    parent_dir = argv[argv.index("--parent") + 1] if "--parent" in argv else None
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
    gc.callbacks.append(GC)

    def elapsed(phases):
        print(f"[time] phases {phases} done at {time.perf_counter() - t_start:.1f}s", flush=True)
    from repro_torch import _cuda_build as _build
    from repro_torch.eval.fabric.kernels import fused_step as fs
    from repro_torch.eval.fabric.kernels import waterfill_bisect as wf
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as wk
    from repro_torch.kernels.ref import flash_attention_ref, rglru_scan_ref, rwkv6_scan_ref
    from repro_torch.eval.scenarios import default_matrix, tenant_matrix

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
    parent = parent_source(parent_dir)
    sources = [wf.SOURCE, fs.SOURCE, wk.SOURCE, rg.SOURCE, fa.SOURCE, fa.SOURCE_SM90]
    _build.build(sources + ([parent] if parent is not None else []))
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
    spills = loop_registers()
    elapsed("2 (build)")

    # ---- 3. kernels against their plain versions ----
    rows = kernel_checks(wf, fs, None if quick else live_default_state())
    rows["rwkv6_scan"] = wkv_checks(wk, rwkv6_scan_ref)
    rows["rglru_scan"] = rglru_checks(rg, rglru_scan_ref)
    fa_rows = flash_checks(fa, flash_attention_ref)
    rows["flash_attention_sm90"] = fa_rows[fa.TENSOR_CORES]
    rows["flash_attention"] = fa_rows[fa.CUDA_CORES]
    grad_rows = grad_checks(fa, rg, wk)
    elapsed("3 (the model kernels' checks)")
    # the loop kernels' plain versions launch millions of small kernels on
    # the card (after them the profiler has kept as few as 5 of 20 WKV
    # launches); the profiled launch counts of the model kernels come first
    chunks = full_chunks()
    chunk_state = live_round_state(chunks[0], 8)
    tail_state = live_round_state(chunks[1], 8)
    default_state = live_round_state(default_matrix(), 20)
    rows["fused_rounds"] = rounds_checks(fs, default_state, chunk_state, tail_state, parent)
    probe_split(fs, [("92-row full-grid chunk, cap 2048", tail_state, fs.ROUND_CAP),
                     ("1024-row full-grid chunk, cap 2048", chunk_state, fs.ROUND_CAP)])
    del chunk_state, tail_state
    tenant_state = live_coupled_state(tenant_matrix(), 10)
    rows["fused_rounds_coupled"] = {"tenant": coupled_rounds_checks(
        fs, live_coupled_state(tenant_matrix(n_groups=6), 10), tenant_state, default_state,
        parent)}
    coupled_probe = coupled_probe_split(fs, tenant_state, fs.ROUND_CAP)
    del default_state, tenant_state
    fail_if(bool(spills), "; ".join(spills))
    elapsed("3 (the loop kernels' checks)")

    launches = {k: 0 for k in rows}
    by_path = {k: {} for k in rows}
    if not quick:
        launches.update(sweep_paths(wf, fs, by_path))
        if parent is not None:
            sweeps_against_parent(fs, parent)
        elapsed("4-6 (the sweeps)")

        # ---- 7. the serving path: rwkv6-3b at full width ----
        launches["rwkv6_scan"] = serve_full_width(wk)
        by_path["rwkv6_scan"]["serve"] = launches["rwkv6_scan"]

        # ---- 8. the card against the port's CPU run, 2 layers ----
        by_path["rwkv6_scan"]["card_vs_cpu"] = card_against_cpu(wk)
        elapsed("7-8 (rwkv6-3b)")

        # ---- 9. the hybrid serving path: recurrentgemma-9b at full width ----
        rg_runs, flash_runs = serve_hybrid(rg, wk, fa)
        by_path["rglru_scan"].update(rg_runs)
        by_path["flash_attention_sm90"].update(flash_runs)
        launches["rglru_scan"] = sum(by_path["rglru_scan"].values())

        # ---- 10. the card against the port's CPU run, one period ----
        by_path["rglru_scan"]["card_vs_cpu"], hybrid_check = hybrid_card_against_cpu(rg, fa)
        elapsed("9-10 (recurrentgemma-9b)")

        # ---- 11. the dense serving path: gemma3-1b at full width ----
        by_path["flash_attention_sm90"].update(serve_family(
            "dense", "gemma3-1b", DENSE_RUNS, fa, rg, wk, 999_812_736, 999_812_736))
        by_path["flash_attention_sm90"]["hybrid_card_vs_cpu"] = hybrid_check

        # ---- 12. the card against the port's CPU run, one period ----
        by_path["flash_attention_sm90"]["card_vs_cpu"] = dense_card_against_cpu(fa)
        elapsed("11-12 (gemma3-1b)")

        # ---- 13-18. the MoE, VLM and encoder-decoder families: each served
        # at full width, then held to the port's CPU run layer by layer ----
        for tag, arch, runs, check, n_params, n_active in (
            ("moe", "deepseek-moe-16b", MOE_RUNS, MOE_CHECK, 16_879_568_896, 2_830_747_648),
            ("vlm", "paligemma-3b", VLM_RUNS, VLM_CHECK, 2_508_662_784, 2_508_662_784),
            ("encdec", "whisper-base", ENCDEC_RUNS, ENCDEC_CHECK, 70_611_456, 70_611_456),
        ):
            by_path["flash_attention_sm90"].update(
                serve_family(tag, arch, runs, fa, rg, wk, n_params, n_active))
            by_path["flash_attention_sm90"][f"{tag}_card_vs_cpu"] = family_card_against_cpu(
                tag, arch, check, fa)
            elapsed(f"13-18 ({arch})")

        # ---- 19. training: gemma3-1b at full width and depth ----
        by_path["flash_attention_sm90"]["train"] = train_full_width(fa, rg, wk)

        # ---- 20. one train step, the card against the port's CPU run ----
        by_path["flash_attention_sm90"]["train_card_vs_cpu"] = train_card_against_cpu(fa, rg, wk)
        elapsed("19-20 (training)")

        # ---- 21. the fault-tolerant loop: a crash, a restore, a bit-exact resume ----
        # (phase 22's ranks start beside it)
        sync_ranks = start_sync_ranks()
        (by_path["flash_attention_sm90"]["train_loop"],
         by_path["flash_attention_sm90"]["train_loop_resumed"]) = train_resume_full_width(
            fa, rg, wk)
        elapsed("21 (the training loop)")

        # ---- 22. gradient sync over two ranks sharing the card ----
        by_path["flash_attention_sm90"]["grad_sync"] = grad_sync_phase(sync_ranks, smi)
        elapsed("22 (gradient sync)")
        # the main path's count: the serving and training runs, not the
        # card-against-CPU checks
        launches["flash_attention_sm90"] = sum(
            n for run, n in by_path["flash_attention_sm90"].items()
            if not run.endswith("card_vs_cpu"))
        # every model path attends in bf16 with D % 8 == 0: none reaches the
        # CUDA-core kernel
        launches["flash_attention"] = sum(by_path["flash_attention"].values())

    # ---- 23. summary lines ----
    kernels = []
    for name, src, replaces, pick, shape in (
        ("waterfill", "src/repro_torch/eval/fabric/csrc/waterfill.cu",
         "src/repro/eval/fabric/kernels/waterfill_pallas.py:40", JSON_SHAPE, "SCKQ"),
        ("fused_step", "src/repro_torch/eval/fabric/csrc/fused_step.cu",
         "src/repro/eval/fabric/kernels/fused_step_pallas.py:37", JSON_SHAPE, "SCKQ"),
        ("fused_rounds", "src/repro_torch/eval/fabric/csrc/fused_step.cu",
         "src/repro/eval/fabric/kernels/fused_step_pallas.py:37", "chunk", None),
        ("fused_rounds_coupled", "src/repro_torch/eval/fabric/csrc/fused_step.cu",
         "src/repro/eval/fabric/kernels/fused_step_pallas.py:37", "tenant", None),
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
        if name == "fused_rounds_coupled":
            kernels[-1]["shape"] = {"tenant_matrix_rows": 206, "groups": row["groups"],
                                    "max_steps": COUPLED_TIMING_STEPS,
                                    "row_steps": row["row_steps"],
                                    "longest_row_steps": row["longest"],
                                    "jacobi_sweeps": row["jacobi_sweeps"],
                                    "solve_reuses": row["solve_reuses"]}
            # the probe build: not on the path, its split of a group step
            kernels[-1]["probe"] = {k: coupled_probe[k] for k in (
                "entry", "group_steps", "cycles_a_group_step", "members_mean", "sm_mhz")}
        if name.startswith("flash_attention"):
            kernels[-1]["shape"].update(window=pick[7], dtype=pick[9])
        if name == "flash_attention_sm90":  # the other families' prefill shapes
            kernels[-1]["family_shapes"] = [
                {"BHKSTD": check[:6], "causal": check[6],
                 **{k: rows[name][check][k] for k in ("ms", "library_ms", "bound_ms", "bound_by")}}
                for check in FA_FAMILIES]
        if name == "rwkv6_scan":  # the model's call, (B, T, H, D) in place
            kernels[-1]["model_layout_call_ms"] = row["model_call_ms"]
        if name in grad_rows:  # the autograd Function's gradient against the plain version's
            kernels[-1]["gradient_checks"] = [
                {"shape": list(check), **{k: v for k, v in r.items()}}
                for check, r in grad_rows[name].items()]
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
