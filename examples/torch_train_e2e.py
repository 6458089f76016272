"""End-to-end training on the PyTorch port: a llama-family model trained on
the synthetic corpus with async checkpointing, crash-resume and metrics
logging, on one device or over N ranks whose gradients are synced by the
paper's scheduler (ProMC, per-class compression).

Full run (~100M params):
    PYTHONPATH=src python examples/torch_train_e2e.py --preset 100m --steps 300
Two ranks sharing the card (gloo; NCCL when each rank has a card):
    PYTHONPATH=src python examples/torch_train_e2e.py --preset 25m --ranks 2
Smallest, on the CPU:
    PYTHONPATH=src python examples/torch_train_e2e.py --preset 1m --steps 4 --device cpu --ranks 2

Runs on the card unless ``--device cpu`` is given. Each rank takes its
block of every global batch; rank 0 writes the checkpoints and the log.
"""
import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.distributed.pods import close_pods, init_pods
from repro_torch.models.model import build_model, count_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.train_step import StepConfig

PRESETS = {
    # name: (layers, d_model, heads, kv, d_ff, vocab, seq, batch)
    "100m": (12, 768, 12, 4, 2048, 32768, 512, 8),
    "25m": (8, 384, 6, 2, 1024, 16384, 256, 8),
    "5m": (4, 192, 4, 2, 512, 4096, 128, 8),
    "1m": (2, 64, 2, 1, 128, 1024, 32, 4),
}


def run(rank, args, store):
    L, d, h, kv, ff, v, seq, batch = PRESETS[args.preset]
    cfg = dataclasses.replace(
        get_config("llama3.2-3b"),
        name=f"llama-{args.preset}",
        num_layers=L, d_model=d, num_heads=h, num_kv_heads=kv,
        head_dim=d // h, d_ff=ff, vocab_size=v,
    )
    group, device, lead = None, args.device, True
    if args.ranks > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.ranks))
        pods = init_pods(rank, args.ranks, init_method=f"file://{store}", device=args.device)
        group, device, lead = pods.group, pods.device, rank == 0
    try:
        model = build_model(cfg, device=device)
        if lead:
            print(f"model {cfg.name}: {count_params(cfg)/1e6:.1f}M params, seq={seq}, "
                  f"global batch={batch}, ranks={args.ranks}, device={model.device}")
        data = SyntheticLM(cfg, DataConfig(global_batch=batch, seq_len=seq))
        step_cfg = StepConfig(optimizer=AdamWConfig(
            lr=6e-4, warmup_steps=min(40, args.steps), total_steps=args.steps,
            weight_decay=0.05))
        history = []

        def log(step, m):
            history.append(m)
            if lead:
                print(f"step {step:5d}  loss {m['loss']:.4f}  lr {m['lr']:.2e}  "
                      f"gnorm {m['grad_norm']:.2f}  {batch * seq / m['time_s'] / 1e3:.1f}k tok/s")

        t0 = time.time()
        train(model, step_cfg, data.batches(),
              LoopConfig(total_steps=args.steps, ckpt_every=max(args.steps // 4, 1),
                         ckpt_dir=args.ckpt_dir, async_ckpt=True,
                         log_every=max(args.steps // 20, 1)),
              on_metrics=log, group=group)
        wall = time.time() - t0
    finally:
        if args.ranks > 1:
            close_pods()
    if lead:
        print(f"done: {args.steps} steps in {wall / 60:.1f} min; loss "
              f"{history[0]['loss']:.3f} -> {history[-1]['loss']:.3f}")
        with open(args.log, "w") as f:
            json.dump({"preset": args.preset, "params": count_params(cfg), "ranks": args.ranks,
                       "history": history}, f)
        print(f"metrics -> {args.log}; checkpoints -> {args.ckpt_dir}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="25m", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log", default=None)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        args.ckpt_dir = args.ckpt_dir or os.path.join(tmp, "ckpt")
        args.log = args.log or os.path.join(tmp, "log.json")
        store = os.path.join(tmp, "store")
        if args.ranks > 1:
            mp.spawn(run, args=(args, store), nprocs=args.ranks, join=True)
        else:
            run(0, args, store)


if __name__ == "__main__":
    main()
