"""Quickstart on the PyTorch port: build a tiny assigned-architecture model,
train a few steps on synthetic data, checkpoint it, and generate a few
tokens.

    PYTHONPATH=src python examples/torch_quickstart.py [--arch llama3.2-3b] [--device cpu]
    PYTHONPATH=src python examples/torch_quickstart.py --preset tiny --device cpu

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import tempfile

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.models.config import reduce_for_smoke
from repro_torch.models.model import build_model, count_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.serve_step import generate
from repro_torch.train.train_step import StepConfig

PRESETS = {
    # name: (steps, batch, seq, checkpoint period, new tokens)
    "smoke": (30, 8, 64, 10, 8),
    "tiny": (4, 4, 16, 2, 4),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--preset", default="smoke", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    steps, batch, seq, every, new = PRESETS[args.preset]
    steps = args.steps or steps

    cfg = reduce_for_smoke(get_config(args.arch))
    model = build_model(cfg, device=args.device)
    print(f"arch={cfg.name} params={count_params(cfg):,} device={model.device}")

    data = SyntheticLM(cfg, DataConfig(global_batch=batch, seq_len=seq))
    step_cfg = StepConfig(
        optimizer=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=steps, weight_decay=0.0)
    )
    with tempfile.TemporaryDirectory() as d:
        train(
            model, step_cfg, data.batches(),
            LoopConfig(total_steps=steps, ckpt_every=every, ckpt_dir=d, log_every=max(steps // 6, 1)),
            on_metrics=lambda s, m: print(
                f"step {s:4d} loss {m['loss']:.3f} ({m['time_s']*1e3:.0f} ms)"
            ),
        )
        print(f"checkpoints in {d}: latest step {ckpt.latest_step(d)}")

    prompt = torch.tensor([[5, 17, 11, 2]], dtype=torch.int64, device=model.device)
    toks = generate(model, prompt, max_new_tokens=new, max_len=32)
    print("generated token ids:", toks[0].tolist())


if __name__ == "__main__":
    main()
