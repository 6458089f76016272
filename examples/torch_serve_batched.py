"""Batched serving on the PyTorch port: prefill a batch of prompts, then
decode autoregressively with a shared decode step.

    PYTHONPATH=src python examples/torch_serve_batched.py --arch gemma3-1b
    PYTHONPATH=src python examples/torch_serve_batched.py --preset tiny --device cpu

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import frontend_stubs
from repro_torch.models.config import reduce_for_smoke
from repro_torch.models.model import build_model
from repro_torch.train.serve_step import make_decode_step, make_prefill

PRESETS = {
    # name: (batch, prompt length, new tokens)
    "smoke": (4, 16, 24),
    "tiny": (2, 8, 4),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--preset", default="smoke", choices=PRESETS)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    batch_size, prompt_len, new_tokens = PRESETS[args.preset]

    cfg = reduce_for_smoke(get_config(args.arch))
    model = build_model(cfg, device=args.device).init(
        torch.Generator(device=args.device).manual_seed(0))
    dev = model.device

    rng = np.random.RandomState(0)
    prompts = rng.randint(0, cfg.vocab_size, size=(batch_size, prompt_len)).astype(np.int64)
    batch = {"tokens": torch.from_numpy(prompts).to(dev)}
    batch.update({k: torch.from_numpy(v).to(dev)
                  for k, v in frontend_stubs(cfg, batch_size).items()})
    prefix = cfg.num_prefix_tokens if cfg.frontend == "vision_stub" else 0
    max_len = prefix + prompt_len + new_tokens

    prefill = make_prefill(model)
    decode = make_decode_step(model, temperature=args.temperature)

    cache = model.init_cache(batch_size, max_len)
    t0 = time.time()
    logits, cache = prefill(batch, cache)
    tok = torch.argmax(logits[:, -1, :], dim=-1)
    t_prefill = time.time() - t0

    out = [tok]
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.time()
    for i in range(new_tokens - 1):
        tok, cache = decode(tok, cache, prefix + prompt_len + i, gen)
        out.append(tok)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_decode = time.time() - t0

    generated = torch.stack(out, dim=1).cpu().numpy()
    total_new = batch_size * new_tokens
    print(f"arch={cfg.name} batch={batch_size} prompt={prompt_len} (+{prefix} prefix) "
          f"new={new_tokens} device={dev}")
    print(f"prefill {t_prefill*1e3:.0f} ms; decode {t_decode*1e3:.0f} ms "
          f"({total_new/max(t_decode,1e-9):.1f} tok/s)")
    for b in range(batch_size):
        print(f"req[{b}]: {prompts[b,:6].tolist()}... -> {generated[b,:8].tolist()}...")


if __name__ == "__main__":
    main()
