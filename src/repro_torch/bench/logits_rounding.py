"""How often each way of computing bf16 logits rounds away from the exact
sum's bf16 value, on the card and on the CPU.

    python -m repro_torch.bench.logits_rounding [--vocab 256000] [--width 4096]

Inputs: seeded normal hidden states (2 x 64 tokens, bf16) and a table of
normal draws times 0.02 (bf16), recurrentgemma-9b's width and vocabulary
by default. The exact value is the float64 product rounded once to bf16.
Ways: one bf16 product (cuBLAS on the tensor cores, fp32 accumulation),
the whole-vocabulary fp32 product cast to bf16, and
:func:`repro_torch.models.model.sliced_logits` (the port's), on the card;
the bf16 product and ``sliced_logits`` on the CPU. Prints one JSON line
with the count of logits each way rounds away from the exact value (in
all, and where |logit| >= 4, where one bf16 ulp is 0.031, above the card
checks' atol of 2e-2), the largest pairwise differences, and the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from typing import List, Optional

import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.model import sliced_logits


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--vocab", type=int, default=256000)
    ap.add_argument("--width", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")  # raises without a card

    g = torch.Generator().manual_seed(args.seed)
    h = torch.randn((2, 64, args.width), generator=g).to(torch.bfloat16)
    table = (torch.randn((args.vocab, args.width), generator=g) * 0.02).to(torch.bfloat16)
    hc, tc = h.to(dev), table.to(dev)
    exact = torch.matmul(hc.double(), tc.double().T).to(torch.bfloat16).cpu()
    ways = {
        "card_bf16_product": torch.matmul(hc, tc.T).cpu(),
        "card_fp32_then_cast": torch.matmul(hc.float(), tc.float().T).to(torch.bfloat16).cpu(),
        "card_sliced_logits": sliced_logits(hc, tc).cpu(),
        "cpu_bf16_product": torch.matmul(h, table.T),
        "cpu_sliced_logits": sliced_logits(h, table),
    }
    big = exact.float().abs() >= 4.0
    out = {"logits": exact.numel(), "logits_abs_ge_4": int(big.sum()), "misrounded": {}}
    for name, got in ways.items():
        off = got != exact
        out["misrounded"][name] = {"all": int(off.sum()), "abs_ge_4": int((off & big).sum())}
    names = sorted(ways)
    out["max_pairwise_difference"] = {
        f"{a} vs {b}": float((ways[a].float() - ways[b].float()).abs().max())
        for i, a in enumerate(names) for b in names[i + 1:]
    }
    out["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
