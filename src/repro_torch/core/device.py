"""Device resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another. There is no silent fallback — a CUDA request without a
    card raises. A CUDA device also sets two process-wide settings, so that
    the card's products round as the reference's do whatever the caller set
    before: bf16 products accumulate in full fp32, and fp32 matrix products
    run in full fp32, never TF32 (``torch.set_float32_matmul_precision
    ("highest")``, which also clears
    ``torch.backends.cuda.matmul.allow_tf32``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU"
        )
    if dev.type == "cuda":
        # bf16 x bf16 products accumulate in fp32 and round once, as the
        # reference's do; cuBLAS may otherwise reduce split-K partial sums
        # in bf16
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        # fp32 x fp32 products in fp32, as the reference computes them; a
        # caller's "high" or "medium" would run them in TF32 or bf16
        torch.set_float32_matmul_precision("highest")
    return dev
