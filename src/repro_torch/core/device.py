"""Device resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another. There is no silent fallback — a CUDA request without a
    card raises. A CUDA device also sets the card's bf16 products to
    accumulate in full fp32 (a process-wide cuBLAS setting)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU"
        )
    if dev.type == "cuda":
        # bf16 x bf16 products accumulate in fp32 and round once, as the
        # reference's do; cuBLAS may otherwise reduce split-K partial sums
        # in bf16 (fp32 products already run without TF32 by default)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev
