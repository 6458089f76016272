"""``BaseLM._logits``: bf16 operands, fp32 sums, bf16 storage, computed a
slice of ``LOGITS_SLICE`` vocabulary columns at a time, so no fp32 (B, S,
V) tensor is made.

Held to the whole-vocabulary fp32-then-cast product it replaced (the
products of two bf16 values are exact in fp32, so the two differ only in
the order the fp32 sums are taken): within one bf16 ulp of each logit,
plus the bound of that reordering (twice d_model fp32 roundings of the
sum of the product magnitudes), on gemma3- and rwkv6-shaped narrow models
on the CPU, with vocabularies of one slice and of several.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models.config import reduce_for_smoke
from repro_torch.models import model as M
from repro_torch.models.model import build_model


def _old_logits(model, h):
    h = L.rms_norm(h, model.embed["final_norm"], model.cfg.norm_eps)
    table = model.embed["head"] if "head" in model.embed else model.embed["tok"]
    return torch.matmul(h.float(), L.cast(table).float().T).to(torch.bfloat16), h, table


def _bf16_ulp(x):
    """One bf16 ulp of |x| (2^(e-7) for |x| in [2^e, 2^(e+1)))."""
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("name,d_model,vocab,slice_", [
    ("gemma3-1b", 256, 8192, None), ("gemma3-1b", 1152, 4096, None),
    ("rwkv6-3b", 128, 2048, None), ("gemma3-1b", 256, 8192, 1000), ("rwkv6-3b", 128, 2048, 512),
])
def test_logits_equal_the_fp32_path_within_one_ulp(name, d_model, vocab, slice_, monkeypatch):
    if slice_ is not None:
        monkeypatch.setattr(M, "LOGITS_SLICE", slice_)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(name)), d_model=d_model, vocab_size=vocab)
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    h = torch.randn((2, 9, d_model), generator=g).to(torch.bfloat16)
    new = model._logits(h)
    old, hn, table = _old_logits(model, h)
    assert new.dtype == torch.bfloat16 and new.shape == (2, 9, vocab)
    mag = torch.matmul(hn.float().abs(), L.cast(table).float().abs().T)
    reorder = 2 * d_model * 2.0 ** -24 * mag
    ulp = torch.maximum(_bf16_ulp(old.float()), _bf16_ulp(new.float()))
    diff = (new.float() - old.float()).abs()
    assert bool((diff <= ulp + reorder).all())
    # most logits are the same bf16 value
    assert float((new == old).float().mean()) > 0.99
