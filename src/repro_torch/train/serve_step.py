"""Serving steps: batched prefill and single-token decode on one device.

The reference's mesh and sharding arguments are dropped: one card has no
mesh. Sampling is greedy (argmax, first index on ties) or temperature
sampling from an explicit ``torch.Generator``. Every step runs under
``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.model import BaseLM, Cache


def make_prefill(model: BaseLM) -> Callable:
    """-> ``prefill(batch, cache) -> (logits (B, 1, V), cache)``."""

    @torch.inference_mode()
    def prefill(batch, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        return model.prefill(batch, cache)

    return prefill


def make_decode_step(model: BaseLM, temperature: float = 0.0) -> Callable:
    """-> ``decode(token, cache, pos, generator=None) -> (next token (B,),
    cache)``; ``generator`` is needed when ``temperature > 0``."""

    @torch.inference_mode()
    def decode(token, cache: Cache, pos, generator: Optional[torch.Generator] = None):
        logits, new_cache = model.decode_step(token, cache, pos)
        if temperature > 0:
            if generator is None:
                raise ValueError("temperature sampling needs a torch.Generator")
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator).squeeze(-1)
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt, new_cache

    return decode


def generate(
    model: BaseLM,
    prompt: torch.Tensor,
    max_new_tokens: int,
    max_len: Optional[int] = None,
    extra_batch: Optional[Dict[str, torch.Tensor]] = None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Host-loop generation: prefill ``prompt`` (B, S) with the entries of
    ``extra_batch`` beside it (``prefix_embed`` of a VLM, ``frames`` of an
    encoder-decoder; put on the model's device), take its argmax, then
    ``max_new_tokens - 1`` decode steps. A vision-stub model's
    ``num_prefix_tokens`` prefix rows take the cache's first slots: the
    cache holds ``max_len`` (default S + max_new_tokens) plus them, and
    decode step i runs at position prefix + S + i. Returns (B,
    max_new_tokens) int64 tokens on the model's device."""
    dev = model.device
    prompt = torch.as_tensor(prompt, dtype=torch.int64, device=dev)
    b, s = prompt.shape
    prefix = model.cfg.num_prefix_tokens if model.cfg.frontend == "vision_stub" else 0
    cache = model.init_cache(b, (max_len or (s + max_new_tokens)) + prefix)
    batch = {"tokens": prompt,
             **{k: torch.as_tensor(v, device=dev) for k, v in (extra_batch or {}).items()}}
    decode = make_decode_step(model, temperature=temperature)
    logits, cache = make_prefill(model)(batch, cache)
    tok = torch.argmax(logits[:, -1, :], dim=-1)
    out = [tok]
    for i in range(max_new_tokens - 1):
        tok, cache = decode(tok, cache, prefix + s + i, generator)
        out.append(tok)
    return torch.stack(out, dim=1)
