"""Model assembly: ``build_model(config)`` -> an ``nn.Module`` with ``init``,
``forward``, ``init_cache``, ``prefill`` and ``decode_step``.

Ported so far: ``RwkvLM``, the uniform RWKV-6 stack (attention-free). Other
families raise ``NotImplementedError``.

The residual stream is bf16, as in the reference: the embedding is cast to
bf16, each block returns its input's dtype and the residual adds run in
bf16. Parameters are fp32 ``nn.Parameter``s with the reference's names, so
that :func:`param_shapes` matches the reference's init tree leaf for leaf
(layers stacked on a leading axis) and :mod:`repro_torch.models.convert`
can carry a reference tree over.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models.config import ModelConfig

Cache = Dict[str, torch.Tensor]


def _params(shapes: Dict[str, Tuple[int, ...]], device) -> Dict[str, nn.Parameter]:
    """Uninitialised fp32 parameters of the given shapes. They take no
    gradient: the ported path serves (``requires_grad_()`` turns it on)."""
    return {
        name: nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device),
                           requires_grad=False)
        for name, shape in shapes.items()
    }


class BaseLM(nn.Module):
    """Embedding and output head shared by every family."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        shapes = {"tok": (cfg.vocab_size, cfg.d_model), "final_norm": (cfg.d_model,)}
        if not cfg.tie_embeddings:
            shapes["head"] = (cfg.vocab_size, cfg.d_model)
        self.embed = nn.ParameterDict(_params(shapes, device))

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    def _init_embed(self, generator: torch.Generator) -> None:
        values = {"tok": L.dense_init(self.embed["tok"].shape, generator, 0.02)}
        if "head" in self.embed:
            values["head"] = L.dense_init(self.embed["head"].shape, generator, 0.02)
        values["final_norm"] = torch.zeros(self.cfg.d_model)
        for name, value in values.items():
            self.embed[name].copy_(value)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token lookup times sqrt(d_model) in fp32, cast to bf16."""
        emb = F.embedding(tokens, self.embed["tok"])
        return L.cast(emb * math.sqrt(self.cfg.d_model))

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """Final norm, then bf16 x bf16 against the (tied) table with fp32
        accumulation, stored bf16. The products of two bf16 values are exact
        in fp32, so the fp32 product of the upcast operands is that sum."""
        h = L.rms_norm(h, self.embed["final_norm"], self.cfg.norm_eps)
        table = self.embed["head"] if "head" in self.embed else self.embed["tok"]
        logits = torch.matmul(h.float(), L.cast(table).float().T)
        return logits.to(torch.bfloat16)


class RwkvBlock(nn.Module):
    """One RWKV-6 layer: norm, time mix, residual, norm, channel mix,
    residual."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        shapes = {"attn_norm": (cfg.d_model,), "ffn_norm": (cfg.d_model,)}
        shapes.update(rwkv_lib.rwkv_param_shapes(
            cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff))
        for name, param in _params(shapes, device).items():
            self.register_parameter(name, param)

    def reset_parameters(self, generator: torch.Generator) -> None:
        cfg = self.cfg
        values = rwkv_lib.rwkv_param_init(
            generator, cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff)
        values["attn_norm"] = torch.zeros(cfg.d_model)
        values["ffn_norm"] = torch.zeros(cfg.d_model)
        for name, value in values.items():
            getattr(self, name).copy_(value)

    def forward(self, h: torch.Tensor, state: Optional[Cache] = None):
        cfg = self.cfg
        x = L.rms_norm(h, self.attn_norm, cfg.norm_eps)
        y, tm = rwkv_lib.rwkv_time_mix(self, x, cfg.num_heads, cfg.head_dim, state)
        h = h + y
        x = L.rms_norm(h, self.ffn_norm, cfg.norm_eps)
        y, cm_shift = rwkv_lib.rwkv_channel_mix(self, x, state)
        return h + y, {"wkv": tm["wkv"], "shift_tm": tm["shift_tm"], "shift_cm": cm_shift}


class RwkvLM(BaseLM):
    """Uniform RWKV-6 stack."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg, device)
        self.layers = nn.ModuleList(RwkvBlock(cfg, device) for _ in range(cfg.num_layers))

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> "RwkvLM":
        """Fill every parameter with seeded draws from ``generator`` (default:
        seed 0 on the model's device). Returns the model."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        for block in self.layers:
            block.reset_parameters(generator)
        self._init_embed(generator)
        return self

    def param_shapes(self) -> dict:
        """Shapes in the reference's init-tree layout: ``{"embed": {...},
        "layers": {name: (num_layers, *shape)}}``."""
        block = self.layers[0]
        return {
            "embed": {n: tuple(p.shape) for n, p in self.embed.items()},
            "layers": {n: (len(self.layers), *p.shape) for n, p in block.named_parameters()},
        }

    def forward(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B, T, V) bf16, aux loss 0)."""
        h = self._embed(batch["tokens"])
        for block in self.layers:
            h, _ = block(h, None)
        return self._logits(h), torch.zeros((), dtype=torch.float32, device=h.device)

    def init_cache(self, batch_size: int, max_len: int) -> Cache:
        """Zero recurrent state; ``max_len`` is unused (the state is O(1))."""
        cfg = self.cfg
        lb = (cfg.num_layers, batch_size)
        f4, dev = torch.float32, self.device
        return {
            "wkv": torch.zeros(lb + (cfg.num_heads, cfg.head_dim, cfg.head_dim),
                               dtype=f4, device=dev),
            "shift_tm": torch.zeros(lb + (cfg.d_model,), dtype=f4, device=dev),
            "shift_cm": torch.zeros(lb + (cfg.d_model,), dtype=f4, device=dev),
        }

    def _run_with_state(self, h: torch.Tensor, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        new = {name: [] for name in cache}
        for i, block in enumerate(self.layers):
            h, st = block(h, {name: c[i] for name, c in cache.items()})
            for name in new:
                new[name].append(st[name])
        return h, {name: torch.stack(v) for name, v in new.items()}

    def prefill(self, batch: Dict[str, torch.Tensor], cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """-> (logits of the last position (B, 1, V) bf16, new cache)."""
        h = self._embed(batch["tokens"])
        h, new_cache = self._run_with_state(h, cache)
        return self._logits(h[:, -1:, :]), new_cache

    def decode_step(self, token: torch.Tensor, cache: Cache, pos=None) -> Tuple[torch.Tensor, Cache]:
        """token (B,) -> (logits (B, V) bf16, new cache). ``pos`` is unused."""
        h = self._embed(token[:, None])
        h, new_cache = self._run_with_state(h, cache)
        return self._logits(h)[:, 0, :], new_cache


def build_model(cfg: Union[str, ModelConfig], device=None) -> BaseLM:
    """The module of ``cfg`` with uninitialised parameters on ``device``
    (default: the card; ``"meta"`` allocates nothing). Call ``init`` or
    :func:`repro_torch.models.convert.params_from_jax` to fill it."""
    cfg = get_config(cfg) if isinstance(cfg, str) else cfg
    if set(cfg.layer_types()) != {"W"} or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}, layers {cfg.layer_pattern!r}): not ported yet; "
            "the port has the RWKV-6 family only")
    return RwkvLM(cfg, resolve_device(device))


def param_shapes(cfg: Union[str, ModelConfig]) -> dict:
    """Parameter shapes of ``cfg``'s model, from its module built on the
    ``meta`` device, in the reference's init-tree layout."""
    return build_model(cfg, device="meta").param_shapes()


def count_params(cfg: Union[str, ModelConfig]) -> int:
    tree = param_shapes(cfg)
    return sum(math.prod(s) for group in tree.values() for s in group.values())
