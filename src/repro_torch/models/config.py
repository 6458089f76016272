"""Model configuration for the assigned architecture pool (the port's copy
of the reference's plain-data config).

One frozen dataclass covers all five families (dense / moe / ssm / hybrid /
vlm / audio); family-specific fields are zero/empty when unused. Layer
heterogeneity is expressed with ``layer_pattern`` over single-character block
codes:

    'G' global (full causal) attention        'L' local (sliding-window) attn
    'R' RG-LRU recurrent block (Griffin)      'W' RWKV-6 time-mix block

The pattern tiles across ``num_layers`` (e.g. gemma3's 5:1 local:global is
"LLLLLG"; recurrentgemma's 2:1 recurrent:attention is "RRL").
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int  # query heads (attention layers); wkv heads for rwkv
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- layer pattern / attention ---
    layer_pattern: str = "G"
    window_size: int = 0  # sliding window for 'L' layers
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0  # gemma3 uses 1M for global layers
    logit_softcap: float = 0.0

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- recurrent families ---
    lru_width: int = 0  # RG-LRU hidden width
    conv_width: int = 4  # temporal conv in recurrent block

    # --- encoder-decoder / frontends ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # fixed encoder length (whisper: 1500 frames)
    frontend: str = "none"  # none | audio_stub | vision_stub
    num_prefix_tokens: int = 0  # vision patch tokens prepended (paligemma)

    # --- misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU / plain)
    glu: bool = True

    # long-context eligibility (sub-quadratic attention path exists)
    supports_long_context: bool = False

    # ------------------------------------------------------------------ #

    def layer_types(self) -> Tuple[str, ...]:
        """Per-layer block codes, pattern tiled to num_layers."""
        pat = self.layer_pattern
        reps = math.ceil(self.num_layers / len(pat))
        return tuple((pat * reps)[: self.num_layers])

    @property
    def attention_free(self) -> bool:
        return all(t == "W" for t in self.layer_types())

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    # NOTE: exact parameter counts are computed from the real modules built
    # on the ``meta`` device (repro_torch.models.model.count_params), so
    # they can never drift from the implementation.


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (one fwd + train step)."""
    pat_period = len(cfg.layer_pattern)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=max(2, pat_period),
        d_model=64,
        num_heads=2,
        num_kv_heads=min(2, max(1, cfg.num_kv_heads)),
        head_dim=32,
        d_ff=128,
        vocab_size=256,
        window_size=min(cfg.window_size, 8) if cfg.window_size else 0,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        num_shared_experts=min(cfg.num_shared_experts, 1),
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        lru_width=64 if cfg.lru_width else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=16 if cfg.encoder_seq else 0,
        num_prefix_tokens=8 if cfg.num_prefix_tokens else 0,
    )
