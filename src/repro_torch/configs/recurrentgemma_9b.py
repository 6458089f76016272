"""recurrentgemma-9b [arXiv:2402.19427]: Griffin — RG-LRU + local attn, 1:2.

38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000; pattern RRL
(two recurrent blocks per local-attention block), window 2048.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    layer_pattern="RRL",
    window_size=2048,
    lru_width=4096,
    act="gelu",
    supports_long_context=True,  # bounded state + windowed attention
)
