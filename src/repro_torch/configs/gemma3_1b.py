"""gemma3-1b [hf:google/gemma-3-1b-pt]: 5:1 local:global attention, 128k ctx.

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144, sliding window 512,
RoPE theta 10k local / 1M global.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    layer_pattern="LLLLLG",
    window_size=512,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    act="gelu",
    supports_long_context=True,  # mostly-local; global layers decode linearly
)
