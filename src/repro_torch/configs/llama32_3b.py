"""llama3.2-3b [hf:meta-llama]: small llama3 dense.

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    layer_pattern="G",
    rope_theta=500_000.0,
)
