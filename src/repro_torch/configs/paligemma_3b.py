"""paligemma-3b [arXiv:2407.07726; hf]: SigLIP + gemma backbone (VLM).

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216. The SigLIP vision
tower is a STUB: input_specs() provides 256 precomputed patch embeddings
prepended to the text sequence.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    layer_pattern="G",
    frontend="vision_stub",
    num_prefix_tokens=256,
    act="gelu",
)
