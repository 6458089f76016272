"""deepseek-moe-16b [arXiv:2401.06066; hf]: fine-grained MoE.

28L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=102400,
2 shared + 64 routed experts, top-6 routing.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,          # expert width (fine-grained)
    d_ff_expert=1408,
    vocab_size=102400,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    layer_pattern="G",
    tie_embeddings=False,
)
