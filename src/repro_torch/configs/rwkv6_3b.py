"""rwkv6-3b "Finch" [arXiv:2404.05892; hf]: attention-free, data-dependent decay.

32L d_model=2560 d_ff=8960 vocab=65536; WKV heads of dim 64 (40 heads).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    layer_pattern="W",
    glu=False,            # rwkv channel-mix is a 2-matrix squared-relu FFN
    act="relu2",
    supports_long_context=True,  # O(1) state per token
)
