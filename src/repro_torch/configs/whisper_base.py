"""whisper-base [arXiv:2212.04356]: encoder-decoder audio transformer.

6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865. The conv frontend is
a STUB: input_specs() provides 1500 precomputed frame embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    layer_pattern="G",
    encoder_layers=6,
    encoder_seq=1500,
    frontend="audio_stub",
    act="gelu",
    glu=False,
)
