"""Assigned-architecture registry: --arch <id> resolves here."""
from repro_torch.configs.deepseek_moe_16b import CONFIG as DEEPSEEK_MOE_16B
from repro_torch.configs.phi35_moe_42b import CONFIG as PHI35_MOE_42B
from repro_torch.configs.paligemma_3b import CONFIG as PALIGEMMA_3B
from repro_torch.configs.rwkv6_3b import CONFIG as RWKV6_3B
from repro_torch.configs.gemma3_1b import CONFIG as GEMMA3_1B
from repro_torch.configs.yi_9b import CONFIG as YI_9B
from repro_torch.configs.phi4_mini_38b import CONFIG as PHI4_MINI_38B
from repro_torch.configs.llama32_3b import CONFIG as LLAMA32_3B
from repro_torch.configs.recurrentgemma_9b import CONFIG as RECURRENTGEMMA_9B
from repro_torch.configs.whisper_base import CONFIG as WHISPER_BASE

ARCHS = {
    c.name: c
    for c in (
        DEEPSEEK_MOE_16B,
        PHI35_MOE_42B,
        PALIGEMMA_3B,
        RWKV6_3B,
        GEMMA3_1B,
        YI_9B,
        PHI4_MINI_38B,
        LLAMA32_3B,
        RECURRENTGEMMA_9B,
        WHISPER_BASE,
    )
}

#: convenient aliases used by --arch
ALIASES = {
    "deepseek-moe-16b": "deepseek-moe-16b",
    "phi3.5-moe-42b-a6.6b": "phi3.5-moe-42b",
    "paligemma-3b": "paligemma-3b",
    "rwkv6-3b": "rwkv6-3b",
    "gemma3-1b": "gemma3-1b",
    "yi-9b": "yi-9b",
    "phi4-mini-3.8b": "phi4-mini-3.8b",
    "llama3.2-3b": "llama3.2-3b",
    "recurrentgemma-9b": "recurrentgemma-9b",
    "whisper-base": "whisper-base",
}


def get_config(arch: str):
    key = ALIASES.get(arch, arch)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[key]
