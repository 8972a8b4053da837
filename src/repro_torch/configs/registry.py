"""Architecture registry: --arch <id> resolution."""
from .base import ArchConfig, InputShape, SHAPES, smoke_shape
from .grok_1_314b import CONFIG as grok_1_314b
from .deepseek_moe_16b import CONFIG as deepseek_moe_16b
from .minitron_8b import CONFIG as minitron_8b
from .qwen2_0_5b import CONFIG as qwen2_0_5b
from .stablelm_1_6b import CONFIG as stablelm_1_6b
from .zamba2_7b import CONFIG as zamba2_7b
from .mamba2_370m import CONFIG as mamba2_370m
from .seamless_m4t_large_v2 import CONFIG as seamless_m4t_large_v2
from .pixtral_12b import CONFIG as pixtral_12b
from .qwen3_8b import CONFIG as qwen3_8b

ARCHS = {
    c.name: c
    for c in (
        grok_1_314b,
        deepseek_moe_16b,
        minitron_8b,
        qwen2_0_5b,
        stablelm_1_6b,
        zamba2_7b,
        mamba2_370m,
        seamless_m4t_large_v2,
        pixtral_12b,
        qwen3_8b,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]
