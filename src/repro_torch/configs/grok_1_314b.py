"""grok-1 (314B) — 8-expert top-2 MoE.  [hf:xai-org/grok-1]

64L, d_model 6144, 48 heads (GQA kv=8, d_head 128), expert d_ff 32768,
vocab 131072.  All layers are MoE (no shared experts), per the release.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=32768,
    vocab=131072,
    n_experts=8,
    n_shared_experts=0,
    top_k=2,
    moe_d_ff=32768,
    rope_theta=1e4,
)
