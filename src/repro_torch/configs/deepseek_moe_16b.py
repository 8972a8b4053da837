"""DeepSeekMoE 16B — fine-grained 64-expert top-6 MoE + 2 shared experts.
[arXiv:2401.06066]

28L, d_model 2048, 16 heads (MHA, kv=16, d_head 128), per-expert d_ff 1408,
vocab 102400.  Deviation noted in DESIGN.md: the release uses a dense first
layer (d_ff 10944); we keep all layers MoE for a uniform scan stack.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
)
