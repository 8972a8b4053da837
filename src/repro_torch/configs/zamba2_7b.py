"""Zamba2-7B — Mamba2 backbone + shared attention blocks.  [arXiv:2411.15242]

81 Mamba2 layers, d_model 3584, ssm_state 64; a single *shared* attention+MLP
block (32 heads, d_head 112, d_ff 14336) is applied every 6 SSM layers
(weights re-used at every insertion; the release's per-insertion LoRA deltas
are omitted — noted in DESIGN.md).  vocab 32000.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=112,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
)
