"""Qwen3-8B — GQA with per-head q/k RMS norm.  [hf:Qwen/Qwen3-8B]

36L, d_model 4096, 32 heads (GQA kv=8, d_head 128), d_ff 12288, vocab 151936.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=12288,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
)
