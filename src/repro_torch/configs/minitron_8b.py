"""Minitron-8B — width/depth-pruned Nemotron-4.  [arXiv:2407.14679]

32L, d_model 4096, 32 heads (GQA kv=8, d_head 128), d_ff 16384, vocab 256000.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab=256000,
)
