"""StableLM-2-1.6B.  [hf:stabilityai/stablelm-2-1_6b]

24L, d_model 2048, 32 heads (MHA kv=32, d_head 64), d_ff 5632, vocab 100352.
Deviation noted in DESIGN.md: the release uses 25% partial rotary; we apply
full rotary embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=5632,
    vocab=100352,
)
