"""SeamlessM4T-large-v2 — encoder-decoder transformer backbone (multimodal).
[arXiv:2308.11596]

24 encoder + 24 decoder layers (the assigned "24L" is the published
per-stack depth), d_model 1024, 16 heads (MHA kv=16, d_head 64), d_ff 8192,
vocab 256206.  The mel-spectrogram + conv feature extractor frontend is a
STUB per the brief: input_specs() provides (B, S, frontend_dim) frame
embeddings; we own the input projection and the full enc-dec backbone.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,            # decoder depth
    enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=8192,
    vocab=256206,
    frontend_dim=160,
    dec_ratio=4,
)
