"""Pixtral-12B — Pixtral-ViT frontend + Mistral-Nemo decoder backbone.
[hf:mistralai/Pixtral-12B-2409]

40L, d_model 5120, 32 heads (GQA kv=8, d_head 128), d_ff 14336,
vocab 131072.  The ViT vision encoder + projector input is a STUB per the
brief: input_specs() provides (B, n_patches, vision_dim) patch embeddings;
we own the projector and the decoder.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=131072,
    n_patches=1024,
    vision_dim=1024,
    rope_theta=1e6,
)
