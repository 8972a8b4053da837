"""The dense family (Qwen2): token embedding, pre-norm decoder layers of
causal GQA attention (QKV bias, RoPE) and a SwiGLU MLP, final RMSNorm,
tied or separate unembedding.  [arXiv:2407.10671]"""
from __future__ import annotations

from .common import attention_block, layer, logits, mlp_block


def forward(ar, params: dict, tokens, r: dict, last: int = None):
    """Logits (B, S, V) float32 of ``tokens`` (B, S); with ``last`` only
    the last ``last`` positions'."""
    h = ar.act(params["embed"][tokens])
    eps, theta = r["norm_eps"], r["rope_theta"]
    blocks = params["blocks"]
    for i in range(r["n_layers"]):
        p = layer(blocks, i)
        h = attention_block(ar, p["attn"], h, eps, theta, r.get("qkv_bias"))
        h = mlp_block(ar, p["mlp"], h, eps)
    return logits(ar, params, h, r, last)
