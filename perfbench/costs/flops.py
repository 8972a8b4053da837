"""Model FLOPs of a configuration, from its ``run`` sizes alone.

Counted: the matrix products (2 per multiply-add), causal attention's
QKᵀ and PV on the visible pairs (4·D per pair and head), and the SSD scan
(the chunk products as ``kernels.ssd_cost`` counts them, plus 2·N·P a head
for the chunk's entering state; a decoded token's step 4·N·P a head).
Not counted: norms, activations, the conv, RoPE, softmax, and anything
recomputed.  A forward unembeds only the positions whose logits it
returns.  Training is 3× the forward (forward and backward).
"""
from __future__ import annotations


def _dense_layer_params(r: dict) -> int:
    d, H, KV, Dh, ff = (r["d_model"], r["n_heads"], r["n_kv_heads"],
                        r["d_head"], r["d_ff"])
    return d * H * Dh + 2 * d * KV * Dh + H * Dh * d + 3 * d * ff


def _mamba_layer_params(r: dict) -> int:
    d = r["d_model"]
    di = r["ssm_expand"] * d
    N = r["ssm_state"]
    Hs = di // r["ssm_head_dim"]
    return 2 * d * di + 2 * d * N + d * Hs + di * d


def attention_blocks(r: dict) -> int:
    """Attention blocks a token passes through."""
    if r["family"] == "hybrid":
        return r["n_layers"] // r["attn_every"]
    return r["n_layers"]


def ssd_layers(r: dict) -> int:
    return r["n_layers"] if r["family"] == "hybrid" else 0


def _matmul_params(r: dict) -> int:
    """Matrix parameters a token passes through below the unembedding."""
    if r["family"] == "hybrid":
        return (attention_blocks(r) * _dense_layer_params(r)
                + r["n_layers"] * _mamba_layer_params(r))
    return r["n_layers"] * _dense_layer_params(r)


def _ssd_token(r: dict, decode: bool) -> int:
    if not ssd_layers(r):
        return 0
    di = r["ssm_expand"] * r["d_model"]
    P, N, c = r["ssm_head_dim"], r["ssm_state"], r["ssm_chunk"]
    H = di // P
    per = 4 * N * P if decode else 2 * (c * N + c * P + N * P) + 2 * N * P
    return ssd_layers(r) * H * per


def _attn_pairs_flops(r: dict, pairs: int) -> int:
    return 4 * r["d_head"] * r["n_heads"] * attention_blocks(r) * pairs


def unembed(r: dict) -> int:
    return 2 * r["d_model"] * r["vocab"]


def sequence_forward(r: dict, S: int, unembed_all: bool) -> int:
    """Forward FLOPs of one causal sequence of ``S`` tokens from position
    0: every position's logits (``unembed_all``) or only the last's."""
    pairs = S * (S + 1) // 2
    n_unembed = S if unembed_all else 1
    return (S * (2 * _matmul_params(r) + _ssd_token(r, decode=False))
            + _attn_pairs_flops(r, pairs) + n_unembed * unembed(r))


def decode_token(r: dict, pos: int) -> int:
    """Forward FLOPs of one decoded token at position ``pos`` (it attends
    to ``pos + 1`` keys) with its logits."""
    return (2 * _matmul_params(r) + _ssd_token(r, decode=True)
            + _attn_pairs_flops(r, pos + 1) + unembed(r))


def train_round(r: dict, batch: int, seq: int) -> int:
    """FLOPs of a training round's forward and backward over ``batch``
    sequences of ``seq`` tokens (every position's logits)."""
    return 3 * batch * sequence_forward(r, seq, unembed_all=True)
