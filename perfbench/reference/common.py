"""Plain PyTorch building blocks of the reference, in float32.

Nothing here imports the program: the reference is written from the
architectures' published equations (the configuration files list where
the program departs from the release, and the reference follows the
configuration as it is run).  Every product and every activation between
blocks goes through an :class:`Arith`, so the same forward runs in
float32 (TF32 off) or, as the control that ``correct`` must fail, in
float8 e4m3 where the configuration states bfloat16: every product's
operands and the residual stream between blocks rounded to e4m3, one
scale per tensor, and so are their gradients in the backward pass.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

F32 = torch.float32


class Arith:
    """float32 products (the reference)."""

    name = "f32"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(F32)

    def einsum(self, eq: str, *ops) -> torch.Tensor:
        return torch.einsum(eq, *(self.q(o) for o in ops))

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation the configuration holds between blocks."""
        return x.to(F32)


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale (amax / 448)."""
    s = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


class _Round(torch.autograd.Function):
    """Float8 both ways: the value rounded, and the gradient that flows
    back through it rounded too, as a float8 backward holds it."""

    @staticmethod
    def forward(ctx, x):
        return _e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return _e4m3(g)


class FP8Arith(Arith):
    """float8 e4m3 where the configuration states bfloat16, one scale per
    tensor: every product's operands, multiplied in float32, and the
    residual stream between blocks, in the forward pass and in the
    gradients of the backward (the control)."""

    name = "fp8"

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return self.q(x)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _Round.apply(x.to(F32))


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, restored on exit."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def rms_norm(x, w, eps: float):
    x = x.to(F32)
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * w.to(F32)


def rope(x, positions, theta: float):
    """Rotary embedding on the two halves of the head dim; x (B, S, H, D)."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=F32, device=x.device)
                           / half))
    ang = positions.to(F32)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention_block(ar: Arith, p: dict, h, eps: float, theta: float,
                    qkv_bias: bool):
    """h + causal GQA self-attention of rms_norm(h), RoPE at 0..S−1."""
    B, S, _ = h.shape
    x = rms_norm(h, p["norm"], eps)
    q = ar.einsum("bsd,dhk->bshk", x, p["wq"])
    k = ar.einsum("bsd,dhk->bshk", x, p["wk"])
    v = ar.einsum("bsd,dhk->bshk", x, p["wv"])
    if qkv_bias:
        q, k, v = q + p["bq"].to(F32), k + p["bk"].to(F32), \
            v + p["bv"].to(F32)
    pos = torch.arange(S, device=h.device)
    q, k = rope(q, pos, theta), rope(k, pos, theta)
    H, KV, D = q.shape[2], k.shape[2], q.shape[3]
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    scores = ar.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    o = ar.einsum("bhqk,bkhd->bqhd", probs, v)
    return ar.act(h + ar.einsum("bshk,hkd->bsd", o, p["wo"]))


def mlp_block(ar: Arith, p: dict, h, eps: float):
    """h + SwiGLU of rms_norm(h)."""
    x = rms_norm(h, p["norm"], eps)
    g = ar.einsum("bsd,df->bsf", x, p["w_gate"])
    u = ar.einsum("bsd,df->bsf", x, p["w_up"])
    return ar.act(h + ar.einsum("bsf,fd->bsd", F.silu(g) * u, p["w_down"]))


def logits(ar: Arith, params: dict, h, r: dict, last: int = None):
    """Final norm and unembedding → (B, S, V) float32; with ``last`` only
    the last ``last`` positions'."""
    if last is not None:
        h = h[:, -last:]
    x = rms_norm(h, params["final_norm"], r["norm_eps"])
    if r.get("tie_embeddings"):
        return ar.einsum("bsd,vd->bsv", x, params["embed"])
    return ar.einsum("bsd,dv->bsv", x, params["lm_head"])


def weighted_xent(lg, tokens, weights):
    """Next-token cross entropy, each sequence weighted: Σ w·nll over
    Σ w (every position of a sequence carries its weight) + 1e-6."""
    lg = lg[:, :-1].to(F32)
    labels = tokens[:, 1:]
    nll = torch.logsumexp(lg, -1) - lg.gather(-1, labels[..., None])[..., 0]
    w = weights.to(F32)[:, None].expand_as(nll)
    return (nll * w).sum() / (w.sum() + 1e-6)


def layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}
