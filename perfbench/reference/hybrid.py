"""The hybrid family (Zamba2): Mamba2 layers, with ONE shared attention +
MLP block applied before every ``attn_every`` of them (its weights reused
at each insertion), then a tail of the remaining Mamba2 layers.
[arXiv:2411.15242]

The Mamba2 mixer (Dao & Gu 2024): projections z, x, B, C, dt of the
normed input; a depthwise causal conv with bias and SiLU over [x, B, C];
dt = softplus(dt + dt_bias), A = −exp(A_log); the SSD recurrence
h_t = exp(dt_t·A)·h_{t−1} + dt_t·x_t ⊗ B_t, y_t = C_t·h_t + D·x_t, one
B and C shared by the heads, evaluated as a plain chunked scan; the gated
norm rms_norm(y·silu(z)); the out projection; a residual add.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import (F32, attention_block, layer, logits, mlp_block,
                     rms_norm)


def ssd(x, dt, A, B, C, chunk: int):
    """The SSD scan of x (b, S, H, P), dt (b, S, H), A (H,), B / C
    (b, S, N) → y (b, S, H, P), float32, from a zero state."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    c = chunk
    while S % c:
        c //= 2
    nc = S // c
    la = (dt * A).reshape(b, nc, c, H)                      # log decays
    xdt = (x * dt[..., None]).reshape(b, nc, c, H, P)
    Bc, Cc = B.reshape(b, nc, c, N), C.reshape(b, nc, c, N)
    cum = torch.cumsum(la, dim=2)                           # (b,nc,c,H)
    # within a chunk: y_i = Σ_{j<=i} (C_i·B_j) exp(cum_i − cum_j) x_j dt_j
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (b,nc,i,j,H)
    tri = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~tri[None, None, :, :, None],
                                      float("-inf")))
    cb = torch.einsum("bkin,bkjn->bkij", Cc, Bc)
    y = torch.einsum("bkijh,bkjhp->bkihp", cb[..., None] * decay, xdt)
    # the state each chunk leaves, and the one that enters it
    to_end = torch.exp(cum[:, :, -1:, :] - cum)             # (b,nc,c,H)
    states = torch.einsum("bkjn,bkjhp->bkhpn", Bc, xdt * to_end[..., None])
    h = torch.zeros(b, H, P, N, dtype=F32, device=x.device)
    entering = []
    for k in range(nc):
        entering.append(h)
        h = h * torch.exp(cum[:, k, -1, :])[..., None, None] + states[:, k]
    entering = torch.stack(entering, dim=1)                 # (b,nc,H,P,N)
    y = y + torch.einsum("bkin,bkhpn->bkihp", Cc, entering) \
        * torch.exp(cum)[..., None]
    return y.reshape(b, S, H, P)


def mamba_block(ar, p: dict, h, r: dict):
    b, S, _ = h.shape
    N, P, K = r["ssm_state"], r["ssm_head_dim"], r["ssm_conv"]
    eps = r["norm_eps"]
    x = rms_norm(h, p["norm"], eps)
    z = ar.einsum("bsd,de->bse", x, p["in_z"])
    xi = ar.einsum("bsd,de->bse", x, p["in_x"])
    Bp = ar.einsum("bsd,dn->bsn", x, p["in_B"])
    Cp = ar.einsum("bsd,dn->bsn", x, p["in_C"])
    dt = ar.einsum("bsd,dh->bsh", x, p["in_dt"])
    u = torch.cat([xi, Bp, Cp], dim=-1)
    w = p["conv_w"].to(F32)
    up = F.pad(u, (0, 0, K - 1, 0))
    conv = sum(up[:, i:i + S] * w[i] for i in range(K)) + p["conv_b"].to(F32)
    conv = F.silu(conv)
    di = xi.shape[-1]
    xi, Bp, Cp = conv[..., :di], conv[..., di:di + N], conv[..., di + N:]
    dt = F.softplus(dt + p["dt_bias"].to(F32))
    A = -torch.exp(p["A_log"].to(F32))
    xh = xi.reshape(b, S, di // P, P)
    y = ssd(xh, dt, A, Bp, Cp, r["ssm_chunk"]) \
        + xh * p["D"].to(F32)[None, None, :, None]
    y = rms_norm(y.reshape(b, S, di) * F.silu(z), p["gate_norm"], eps)
    return ar.act(h + ar.einsum("bse,ed->bsd", y, p["out_proj"]))


def forward(ar, params: dict, tokens, r: dict, last: int = None):
    """Logits (B, S, V) float32 of ``tokens`` (B, S); with ``last`` only
    the last ``last`` positions'."""
    h = ar.act(params["embed"][tokens])
    eps, theta = r["norm_eps"], r["rope_theta"]
    k = r["attn_every"]
    g = r["n_layers"] // k
    for i in range(g * k):
        if i % k == 0:
            h = attention_block(ar, params["shared_attn"], h, eps, theta,
                                r.get("qkv_bias"))
            h = mlp_block(ar, params["shared_mlp"], h, eps)
        h = mamba_block(ar, layer(params["blocks"]["mamba"], i), h, r)
    for i in range(r["n_layers"] - g * k):
        h = mamba_block(ar, layer(params["tail"]["mamba"], i), h, r)
    return logits(ar, params, h, r, last)
