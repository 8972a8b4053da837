"""Seeded weights of a configuration, drawn on the device.

The tree has the program's layout (a nested dict, the layers stacked on
the first axis: ``blocks/attn/wq`` is ``(L, d, H, Dh)``), and its shapes
follow from the configuration's ``run`` sizes alone.  Every leaf is drawn
in one call from one ``torch.Generator`` on the device, seeded with the
run's seed, in the sorted order of the leaves' paths, directly in the
dtype it is served in; so the same seed gives the same weights.

Laws: matrices N(0, 1/fan_in) with fan_in the contracted width; the
embedding and every bias N(0, 0.02²); norm scales and the SSD skip ``D``
ones; ``A_log`` = log U[1, 16]; ``dt_bias`` = softplus⁻¹ of dt drawn
log-uniform in [1e-3, 1e-1]; the depthwise conv N(0, 1/K).
"""
from __future__ import annotations

import math

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _attn(r: dict, pre: tuple) -> dict:
    d, H, KV, Dh = r["d_model"], r["n_heads"], r["n_kv_heads"], r["d_head"]
    s = {"norm": (pre + (d,), "ones"),
         "wq": (pre + (d, H, Dh), d), "wk": (pre + (d, KV, Dh), d),
         "wv": (pre + (d, KV, Dh), d), "wo": (pre + (H, Dh, d), H * Dh)}
    if r.get("qkv_bias"):
        s.update(bq=(pre + (H, Dh), "bias"), bk=(pre + (KV, Dh), "bias"),
                 bv=(pre + (KV, Dh), "bias"))
    return s


def _mlp(r: dict, pre: tuple) -> dict:
    d, ff = r["d_model"], r["d_ff"]
    return {"norm": (pre + (d,), "ones"), "w_gate": (pre + (d, ff), d),
            "w_up": (pre + (d, ff), d), "w_down": (pre + (ff, d), ff)}


def _mamba(r: dict, n: int) -> dict:
    d = r["d_model"]
    di = r["ssm_expand"] * d
    N, K = r["ssm_state"], r["ssm_conv"]
    Hs = di // r["ssm_head_dim"]
    pre = (n,)
    return {"norm": (pre + (d,), "ones"), "in_z": (pre + (d, di), d),
            "in_x": (pre + (d, di), d), "in_B": (pre + (d, N), d),
            "in_C": (pre + (d, N), d), "in_dt": (pre + (d, Hs), d),
            "conv_w": (pre + (K, di + 2 * N), K),
            "conv_b": (pre + (di + 2 * N,), "bias"),
            "A_log": (pre + (Hs,), "A_log"), "D": (pre + (Hs,), "ones"),
            "dt_bias": (pre + (Hs,), "dt_bias"),
            "gate_norm": (pre + (di,), "ones"),
            "out_proj": (pre + (di, d), di)}


#: leaves held in f32 whatever the configuration's dtype
F32_LEAVES = ("A_log", "D", "dt_bias")


def layout(r: dict) -> dict:
    """The tree of ``(shape, law)``: a law is a fan-in (an int), or one of
    ``ones``, ``bias``, ``embed``, ``A_log``, ``dt_bias``."""
    d, V, L = r["d_model"], r["vocab"], r["n_layers"]
    tree = {"embed": ((V, d), "embed"), "final_norm": ((d,), "ones")}
    if not r.get("tie_embeddings"):
        tree["lm_head"] = ((d, V), d)
    if r["family"] == "dense":
        tree["blocks"] = {"attn": _attn(r, (L,)), "mlp": _mlp(r, (L,))}
    elif r["family"] == "hybrid":
        k = r["attn_every"]
        g, rem = L // k, L % k
        tree["blocks"] = {"mamba": _mamba(r, g * k)}
        if rem:
            tree["tail"] = {"mamba": _mamba(r, rem)}
        tree["shared_attn"] = _attn(r, ())
        tree["shared_mlp"] = _mlp(r, ())
    else:
        raise ValueError(f"no weight layout for family {r['family']!r}")
    return tree


def leaves(tree: dict, prefix: str = "") -> list:
    """``[(path, value)]`` in sorted path order (``a/b/c``)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.extend(leaves(v, path))
        else:
            out.append((path, v))
    return out


def put(tree: dict, path: str, value) -> None:
    """Set the leaf at ``path`` (``a/b/c``), making its dicts."""
    *head, last = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def make(r: dict, seed: int, device) -> dict:
    """The weights of the ``run`` sizes ``r`` from ``seed``, on
    ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dtype = _DTYPES[r["dtype"]]
    out: dict = {}
    for path, (shape, law) in leaves(layout(r)):
        name = path.rsplit("/", 1)[-1]
        dt = torch.float32 if name in F32_LEAVES else dtype
        if law == "ones":
            t = torch.ones(shape, dtype=dt, device=device)
        elif law == "A_log":
            t = torch.rand(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(15.0).add_(1.0).log_()
        elif law == "dt_bias":
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt0 = torch.rand(shape, generator=gen, device=device,
                             dtype=torch.float32).mul_(hi - lo).add_(lo).exp_()
            t = dt0 + torch.log(-torch.expm1(-dt0))
        else:
            std = 0.02 if law in ("bias", "embed") else 1.0 / math.sqrt(law)
            t = torch.randn(shape, generator=gen, device=device,
                            dtype=dt).mul_(std)
        put(out, path, t.to(dt))
    return out


def shapes(tree: dict) -> dict:
    """``{path: (shape, dtype name)}`` of a weight tree."""
    return {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in leaves(tree)}
