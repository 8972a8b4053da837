#!/usr/bin/env python3
"""Build and drive the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, each of which fails the run (non-zero exit, no result line):

1. device: CUDA must be present; prints the card's name and power limit
   and turns TF32 off for float32 products;
2. build: compiles every kernel of the serving path from ``csrc/`` with
   ``nvcc`` for ``sm_90a``;
3. kernels against their plain versions, on the card: the serving path's
   prefill shape and the kernel test matrix (MHA, GQA 4:1, ragged MQA,
   D = 128, windows, non-causal, an empty-row case), in f32 and bf16 at the
   kernel suite's tolerances; at the main-path shape the kernel, its plain
   version and ``scaled_dot_product_attention`` (a yardstick only: the port
   never calls it) are timed with CUDA events;
4. the main path at full width: ``run(ExperimentSpec(objective=ServeJob(
   arch="qwen2-0.5b", reduced=False, batch=4, prompt_len=1024, ...)))`` with
   the flash kernel on, which must launch it once per layer; then prefill
   again on the same params with and without the kernel, whose last-token
   logits must agree to bf16 tolerance;
5. prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
   line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch                                                  # noqa: E402
import torch.nn.functional as F                               # noqa: E402

from repro_torch.api import ExperimentSpec, ServeJob, run     # noqa: E402
from repro_torch.kernels import _build                        # noqa: E402
from repro_torch.kernels import flash_attention as FA         # noqa: E402
from repro_torch.kernels.ref import attention_mask            # noqa: E402
from repro_torch.models import init_params, prefill           # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}     # tests/test_kernels.py

#: (label, B, Sq, Sk, H, KV, D, causal, window): the serving path's prefill
#: shape first (timed too), then the kernel test matrix
CASES = [
    ("main_path", 4, 1024, 1024, 14, 2, 64, True, None),
    ("mha", 1, 128, 128, 4, 4, 64, True, None),
    ("gqa4", 2, 256, 256, 8, 2, 64, True, None),
    ("ragged_mqa", 1, 96, 160, 4, 1, 32, True, None),
    ("d128", 1, 512, 512, 2, 2, 128, True, None),
    ("window16", 1, 256, 256, 4, 4, 64, True, 16),
    ("window64", 1, 256, 256, 4, 4, 64, True, 64),
    ("window1000", 1, 256, 256, 4, 4, 64, True, 1000),
    ("noncausal", 2, 128, 192, 4, 4, 64, False, None),
    ("empty_rows", 1, 128, 32, 2, 2, 32, False, 16),
]
SERVE = dict(arch="qwen2-0.5b", reduced=False, batch=4, prompt_len=1024,
             T=32, seed=0)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound(q, k, causal, window):
    """(bound_ms, bound_by): the least time the card could take for one
    flash attention call on these inputs.  Operations: 2·D multiply-adds
    for QKᵀ and for PV on every (query, key) pair the masks leave visible;
    bytes: q, k, v read once and the output written once."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    pairs = int(attention_mask(Sq, Sk, causal, window).sum())
    flops = 4.0 * D * pairs * B * H
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()   # q+o, k+v
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on a card", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    log(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return torch.cuda.get_device_name(0)


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = _build.build("flash_attention")
    log(f"build: flash_attention.cu in {time.perf_counter() - t0:.2f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def _compare(got, want, tol):
    """(max abs error, count of elements outside ``atol = rtol = tol``)."""
    err = (got.float() - want.float()).abs()
    bad = int((err > tol + tol * want.float().abs()).sum())
    return err.max().item(), bad


def _qkv(B, Sq, Sk, H, KV, D, dtype, device, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    return (torch.randn((B, Sq, H, D), generator=g, device=device).to(dtype),
            torch.randn((B, Sk, KV, D), generator=g, device=device).to(dtype),
            torch.randn((B, Sk, KV, D), generator=g, device=device).to(dtype))


def phase_kernels(device) -> dict:
    """Each case in f32 and bf16, kernel against plain; returns the entry
    for the kernels line (launches filled in after the main path)."""
    entry = {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:110"}
    for label, B, Sq, Sk, H, KV, D, causal, window in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _qkv(B, Sq, Sk, H, KV, D, dtype, device)
            got = FA.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window)
            torch.cuda.synchronize()
            want = FA.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            if got.dtype != dtype or got.shape != q.shape:
                raise AssertionError(f"{label}: got {got.dtype} "
                                     f"{tuple(got.shape)}")
            err, bad = _compare(got, want, TOL[dtype])
            log(f"kernel {label} {str(dtype)[6:]}: max_abs_err={err:.3e} "
                f"(tol {TOL[dtype]:g}) bad={bad}")
            if bad or not torch.isfinite(got.float()).all():
                raise AssertionError(f"flash kernel disagrees with its "
                                     f"plain version on {label} {dtype}")
            if label == "main_path" and dtype == torch.bfloat16:
                entry["max_abs_err"] = err

    _, B, Sq, Sk, H, KV, D, causal, window = CASES[0]
    q, k, v = _qkv(B, Sq, Sk, H, KV, D, torch.bfloat16, device)
    kw = dict(causal=causal, window=window)
    entry["ms"] = time_ms(lambda: FA.flash_attention_cuda(q, k, v, **kw))
    entry["plain_ms"] = time_ms(lambda: FA.flash_attention_plain(q, k, v, **kw))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    entry["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True))
    entry["bound_ms"], entry["bound_by"] = flash_bound(q, k, **kw)
    log(f"flash main-path shape bf16: kernel {entry['ms']:.4f} ms, plain "
        f"{entry['plain_ms']:.4f} ms, sdpa {entry['library_ms']:.4f} ms, "
        f"bound {entry['bound_ms']:.4f} ms ({entry['bound_by']})")
    return entry


def phase_main_path(device, entry: dict) -> None:
    s = SERVE
    job = ServeJob(arch=s["arch"], reduced=s["reduced"], batch=s["batch"],
                   prompt_len=s["prompt_len"],
                   arch_overrides=(("use_flash_attention", True),))
    spec = ExperimentSpec(objective=job, T=s["T"], seed=s["seed"])
    cfg = job.make_arch()
    torch.cuda.reset_peak_memory_stats()

    FA.launches = 0
    res = run(spec, device=device)
    entry["launches"] = FA.launches

    log(f"main path: {cfg.name} L={cfg.n_layers} d={cfg.d_model} "
        f"vocab={cfg.vocab} batch={s['batch']} prompt={s['prompt_len']} "
        f"T={s['T']}: flash launches {entry['launches']}, prefill "
        f"{res.extra['prefill_seconds'] * 1e3:.1f} ms (first call), decode "
        f"{res.extra['tok_per_s']:.1f} tok/s over {s['T'] - 1} steps, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if entry["launches"] != cfg.n_layers or \
            res.extra["flash_launches"] != cfg.n_layers:
        raise AssertionError(f"flash kernel launched {entry['launches']} "
                             f"times, want one per layer ({cfg.n_layers})")
    if not res.extra["logits_finite"]:
        raise AssertionError("non-finite logits on the main path")
    x = res.x
    if x.shape != (s["batch"], s["T"]) or x.dtype.kind != "i" or \
            x.min() < 0 or x.max() >= cfg.vocab:
        raise AssertionError(f"bad token matrix {x.dtype} {x.shape}")

    params = init_params(cfg, s["seed"], device)
    tokens = torch.as_tensor(res.extra["prompts"], dtype=torch.int64,
                             device=device)
    ctx = s["prompt_len"] + s["T"]
    logits = {}
    for flash in (True, False):
        c = cfg.with_(use_flash_attention=flash)
        logits[flash], _ = prefill(c, params, {"tokens": tokens}, ctx_len=ctx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(c, params, {"tokens": tokens}, ctx_len=ctx)
        torch.cuda.synchronize()
        log(f"prefill (warm, flash={flash}): "
            f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    a, b = logits[True].float(), logits[False].float()
    err, bad = _compare(a, b, TOL[torch.bfloat16])
    log(f"prefill last-token logits, flash vs plain attention: max_abs_err "
        f"{err:.3e} (|logit| max {b.abs().max().item():.3f}, tol "
        f"{TOL[torch.bfloat16]:g}) bad={bad}; argmax agree "
        f"{int((a.argmax(-1) == b.argmax(-1)).sum())}/{a.shape[0]}")
    if bad or not torch.isfinite(a).all():
        raise AssertionError("flash and plain prefill logits disagree")


def main() -> None:
    kind = phase_device()
    device = torch.device("cuda")
    phase_build()
    entry = phase_kernels(device)
    phase_main_path(device, entry)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: entry[k] for k in keys}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
