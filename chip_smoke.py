#!/usr/bin/env python3
"""Build and drive the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, each of which fails the run (non-zero exit, no result line):

1. device: CUDA must be present; prints the card's name and power limit
   and turns TF32 off for float32 products;
2. build: compiles every kernel source of the port from ``csrc/`` with
   ``nvcc`` for ``sm_90a``, one ``nvcc`` per source, all started together;
3. the flash kernel against its plain version, on the card: the serving
   path's prefill shape and the kernel test matrix (MHA, GQA 4:1, ragged
   MQA, D = 128, windows, non-causal, an empty-row case) plus the edges of
   the bf16 route's 64-row tiles (Sq 1000, H/KV 7, window 100, ragged
   non-causal Sk > Sq, q tiles that visit no key tile) and the head dims
   16, 48, 80, 96 and 112 (zamba2-7b's), in f32 (CUDA-core route) and bf16
   (tensor-core route) at the kernel suite's tolerances; at the main-path
   shape the kernel, its plain version and ``scaled_dot_product_attention``
   (a yardstick only: the port never calls it) are timed on the device
   (CUDA graph replay, :func:`device_ms`), and the kernel's eager calls
   too; so are the three at D = 112 on zamba2-7b's attention (4 × 1024,
   32 heads);
4. the serving main path at full width: ``run(ExperimentSpec(objective=
   ServeJob(arch="qwen2-0.5b", reduced=False, batch=4, prompt_len=1024,
   ...)))`` with the flash kernel on, which must launch it once per layer
   and hand it bf16 q/k/v (its tensor-core route); then prefill again on the
   same params with and without the kernel, whose last-token logits must
   agree to bf16 tolerance;
5. the six update kernels against their plain versions, on the card:
   sizes 1, 127, 128·256, 128·256 + 1, 1,000,003 and the 14 leaf sizes of
   qwen2-0.5b, f32 and bf16 params, count 1 and 7, weight decay 0 and 0.1,
   at the tolerances of ``tests/test_kernels.py``, with gbuf′ equal to g
   bit for bit; then over one round's 14 leaves the kernels, their plain
   versions and a yardstick the port never calls (``torch._foreach_add_``,
   ``torch.optim.SGD(momentum=0.9, fused=True)``,
   ``torch.optim.Adam(fused=True)``) are timed with CUDA events;
6. the training main path at full width: ``run(ExperimentSpec(objective=
   TrainJob(arch="qwen2-0.5b", reduced=False, global_batch=8, seq_len=512,
   update_impl="pallas"), n_workers=4, T=8, runtime="scan",
   rounds_per_launch=4, ...))``, which must launch ``fused_adam_delayed``
   8 × 14 times, give finite curves, and match the loss curve of the same
   spec under ``update_impl="reference"`` to rtol 5e-3; then a warm timed
   run of the same spec;
7. the other three update kernels' paths, at full width and 2 layers, T 2:
   sgd delayed (``async_update``), sgd synchronous (``sgd_step``) and adam
   synchronous (``fused_adam``), each launching its kernel rounds × 14 times;
8. the two heavy-ball paths at the same size: ``AsyncTrainer`` with
   ``OptConfig(name="sgd", momentum=0.9, clip_norm=1.0,
   update_impl="pallas")`` driven by the plan executor at delay 1
   (``sgd_momentum_delayed``) and delay 0 (``sgd_momentum_step``), each
   launching its kernel rounds × 14 times, with a loss curve within 5e-3 of
   ``update_impl="reference"`` (``TrainJob`` has no momentum field);
9. the SSD chunk kernel against its plain version, on the card: the case
   matrix of ``tests/test_kernels.py``, the serving shape of mamba2-370m
   (x (4, 8, 128, 32, 64), B/C (4, 8, 128, 128)) and the edges of the bf16
   route's head groups and tiles (one cell, H = 6, c 32 and 128 with
   N = 64, c 16 with N = 128), f32 (CUDA-core route) and bf16 (tensor-core
   route), at that file's tolerances (1e-3, 4e-2); at the serving shape
   the kernel and its plain version are timed on the device as in phase 3
   (no single PyTorch call computes this function);
10. the SSM serving main path at full width: ``run(ExperimentSpec(
    objective=ServeJob(arch="mamba2-370m", reduced=False, batch=4,
    prompt_len=1024, arch_overrides=(("use_ssd_kernel", True),)),
    T=32))``, which must launch the SSD kernel once per layer (48) and
    hand it bf16 x, B and C (its tensor-core route); then prefill again on
    the same params: through the kernel and through its plain version in
    the same branch, whose last-token logits must agree to bf16 tolerance;
    the gap to the einsum branch (``use_ssd_kernel=False``),
    gated at 2 layers as the JAX suite gates it and reported at 48; warm
    prefill and decode times;
11. the guards: the flash and SSD kernels' CUDA routes raise for an input
    that requires grad, where they would otherwise drop the gradient;
12. the slot lane (continuous batching), at full width in bf16:
    ``run(ExperimentSpec(objective=ServeJob(n_slots=8, ...)))`` on
    qwen2-0.5b (32 requests, prompts of 512, T = 64, ``poisson:gap=2``
    arrivals, ``pure`` admission, 8 decode steps per captured chunk; flash
    on) and mamba2-370m (16 requests, T = 32; the SSD kernel on): every
    request served once with T tokens in the vocabulary, the prefill kernel
    launched requests × layers times on its tensor-core route, one tap row
    per decode step; then the same serve on one ``SlotServer`` (its tokens
    equal ``run``'s), timed warm (wall, tokens/s, the chunk replays' device
    time per decode step from CUDA events, host waits per chunk, occupancy,
    mean TTFT, peak memory), once under ``torch.profiler`` (the device
    idle share over the serve), qwen2-0.5b again with ``fedbuff:b=2``
    admission on the same server (one chunk capture after every serve),
    and with ``capture=False``, whose tokens must equal the graph route's
    bit for bit; then the slot lane against the lock-step lane through
    ``run`` at full width and 2 layers in f32 with TF32 off, 4 requests in
    4 slots: equal token matrices (a difference fails, naming the first
    diverging (request, step)); prints a ``{"slot_lane": [...], ...}``
    line;
13. the theory tier (no kernel of its own: its steps are torch ops replayed
    as CUDA graph chunks): the paper's Fig. 1 cell — the w7a stand-in
    (n = 10, m = 2505, d = 300), ``LogRegProblem(lam=0.1)``, the paper's
    7-γ grid, T = 3000 — through ``run(ExperimentSpec(...))`` for
    ``pure``, ``random`` and ``shuffled`` under ``fixed:slow=8`` and
    ``poisson:slow=8``, each with one host sync and finite grad norms; the
    chosen γ's trajectory bit-identical to a solo ``replay``, and the graph
    route bit-identical to the eager loop (``capture=False``) at T = 3000;
    the card against ``device="cpu"`` at T = 300 for the full-gradient and
    the stochastic lane (shared mini-batch table), x and grad norms within
    rtol 1e-4 / atol 1e-6; the Fig. 2 stochastic cell (Syn(1, 1), m = 200,
    batch 20, ``poisson:slow=8``, T = 3000) for the three schedulers; one
    scenario world (``straggler:k=2,factor=8,every=16,span=4``), whose
    schedule equals a separate host realisation bit for bit; it prints a
    ``{"theory_tier": [...]}`` line and the paper's ordering (shuffled ≤
    1.5 × random, random ≤ pure; reported, not gated);
14. prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
    line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np                                            # noqa: E402
import torch                                                  # noqa: E402
import torch.nn.functional as F                               # noqa: E402

from repro_torch.api import (ExperimentSpec, ServeJob,        # noqa: E402
                             SimulatorBackend, TrainerBackend, TrainJob,
                             run)
from repro_torch.configs import get_arch                      # noqa: E402
from repro_torch.distributed import (AsyncConfig,             # noqa: E402
                                     AsyncTrainer, Server, ServeConfig,
                                     SlotConfig, SlotServer)
from repro_torch.kernels import _build, ops                   # noqa: E402
from repro_torch.kernels import async_update as AU            # noqa: E402
from repro_torch.kernels import flash_attention as FA         # noqa: E402
from repro_torch.kernels import ssd_chunk as SSD              # noqa: E402
from repro_torch.kernels.ref import attention_mask            # noqa: E402
from repro_torch.launch.profile_serve import (idle_share,  # noqa: E402
                                           profiled)
from repro_torch.core import replay                            # noqa: E402
from repro_torch.models import init_params, param_specs, prefill  # noqa: E402
from repro_torch.objectives import (LogRegProblem,            # noqa: E402
                                    make_libsvm_like, make_synthetic)
from repro_torch.optim import OptConfig                       # noqa: E402
from repro_torch.runtime import compile_plan, execute         # noqa: E402
from repro_torch.scenarios import parse_scenario, realise_world  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map            # noqa: E402

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
    ("sq1000", 1, 1000, 1000, 2, 2, 64, True, None),
    ("gqa7", 2, 192, 192, 7, 1, 64, True, None),
    ("window100", 1, 512, 512, 4, 4, 64, True, 100),
    ("noncausal_ragged", 2, 200, 300, 4, 2, 64, False, None),
    ("empty_tiles", 1, 256, 32, 2, 2, 64, False, 16),
    ("empty_tiles_causal", 1, 512, 64, 2, 2, 64, True, 100),
    # every head dim beyond 32/64/128 that the kernel is built for
    ("d16", 1, 256, 256, 4, 2, 16, True, None),
    ("d48", 1, 256, 256, 4, 2, 48, True, 64),
    ("d80", 2, 200, 200, 4, 2, 80, True, None),
    ("d80_noncausal", 1, 130, 190, 2, 1, 80, False, None),
    ("d96", 1, 256, 256, 4, 4, 96, True, None),
    ("d112", 2, 200, 200, 4, 2, 112, True, None),
    ("d112_window", 1, 512, 512, 4, 4, 112, True, 100),
    # the slot lane's batch-1 prefill on qwen2-0.5b (one admission)
    ("slot_prefill", 1, 512, 512, 14, 2, 64, True, None),
]
#: the shared attention block of zamba2-7b (32 heads of 112) at the serving
#: path's prefill size: flash at D = 112, timed
D112_SHAPE = ("d112_zamba2", 4, 1024, 1024, 32, 32, 112, True, None)
SERVE = dict(arch="qwen2-0.5b", reduced=False, batch=4, prompt_len=1024,
             T=32, seed=0)

SOURCES = ("flash_attention", "async_update", "ssd_chunk")

#: update kernels: the sizes of the test matrix (the main path's 14 leaf
#: sizes are added), tolerances of tests/test_kernels.py as (rtol, atol)
UPDATE_SIZES = (1, 127, 128 * 256, 128 * 256 + 1, 1_000_003)
UPDATE_TOL = {"sgd": {torch.float32: (2e-4, 2e-4),
                      torch.bfloat16: (3e-2, 3e-2)},
              "adam": {torch.float32: (1e-5, 1e-6),
                       torch.bfloat16: (3e-2, 3e-2)}}
#: f32 operations per element of each update kernel (its Pallas body)
UPDATE_OPS = {"async_update": 2, "sgd_step": 2, "sgd_momentum_step": 4,
              "sgd_momentum_delayed": 4, "fused_adam": 18,
              "fused_adam_delayed": 18}
UPDATE_LR = {"sgd": 0.01, "adam": 1e-3}
#: the TPU kernel each update kernel replaces
REPLACES = {"async_update": "src/repro/kernels/async_update.py:71",
            "sgd_step": "src/repro/kernels/async_update.py:114",
            "sgd_momentum_step": "src/repro/kernels/async_update.py:152",
            "sgd_momentum_delayed": "src/repro/kernels/async_update.py:206",
            "fused_adam": "src/repro/kernels/async_update.py:276",
            "fused_adam_delayed": "src/repro/kernels/async_update.py:348"}
CLIP, DELAY_SCALE, MOMENTUM = 0.5, 0.25, 0.9

#: the training main path and the reduced-depth paths of the other kernels
TRAIN_JOB = dict(arch="qwen2-0.5b", reduced=False, global_batch=8,
                 seq_len=512, update_impl="pallas")
TRAIN_SPEC = dict(scheduler="pure", timing="fixed:slow=5", n_workers=4, T=8,
                  stepsize=3e-4, seed=0, runtime="scan", rounds_per_launch=4)
OTHER_PATHS = (("async_update", "sgd", 1), ("sgd_step", "sgd", 0),
               ("fused_adam", "adam", 0))
#: the heavy-ball paths: (kernel, delay_rounds)
MOMENTUM_PATHS = (("sgd_momentum_delayed", 1), ("sgd_momentum_step", 0))

#: the SSD chunk kernel: (label, B, nc, c, H, P, N), the serving shape of
#: mamba2-370m first (timed too), then the kernel test matrix; tolerances
#: of tests/test_kernels.py
SSD_CASES = [("main_path", 4, 8, 128, 32, 64, 128),
             ("c16", 1, 1, 16, 2, 32, 16), ("c64", 1, 1, 64, 4, 64, 32),
             ("g1", 1, 1, 128, 8, 64, 128), ("h6", 1, 2, 64, 6, 64, 64),
             ("c32_n64", 2, 2, 32, 8, 64, 64),
             ("c128_n64", 2, 2, 128, 8, 64, 64),
             ("c16_n128", 1, 2, 16, 4, 64, 128),
             # the slot lane's batch-1 prefill on mamba2-370m (one admission)
             ("slot_prefill", 1, 4, 128, 32, 64, 128)]
SSD_TOL = {torch.float32: 1e-3, torch.bfloat16: 4e-2}
SSM_SERVE = dict(arch="mamba2-370m", reduced=False, batch=4, prompt_len=1024,
                 T=32, seed=0)

#: the theory tier: the paper's stepsize grid (App. A.1), the Fig. 1 and
#: Fig. 2 cells, and the card-against-CPU tolerance on x and grad norms
PAPER_GRID = (0.005, 0.004, 0.003, 0.002, 0.001, 0.0005, 0.0001)
THEORY_SCHEDULERS = ("pure", "random", "shuffled")
THEORY_TIMINGS = ("fixed:slow=8", "poisson:slow=8")
THEORY_T, THEORY_CPU_T = 3000, 300
THEORY_TOL = dict(rtol=1e-4, atol=1e-6)
THEORY_SCENARIO = "straggler:k=2,factor=8,every=16,span=4"


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


@contextlib.contextmanager
def _dtypes_seen(module, name):
    """Collects, while it is open, the dtypes of the tensors each call of
    ``module.<name>`` receives (as a set of tuples)."""
    fn, seen = getattr(module, name), set()

    @functools.wraps(fn)
    def recording(*args, **kw):
        seen.add(tuple(str(a.dtype)[6:] for a in args
                       if isinstance(a, torch.Tensor)))
        return fn(*args, **kw)

    setattr(module, name, recording)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph, replayed back to back and timed with CUDA events, so what the
    host spends issuing a call (a wrapper's checks, ``ctypes``) drops out.
    Kernels of tens of microseconds sit below their wrappers' host cost, so
    :func:`time_ms` over eager calls would time the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = time_ms(graph.replay, iters=5, warmup=1) / iters
    del graph
    torch.cuda.empty_cache()
    return ms


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
    """One nvcc per source, all started together."""
    def build(name):
        t0 = time.perf_counter()
        return _build.build(name), time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = dict(zip(SOURCES, pool.map(build, SOURCES)))
    log(f"build: {len(SOURCES)} sources in {time.perf_counter() - t0:.2f} s")
    for name, (lib, secs) in built.items():
        log(f"  {name}.cu in {secs:.2f} s")
        for kernel, regs, spill in _ptxas_report(lib.with_suffix(".log")):
            log(f"  ptxas: {kernel}: {regs} registers; {spill}")


def _ptxas_report(path):
    """[(kernel, registers, spill line)] from ptxas's ``-v`` report."""
    rows, kernel, spill = [], "", ""
    for line in path.read_text().splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            kernel = m.group(1)
        elif "spill" in line:
            spill = line.split(":")[-1].strip()
        elif m := re.search(r"Used (\d+) registers", line):
            rows.append((kernel, int(m.group(1)), spill))
    return rows


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
    kernel = lambda: FA.flash_attention_cuda(q, k, v, **kw)
    entry["ms"] = device_ms(kernel)
    eager = time_ms(kernel)
    entry["plain_ms"] = device_ms(lambda: FA.flash_attention_plain(q, k, v, **kw),
                                  iters=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    entry["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True))
    entry["bound_ms"], entry["bound_by"] = flash_bound(q, k, **kw)
    log(f"flash main-path shape bf16 ({FA.route(q.dtype)} route): device "
        f"time per call: kernel "
        f"{entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, sdpa "
        f"{entry['library_ms']:.4f} ms ({entry['ms'] / entry['library_ms']:.2f}x "
        f"sdpa), bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}); eager "
        f"calls back to back {eager:.4f} ms each")

    label, B, Sq, Sk, H, KV, D, causal, window = D112_SHAPE
    q, k, v = _qkv(B, Sq, Sk, H, KV, D, torch.bfloat16, device)
    kw = dict(causal=causal, window=window)
    ms = device_ms(lambda: FA.flash_attention_cuda(q, k, v, **kw))
    plain = device_ms(lambda: FA.flash_attention_plain(q, k, v, **kw), iters=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True))
    bound, by = flash_bound(q, k, **kw)
    log(f"flash {label} q {tuple(q.shape)} k/v {tuple(k.shape)} bf16: device "
        f"time per call: kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa "
        f"{sdpa:.4f} ms ({ms / sdpa:.2f}x sdpa), bound {bound:.4f} ms ({by})")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
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
    with _dtypes_seen(FA, "flash_attention_cuda") as seen:
        res = run(spec, device=device)
    entry["launches"] = FA.launches
    routes = sorted({FA.route(getattr(torch, d[0])) for d in seen})
    log(f"main path hands the flash kernel q/k/v of dtypes {sorted(seen)}: "
        f"route {routes}")
    if routes != ["tensor_cores"]:
        raise AssertionError(f"main path took the flash routes {routes}, "
                             f"want the tensor cores'")

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
    # prefill below runs outside torch.no_grad(): the flash kernel's guard
    # stays quiet only because no param requires grad
    if any(p.requires_grad for p in tree_leaves(params)):
        raise AssertionError("init_params returned params that require grad")
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


def _update_inputs(n, dtype, device, seed=0):
    """p (dtype), m (f32 normal · 0.1), v (f32 uniform · 0.01), gbuf and g
    (dtype), as in tests/test_kernels.py."""
    gen = torch.Generator(device).manual_seed(seed)
    rn = lambda: torch.randn(n, generator=gen, device=device)
    return {"p": rn().to(dtype), "m": rn() * 0.1,
            "v": torch.rand(n, generator=gen, device=device) * 0.01,
            "gb": rn().to(dtype), "g": rn().to(dtype)}


def _kind(name):
    return "adam" if "adam" in name else "sgd"


def _scalar_sets(name, device):
    """[(label, scal)]: SGD one eff; heavy ball one [lr_eff, clip]; Adam
    count ∈ {1, 7} × wd ∈ {0, 0.1}."""
    lr = UPDATE_LR[_kind(name)]
    if "momentum" in name:
        return [("", AU.momentum_scalars(lr, CLIP, DELAY_SCALE, device))]
    if _kind(name) == "sgd":
        return [("", AU.sgd_scalars(lr, CLIP, DELAY_SCALE, device))]
    out = []
    for count in (1, 7):
        c = torch.tensor(count, dtype=torch.int32, device=device)
        bc1, bc2 = AU.adam_bias_corrections(0.9, 0.95, c)
        for wd in (0.0, 0.1):
            out.append((f" count={count} wd={wd}",
                        AU.adam_scalars(lr, bc1, bc2, CLIP, wd, device)))
    return out


def _apply(name, route, t, scal):
    """Run ``AU.<name>_<route>`` in place on the operands of ``t``."""
    fn = getattr(AU, f"{name}_{route}")
    if name == "async_update":
        fn(t["p"], t["gb"], t["g"], scal)
    elif name == "sgd_step":
        fn(t["p"], t["g"], scal)
    elif name == "sgd_momentum_step":
        fn(t["p"], t["m"], t["g"], scal, momentum=MOMENTUM)
    elif name == "sgd_momentum_delayed":
        fn(t["p"], t["m"], t["gb"], t["g"], scal, momentum=MOMENTUM)
    elif name == "fused_adam":
        fn(t["p"], t["m"], t["v"], t["g"], scal)
    else:
        fn(t["p"], t["m"], t["v"], t["gb"], t["g"], scal)
    return t


def _main_leaves():
    """The numels of qwen2-0.5b's 14 param leaves, in tree order."""
    return [int(np.prod(s.shape)) for s in
            tree_leaves(param_specs(get_arch(SERVE["arch"])))]


def _delayed(name):
    """Whether the kernel swaps the buffer (gbuf′ = g)."""
    return name in ("async_update", "sgd_momentum_delayed",
                    "fused_adam_delayed")


def _state_keys(name):
    """The float state each kernel writes besides the buffer."""
    if _kind(name) == "adam":
        return ("p", "m", "v")
    return ("p", "m") if "momentum" in name else ("p",)


def _bytes_per_elem(name, pdt, gdt):
    """Bytes one element moves: each input read once, each output written
    once (p r/w; m and v f32 r/w; gbuf r/w; g read)."""
    p, g = pdt.itemsize, gdt.itemsize
    moments = 8 * (len(_state_keys(name)) - 1)
    buf = 2 * g if _delayed(name) else 0
    return 2 * p + moments + buf + g


def phase_update_kernels(device) -> dict:
    """The six kernels against their plain versions over the matrix, then
    timed over one round's 14 leaves; returns the kernels-line entries."""
    entries = {name: {"name": name, "route": "cuda",
                      "source": "src/repro_torch/csrc/async_update.cu",
                      "replaces": REPLACES[name], "max_abs_err": 0.0}
               for name in AU.KERNELS}
    leaves = _main_leaves()
    checked = 0
    for n in UPDATE_SIZES + tuple(leaves):
        for dtype in (torch.float32, torch.bfloat16):
            base = _update_inputs(n, dtype, device, seed=n % 9973)
            for name in AU.KERNELS:
                rtol, atol = UPDATE_TOL[_kind(name)][dtype]
                for label, scal in _scalar_sets(name, device):
                    got = _apply(name, "cuda", tree_map(torch.clone, base),
                                 scal)
                    torch.cuda.synchronize()
                    want = _apply(name, "plain",
                                  tree_map(torch.clone, base), scal)
                    worst = 0.0
                    for key in _state_keys(name):
                        a, b = got[key].float(), want[key].float()
                        err = (a - b).abs()
                        bad = int((err > atol + rtol * b.abs()).sum())
                        if bad or not torch.isfinite(a).all():
                            raise AssertionError(
                                f"{name} {key} disagrees with its plain "
                                f"version at n={n} {dtype}{label}: {bad} "
                                f"elements, max abs err {err.max().item():.3e}")
                        worst = max(worst, err.max().item())
                    if _delayed(name) and not (
                            torch.equal(got["gb"], base["g"])
                            and torch.equal(want["gb"], base["g"])):
                        raise AssertionError(f"{name}: gbuf' != g bitwise at "
                                             f"n={n} {dtype}{label}")
                    if got["p"].dtype != dtype:
                        raise AssertionError(f"{name}: p dtype {got['p'].dtype}")
                    if n in leaves and dtype == torch.bfloat16:
                        e = entries[name]
                        e["max_abs_err"] = max(e["max_abs_err"], worst)
                    checked += 1
            del base
    log(f"update kernels: {checked} cases against their plain versions, all "
        f"within tolerance, gbuf' bitwise; max abs err on the main-path "
        f"leaves in bf16: " + ", ".join(
            f"{k} {e['max_abs_err']:.3e}" for k, e in entries.items()))

    # one round over the 14 main-path leaves: bf16 p / gbuf / g, f32 m / v
    bf16 = torch.bfloat16
    state = [_update_inputs(n, bf16, device, seed=i)
             for i, n in enumerate(leaves)]
    n_total = sum(leaves)
    for name in AU.KERNELS:
        scal = _scalar_sets(name, device)[-1][1]
        e = entries[name]
        e["ms"] = time_ms(lambda: [_apply(name, "cuda", t, scal)
                                   for t in state], iters=10)
        e["plain_ms"] = time_ms(lambda: [_apply(name, "plain", t, scal)
                                         for t in state], iters=5)
        e["library_ms"] = _update_library_ms(name, state)
        t_bytes = n_total * _bytes_per_elem(name, bf16, bf16) / PEAK_BYTES * 1e3
        t_ops = n_total * UPDATE_OPS[name] / PEAK_FLOPS[torch.float32] * 1e3
        e["bound_ms"], e["bound_by"] = ((t_ops, "operations") if t_ops > t_bytes
                                        else (t_bytes, "bytes"))
        log(f"{name} over one round ({n_total:,} elements, {len(leaves)} "
            f"leaves): "
            f"kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, library "
            f"{e['library_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']})")
    del state
    torch.cuda.empty_cache()
    return entries


def _update_library_ms(name, state):
    """One PyTorch call over the round, a yardstick the port never calls:
    ``torch._foreach_add_`` for the SGD kernels (p −= eff·buffer; for
    async_update it leaves out the buffer swap),
    ``torch.optim.SGD(momentum=0.9, fused=True)`` for the heavy-ball
    kernels and ``torch.optim.Adam(fused=True)`` for the Adam kernels.  The
    fused optimizers keep their buffers in the params' dtype, so they cannot
    take bf16 params with f32 buffers: they run on f32 copies of p and g
    (no clip, no swap)."""
    if "momentum" in name:
        params = [torch.nn.Parameter(t["p"].float()) for t in state]
        for prm, t in zip(params, state):
            prm.grad = t["g"].float()
        opt = torch.optim.SGD(params, lr=UPDATE_LR["sgd"], momentum=MOMENTUM,
                              fused=True)
        log(f"  {name} library yardstick: torch.optim.SGD(momentum="
            f"{MOMENTUM}, fused=True) in f32 (it keeps the momentum in the "
            "params' dtype)")
        ms = time_ms(opt.step, iters=10)
        del opt, params
        torch.cuda.empty_cache()
        return ms
    if _kind(name) == "sgd":
        ps = [t["p"] for t in state]
        gs = [t["gb" if name == "async_update" else "g"] for t in state]
        eff = UPDATE_LR["sgd"] * CLIP * DELAY_SCALE
        return time_ms(lambda: torch._foreach_add_(ps, gs, alpha=-eff),
                       iters=10)
    params = [torch.nn.Parameter(t["p"].float()) for t in state]
    for prm, t in zip(params, state):
        prm.grad = t["g"].float()
    opt = torch.optim.Adam(params, lr=UPDATE_LR["adam"], betas=(0.9, 0.95),
                           eps=1e-8, fused=True)
    log(f"  {name} library yardstick: torch.optim.Adam(fused=True) in f32 "
        "(it keeps moments in the params' dtype, so bf16 params with f32 "
        "moments are not expressible)")
    ms = time_ms(opt.step, iters=10)
    del opt, params
    torch.cuda.empty_cache()
    return ms


def _train_spec(T=None, **job_kw):
    job = TrainJob(**{**TRAIN_JOB, **job_kw})
    return ExperimentSpec(objective=job, **{**TRAIN_SPEC, "T": T or
                                            TRAIN_SPEC["T"]})


def _check_curves(res, label):
    if res.losses is None or not (np.isfinite(res.losses).all()
                                  and np.isfinite(res.grad_norms).all()):
        raise AssertionError(f"{label}: non-finite or missing curves")


def phase_train_main(device, entry: dict) -> None:
    """The training main path, its reference twin and a warm timed run."""
    spec = _train_spec()
    cfg = spec.objective.make_arch()
    rounds = spec.T
    torch.cuda.reset_peak_memory_stats()
    AU.reset_launches()
    t0 = time.perf_counter()
    res = run(spec, device=device)
    secs = time.perf_counter() - t0
    launched = dict(AU.launches)
    entry["launches"] = launched["fused_adam_delayed"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_leaves = len(tree_leaves(res.x["params"]))
    want = {k: 0 for k in AU.KERNELS}
    want["fused_adam_delayed"] = rounds * n_leaves
    if launched != want or res.extra["update_launches"] != want:
        raise AssertionError(f"update launches {launched} (extra "
                             f"{res.extra['update_launches']}), want {want}")
    _check_curves(res, "training main path")
    log(f"train main path: {cfg.name} L={cfg.n_layers} d={cfg.d_model} "
        f"vocab={cfg.vocab} batch={TRAIN_JOB['global_batch']} "
        f"seq={TRAIN_JOB['seq_len']} T={rounds} (first call, {secs:.2f} s): "
        f"fused_adam_delayed launches {entry['launches']} = {rounds} rounds "
        f"x {n_leaves} leaves; loss {res.losses[0]:.5f} -> "
        f"{res.losses[-1]:.5f}; grad_norm {res.grad_norms[-1]:.4f}; "
        f"launches {res.extra['launches']} host_syncs "
        f"{res.extra['host_syncs']}; peak memory {peak:.2f} GiB")
    losses = res.losses
    res = None
    torch.cuda.empty_cache()

    base = init_params(cfg, TRAIN_SPEC["seed"], device)
    same_init = lambda cfg, dev: tree_map(torch.clone, base)
    ref_spec = dataclasses.replace(spec, objective=dataclasses.replace(
        spec.objective, update_impl="reference"))
    ref = TrainerBackend(device, params_fn=same_init).run(ref_spec)
    _check_curves(ref, "reference run")
    rel = np.abs(losses - ref.losses) / np.abs(ref.losses)
    log(f"loss curve, pallas vs reference: max rel diff {rel.max():.3e} "
        f"(rtol 5e-3); reference {ref.losses[0]:.5f} -> {ref.losses[-1]:.5f}")
    if not (rel <= 5e-3).all():
        raise AssertionError("pallas and reference loss curves disagree")
    ref = None
    torch.cuda.empty_cache()

    stamps = {}
    timed = TrainerBackend(device, params_fn=same_init, on_step=lambda i, s, m:
                           stamps.setdefault(i, time.perf_counter()))
    timed.run(spec)
    k = TRAIN_SPEC["rounds_per_launch"]
    warm = (stamps[2 * k - 1] - stamps[k - 1]) / k * 1e3
    log(f"train main path warm: {warm:.3f} ms per round (host clock over "
        f"rounds {k}..{2 * k - 1}, chunk-boundary reads)")


def phase_train_others(device, entries: dict) -> None:
    """sgd delayed / sgd sync / adam sync at full width and 2 layers."""
    T = 2
    for name, opt, delay in OTHER_PATHS:
        spec = _train_spec(T=T, opt=opt, delay_rounds=delay,
                           arch_overrides=(("n_layers", 2),))
        AU.reset_launches()
        res = run(spec, device=device)
        launched = dict(AU.launches)
        n_leaves = len(tree_leaves(res.x["params"]))
        want = {k: 0 for k in AU.KERNELS}
        want[name] = T * n_leaves
        if launched != want or res.extra["update_launches"] != want:
            raise AssertionError(f"{name} path: launches {launched}, want "
                                 f"{want}")
        _check_curves(res, f"{name} path")
        entries[name]["launches"] = launched[name]
        log(f"{name} path (opt={opt}, delay_rounds={delay}, 2 layers, T={T}):"
            f" {launched[name]} launches; loss {res.losses[0]:.5f} -> "
            f"{res.losses[-1]:.5f}")
        res = None
        torch.cuda.empty_cache()


def _momentum_spec(delay):
    """The heavy-ball paths' spec: the training job at 2 layers, T 2."""
    job = TrainJob(**{**TRAIN_JOB, "opt": "sgd", "delay_rounds": delay,
                      "arch_overrides": (("n_layers", 2),)})
    return ExperimentSpec(objective=job, **{**TRAIN_SPEC, "T": 2})


def _momentum_curve(device, delay, impl, base):
    """Heavy-ball SGD through ``AsyncTrainer`` and the plan executor (the
    JAX package's entry point for it: ``TrainJob`` has no momentum field)
    from the params ``base``; returns the loss curve."""
    spec = _momentum_spec(delay)
    job = spec.objective
    groups = spec.n_workers
    cfg = job.make_arch()
    tr = AsyncTrainer(cfg, opt=OptConfig(name="sgd", lr=spec.stepsize.gamma,
                                         momentum=MOMENTUM, clip_norm=1.0,
                                         update_impl=impl),
                      async_cfg=AsyncConfig(delay_rounds=delay), device=device)
    tr.n_groups = groups
    _, schedule = TrainerBackend.masks_for(spec, groups)
    plan = compile_plan(schedule, job, rounds=spec.T, n_groups=groups,
                        seed=spec.seed)
    state = tr.init_state(params=tree_map(torch.clone, base))
    res = execute(tr, plan, state, runtime="scan",
                  rounds_per_launch=spec.rounds_per_launch)
    return np.asarray(res.metrics["loss"], np.float64)


def phase_momentum_paths(device, entries: dict) -> None:
    """The two heavy-ball kernels' paths, each against the reference."""
    base = init_params(_momentum_spec(0).objective.make_arch(),
                       TRAIN_SPEC["seed"], device)
    n_leaves = len(tree_leaves(base))
    for name, delay in MOMENTUM_PATHS:
        AU.reset_launches()
        losses = _momentum_curve(device, delay, "pallas", base)
        launched = dict(AU.launches)
        want = {k: 0 for k in AU.KERNELS}
        want[name] = 2 * n_leaves
        if launched != want:
            raise AssertionError(f"{name} path: launches {launched}, want "
                                 f"{want}")
        ref = _momentum_curve(device, delay, "reference", base)
        rel = np.abs(losses - ref) / np.abs(ref)
        if not (np.isfinite(losses).all() and (rel <= 5e-3).all()):
            raise AssertionError(f"{name} path: loss {losses} against the "
                                 f"reference {ref}")
        entries[name]["launches"] = launched[name]
        log(f"{name} path (sgd momentum={MOMENTUM}, delay_rounds={delay}, 2 "
            f"layers, T=2): {launched[name]} launches; loss {losses[0]:.5f} "
            f"-> {losses[-1]:.5f}; max rel diff to the reference "
            f"{rel.max():.3e} (rtol 5e-3)")
    del base
    torch.cuda.empty_cache()


def _ssd_inputs(B, nc, c, H, P, N, dtype, device, seed=3):
    """x · 0.5, dt ∈ [0.01, 0.2], A ∈ −[0.5, 2], B/C · 0.3 (B and C in x's
    dtype, as the model hands them over), as in tests/test_kernels.py."""
    g = torch.Generator(device).manual_seed(seed)
    u = lambda shape, lo, hi: torch.rand(shape, generator=g,
                                         device=device) * (hi - lo) + lo
    rn = lambda shape: torch.randn(shape, generator=g, device=device)
    return ((rn((B, nc, c, H, P)) * 0.5).to(dtype), u((B, nc, c, H), 0.01, 0.2),
            -u((H,), 0.5, 2.0), (rn((B, nc, c, N)) * 0.3).to(dtype),
            (rn((B, nc, c, N)) * 0.3).to(dtype))


def ssd_bound(x, B_):
    """(bound_ms, bound_by) of one SSD chunk call: bytes of x, dt, A, B, C
    read once and y, states written once; operations 2·c·c·N (C Bᵀ) +
    2·c·c·P (scores · x·dt) + 2·c·N·P (the state) per (batch·chunk, head)
    cell, as the TPU kernel computes them, at the bf16 tensor-core peak."""
    Bb, nc, c, H, P = x.shape
    N = B_.shape[-1]
    cells = Bb * nc * H
    nbytes = (2 * x.numel() * x.element_size() + Bb * nc * c * H * 4 + H * 4
              + 2 * B_.numel() * B_.element_size() + cells * N * P * 4)
    flops = 2.0 * cells * (c * c * N + c * c * P + c * N * P)
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_ssd_kernel(device) -> dict:
    """Each SSD case in f32 and bf16, kernel against plain; the serving
    shape timed.  Returns the kernels-line entry (launches filled in by the
    SSM main path)."""
    entry = {"name": "ssd_chunk", "route": "cuda",
             "source": "src/repro_torch/csrc/ssd_chunk.cu",
             "replaces": "src/repro/kernels/ssd_chunk.py:74"}
    for label, B, nc, c, H, P, N in SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = _ssd_inputs(B, nc, c, H, P, N, dtype, device)
            y, st = SSD.ssd_chunk_cuda(*args)
            torch.cuda.synchronize()
            wy, wst = SSD.ssd_chunk_plain(*args)
            if y.dtype != dtype or st.shape != (B, nc, H, N, P):
                raise AssertionError(f"ssd {label}: got {y.dtype} "
                                     f"{tuple(st.shape)}")
            tol = SSD_TOL[dtype]
            err_y, bad_y = _compare(y, wy, tol)
            err_s, bad_s = _compare(st, wst, tol)
            log(f"ssd kernel {label} {str(dtype)[6:]}: max_abs_err y "
                f"{err_y:.3e} states {err_s:.3e} (tol {tol:g}) "
                f"bad={bad_y + bad_s}")
            if bad_y or bad_s or not (torch.isfinite(y.float()).all()
                                      and torch.isfinite(st).all()):
                raise AssertionError(f"ssd kernel disagrees with its plain "
                                     f"version on {label} {dtype}")
            if label == "main_path" and dtype == torch.bfloat16:
                entry["max_abs_err"] = max(err_y, err_s)
            del args, y, st, wy, wst
    args = _ssd_inputs(*SSD_CASES[0][1:], torch.bfloat16, device)
    kernel = lambda: SSD.ssd_chunk_cuda(*args)
    entry["ms"] = device_ms(kernel)
    eager = time_ms(kernel)
    entry["plain_ms"] = device_ms(lambda: SSD.ssd_chunk_plain(*args), iters=5)
    entry["library_ms"] = None
    entry["bound_ms"], entry["bound_by"] = ssd_bound(args[0], args[3])
    log(f"ssd main-path shape bf16 ({SSD.route(args[0].dtype, args[3].dtype)} "
        f"route): device time per call: kernel {entry['ms']:.4f} ms, plain "
        f"{entry['plain_ms']:.4f} ms, no library call, bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}); eager "
        f"calls back to back {eager:.4f} ms each")
    del args
    torch.cuda.empty_cache()
    return entry


def _prefill_plain_ssd(cfg, params, tokens, ctx):
    """Last-token logits of a prefill whose ``ops.ssd_chunk`` calls go to the
    kernel's plain version: the same branch and bf16 casts as the kernel's
    prefill, on the card."""
    routed = ops.ssd_chunk
    ops.ssd_chunk = SSD.ssd_chunk_plain
    try:
        return prefill(cfg, params, {"tokens": tokens}, ctx_len=ctx)[0]
    finally:
        ops.ssd_chunk = routed


def phase_ssm_main_path(device, entry: dict) -> None:
    """mamba2-370m at full width through run(ServeJob), then prefill with
    and without the kernel, and warm times."""
    s = SSM_SERVE
    job = ServeJob(arch=s["arch"], reduced=s["reduced"], batch=s["batch"],
                   prompt_len=s["prompt_len"],
                   arch_overrides=(("use_ssd_kernel", True),))
    spec = ExperimentSpec(objective=job, T=s["T"], seed=s["seed"])
    cfg = job.make_arch()
    torch.cuda.reset_peak_memory_stats()

    SSD.launches = 0
    with _dtypes_seen(SSD, "ssd_chunk_cuda") as seen:
        res = run(spec, device=device)
    entry["launches"] = SSD.launches
    routes = sorted({SSD.route(getattr(torch, d[0]), getattr(torch, d[3]))
                     for d in seen})
    log(f"ssm main path hands the ssd kernel x/dt/A/B/C of dtypes "
        f"{sorted(seen)}: route {routes}")
    if routes != ["tensor_cores"]:
        raise AssertionError(f"ssm main path took the ssd routes {routes}, "
                             f"want the tensor cores'")

    log(f"ssm main path: {cfg.name} L={cfg.n_layers} d={cfg.d_model} "
        f"d_inner={cfg.d_inner} heads={cfg.ssm_heads}x{cfg.ssm_head_dim} "
        f"state={cfg.ssm_state} vocab={cfg.vocab} batch={s['batch']} "
        f"prompt={s['prompt_len']} T={s['T']}: ssd launches "
        f"{entry['launches']}, prefill "
        f"{res.extra['prefill_seconds'] * 1e3:.1f} ms (first call), decode "
        f"{res.extra['tok_per_s']:.1f} tok/s over {s['T'] - 1} steps, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if entry["launches"] != cfg.n_layers or \
            res.extra["ssd_launches"] != cfg.n_layers:
        raise AssertionError(f"ssd kernel launched {entry['launches']} "
                             f"times, want one per layer ({cfg.n_layers})")
    if not res.extra["logits_finite"]:
        raise AssertionError("non-finite logits on the ssm main path")
    x = res.x
    if x.shape != (s["batch"], s["T"]) or x.dtype.kind != "i" or \
            x.min() < 0 or x.max() >= cfg.vocab:
        raise AssertionError(f"bad token matrix {x.dtype} {x.shape}")

    params = init_params(cfg, s["seed"], device)
    tokens = torch.as_tensor(res.extra["prompts"], dtype=torch.int64,
                             device=device)
    ctx = s["prompt_len"] + s["T"]
    logits, caches = {}, {}
    for kernel in (True, False):
        c = cfg.with_(use_ssd_kernel=kernel)
        logits[kernel], caches[kernel] = prefill(c, params,
                                                 {"tokens": tokens},
                                                 ctx_len=ctx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(c, params, {"tokens": tokens}, ctx_len=ctx)
        torch.cuda.synchronize()
        log(f"ssm prefill (warm, ssd_kernel={kernel}): "
            f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    tol = TOL[torch.bfloat16]
    a = logits[True].float()
    if not torch.isfinite(a).all():
        raise AssertionError("non-finite ssm prefill logits")
    # the kernel at full depth, against its plain version in the same branch
    plain = _prefill_plain_ssd(cfg.with_(use_ssd_kernel=True), params, tokens,
                               ctx).float()
    err, bad = _compare(a, plain, tol)
    log(f"ssm prefill last-token logits, {cfg.n_layers} layers, ssd kernel vs "
        f"its plain version in the kernel branch: max_abs_err {err:.3e} (tol "
        f"{tol:g}) bad={bad}")
    if bad:
        raise AssertionError("ssd kernel prefill disagrees with its plain "
                             "version")
    # the kernel branch rounds each layer's intra-chunk y to bf16 (as the JAX
    # package does), the einsum branch does not: the gap compounds with depth,
    # so it is gated at 2 layers (the JAX suite's depth for this check) and
    # reported at full depth
    b = logits[False].float()
    err, bad = _compare(a, b, tol)
    log(f"ssm prefill last-token logits, {cfg.n_layers} layers, kernel branch "
        f"vs einsum branch (reported): max_abs_err {err:.3e} (|logit| max "
        f"{b.abs().max().item():.3f}) outside {tol:g}: {bad}; argmax agree "
        f"{int((a.argmax(-1) == b.argmax(-1)).sum())}/{a.shape[0]}")
    two = cfg.with_(n_layers=2)
    p2 = init_params(two, s["seed"], device)
    a2 = prefill(two.with_(use_ssd_kernel=True), p2, {"tokens": tokens})[0]
    b2 = prefill(two.with_(use_ssd_kernel=False), p2, {"tokens": tokens})[0]
    err, bad = _compare(a2.float(), b2.float(), tol)
    log(f"ssm prefill last-token logits, 2 layers at full width, kernel "
        f"branch vs einsum branch: max_abs_err {err:.3e} (tol {tol:g}) "
        f"bad={bad}")
    if bad:
        raise AssertionError("ssd kernel and einsum prefill logits disagree "
                             "at 2 layers")
    del p2
    server = Server(cfg, ServeConfig(batch=s["batch"], ctx_len=ctx),
                    device=device)
    first = a.argmax(-1).cpu().numpy()
    steps = 8
    server.generate(params, first, 2, start_pos=s["prompt_len"],
                    cache=caches[False])                        # warm-up
    t0 = time.perf_counter()
    server.generate(params, first, steps, start_pos=s["prompt_len"] + 2,
                    cache=caches[True])
    dt = time.perf_counter() - t0
    log(f"ssm decode (warm): {dt / steps * 1e3:.2f} ms/step = "
        f"{s['batch'] * steps / dt:.1f} tok/s over {steps} steps")
    del params, caches
    torch.cuda.empty_cache()


def _expect_raise(fn, exc):
    try:
        fn()
    except exc:
        return
    raise AssertionError(f"{fn} did not raise {exc.__name__}")


def phase_guards(device) -> None:
    """The flash and SSD kernels' CUDA routes raise for inputs that require
    grad, and launch under ``torch.no_grad()``."""
    q, k, v = _qkv(1, 64, 64, 2, 2, 64, torch.bfloat16, device)
    q.requires_grad_(True)
    before = FA.launches
    _expect_raise(lambda: FA.flash_attention_cuda(q, k, v), NotImplementedError)
    _expect_raise(lambda: ops.flash_attention(q, k, v), NotImplementedError)
    if FA.launches != before:
        raise AssertionError("the flash guard raised after a launch")
    with torch.no_grad():
        ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    if FA.launches != before + 1:
        raise AssertionError("flash kernel did not launch under no_grad")
    log("flash guard: the CUDA route raises NotImplementedError for a q that "
        "requires grad and launches under torch.no_grad()")
    x, dt, A, B_, C_ = _ssd_inputs(1, 1, 16, 2, 32, 16, torch.bfloat16, device)
    x.requires_grad_(True)
    before = SSD.launches
    _expect_raise(lambda: SSD.ssd_chunk_cuda(x, dt, A, B_, C_),
                  NotImplementedError)
    _expect_raise(lambda: ops.ssd_chunk(x, dt, A, B_, C_), NotImplementedError)
    if SSD.launches != before:
        raise AssertionError("the ssd guard raised after a launch")
    with torch.no_grad():
        ops.ssd_chunk(x, dt, A, B_, C_)
    torch.cuda.synchronize()
    if SSD.launches != before + 1:
        raise AssertionError("ssd kernel did not launch under no_grad")
    log("ssd guard: the CUDA route raises NotImplementedError for an x that "
        "requires grad and launches under torch.no_grad()")


#: the slot lane's cells (phase 13): full width, bf16, the prefill kernel
#: on; each serves ``n_requests`` through ``n_slots`` lanes, K = 8 decode
#: steps per captured chunk, with ``admissions[0]`` through ``run`` and on
#: one server instance, then the other admissions on that instance
SLOT_CELLS = (
    dict(arch="qwen2-0.5b", kernel="flash", n_slots=8, n_requests=32,
         prompt_len=512, T=64, arrival="poisson:gap=2",
         admissions=("pure", "fedbuff:b=2")),
    dict(arch="mamba2-370m", kernel="ssd", n_slots=8, n_requests=16,
         prompt_len=512, T=32, arrival="poisson:gap=2", admissions=("pure",)),
)
SLOT_K, SLOT_SEED = 8, 0
#: slot lane ≡ lock-step on the card: full width, 2 layers, f32, TF32 off
SLOT_PARITY = dict(arch="qwen2-0.5b", n_layers=2, batch=4, prompt_len=512,
                   T=32)
_SLOT_KERNELS = {"flash": (FA, "flash_attention_cuda", "use_flash_attention"),
                 "ssd": (SSD, "ssd_chunk_cuda", "use_ssd_kernel")}


def _check_served(label, tokens, res, cfg, n_req, T):
    """Every request served once, T tokens in the vocabulary each, and
    one tap row per decode step."""
    if tokens.shape != (n_req, T) or tokens.dtype != np.int32 or \
            tokens.min() < 0 or tokens.max() >= cfg.vocab:
        raise AssertionError(f"{label}: bad token matrix {tokens.dtype} "
                             f"{tokens.shape} [{tokens.min()}, {tokens.max()}]")
    workers = sorted(np.asarray(res.schedule.workers).tolist())
    if workers != list(range(n_req)):
        raise AssertionError(f"{label}: schedule rows {workers}")
    if res.tap_rows != res.decode_steps or res.evictions or res.timeouts:
        raise AssertionError(f"{label}: tap rows {res.tap_rows} for "
                             f"{res.decode_steps} steps, evictions "
                             f"{res.evictions}, timeouts {res.timeouts}")


def phase_slot_cell(device, cell) -> dict:
    """One slot-lane cell: ``run`` with ``n_slots`` (the entry point), the
    same serve on one ``SlotServer`` (graph route), timed warm, profiled,
    the other admissions, and the eager route; returns the cell's row."""
    mod, cuda_fn, switch = _SLOT_KERNELS[cell["kernel"]]
    n_req, T, plen = cell["n_requests"], cell["T"], cell["prompt_len"]
    job = ServeJob(arch=cell["arch"], reduced=False, batch=cell["n_slots"],
                   prompt_len=plen, arch_overrides=((switch, True),),
                   n_slots=cell["n_slots"], n_requests=n_req,
                   admission=cell["admissions"][0], arrival=cell["arrival"],
                   steps_per_launch=SLOT_K)
    spec = ExperimentSpec(objective=job, T=T, seed=SLOT_SEED)
    cfg = job.make_arch()
    want_launches = n_req * cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    mod.launches = 0
    with _dtypes_seen(mod, cuda_fn) as seen:
        t0 = time.perf_counter()
        res = run(spec, device=device)
        cold = time.perf_counter() - t0
    launches = mod.launches
    e = res.extra
    routes = sorted({FA.route(getattr(torch, d[0])) if mod is FA else
                     SSD.route(getattr(torch, d[0]), getattr(torch, d[3]))
                     for d in seen})
    if routes != ["tensor_cores"]:
        raise AssertionError(f"slot lane {cfg.name}: kernel routes {routes}")
    if launches != want_launches or e[f"{cell['kernel']}_launches"] != \
            want_launches:
        raise AssertionError(f"slot lane {cfg.name}: {cell['kernel']} "
                             f"launched {launches} times, want {n_req} "
                             f"requests x {cfg.n_layers} layers")
    if e["compile_counts"]["chunk"] != 1 or e["graph_replays"] != e["chunks"]:
        raise AssertionError(f"slot lane {cfg.name}: {e['compile_counts']}, "
                             f"{e['graph_replays']} replays")
    if e["tap_rows"] != e["decode_steps"]:
        raise AssertionError(f"slot lane {cfg.name}: tap rows")
    log(f"slot lane {cfg.name} L={cfg.n_layers} d={cfg.d_model} through run"
        f"(ServeJob(n_slots={cell['n_slots']})): {n_req} requests, prompt "
        f"{plen}, T={T}, {cell['arrival']}, {job.admission}: {cell['kernel']} "
        f"launches {launches} on the {routes[0]} route, {e['chunks']} graph "
        f"replays of {SLOT_K} steps, cold {cold:.2f} s (params, capture)")

    params = init_params(cfg, SLOT_SEED, device)
    prompts, arrivals = e["prompts"], e["arrivals"]
    slots = SlotConfig(n_slots=cell["n_slots"], ctx_len=plen + T,
                       seed=SLOT_SEED, steps_per_launch=SLOT_K)
    server = SlotServer(cfg, slots, device=device)

    def serve(srv, admission, label):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.launches = 0
        r = srv.serve(params, prompts, T, admission=admission,
                      arrivals=arrivals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _check_served(f"{cfg.name} {label}", r.tokens, r, cfg, n_req, T)
        if mod.launches != want_launches:
            raise AssertionError(f"{cfg.name} {label}: {mod.launches} "
                                 f"{cell['kernel']} launches")
        return r, wall

    first, _ = serve(server, "pure", "graph")
    if not np.array_equal(first.tokens, res.x):
        raise AssertionError(f"{cfg.name}: SlotServer and run() disagree")
    warm, wall = serve(server, "pure", "graph, warm")
    if not np.array_equal(warm.tokens, first.tokens):
        raise AssertionError(f"{cfg.name}: a second serve changed tokens")
    _, prof_wall, kernels, _ = profiled(
        lambda: serve(server, "pure", "graph, profiled"))
    busy = sum(ms for ms, _ in kernels.values())
    idle = idle_share(kernels, prof_wall)
    for admission in cell["admissions"][1:]:
        other, _ = serve(server, admission, admission)
        log(f"slot lane {cfg.name} {admission}: {other.decode_steps} decode "
            f"steps, occupancy {other.occupancy:.3f}, mean ttft "
            f"{other.ttft_steps.mean():.2f} steps, {cell['kernel']} launches "
            f"{want_launches}, every request served once")
    counts = server.compile_counts()
    if counts != {"chunk": 1}:
        raise AssertionError(f"{cfg.name}: compile counts {counts}")
    eager, eager_wall = serve(SlotServer(cfg, slots, device=device,
                                         capture=False), "pure", "eager")
    if not np.array_equal(eager.tokens, first.tokens):
        bad = np.argwhere(eager.tokens != first.tokens)
        raise AssertionError(f"{cfg.name}: graph route and eager route "
                             f"disagree at (request, token) {bad[:5].tolist()}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    row = {"arch": cfg.name, "n_slots": cell["n_slots"], "n_requests": n_req,
           "prompt_len": plen, "T": T, "arrival": cell["arrival"],
           "admission": "pure", "steps_per_launch": SLOT_K,
           "kernel_launches": want_launches, "wall_s": wall,
           "tok_per_s": n_req * T / wall, "decode_steps": warm.decode_steps,
           "chunks": warm.chunks,
           "chunk_ms_per_step": warm.chunk_device_ms / warm.decode_steps,
           "profiled_wall_s": prof_wall, "profiled_device_ms": busy,
           "idle_share": idle,
           "host_waits": warm.host_waits,
           "host_waits_per_chunk": warm.host_waits / warm.chunks,
           "occupancy": warm.occupancy,
           "mean_ttft_steps": float(warm.ttft_steps.mean()),
           "eager_wall_s": eager_wall, "peak_gib": peak,
           "compile_counts": counts}
    log(f"slot lane {cfg.name} (warm, graph route): serve {wall * 1e3:.1f} ms"
        f", {row['tok_per_s']:.1f} tok/s ({n_req} x {T} tokens), "
        f"{warm.decode_steps} decode steps in {warm.chunks} replays, chunk "
        f"device time {row['chunk_ms_per_step']:.4f} ms per decode step, "
        f"host waits {warm.host_waits} ({row['host_waits_per_chunk']:.3f} per "
        f"chunk), occupancy {warm.occupancy:.3f}, mean ttft "
        f"{row['mean_ttft_steps']:.2f} steps, peak memory {peak:.2f} GiB; "
        f"profiled: {busy:.1f} ms of device work in {prof_wall * 1e3:.1f} ms, "
        f"idle share {idle:.3f}; eager route {eager_wall * 1e3:.1f} ms, tokens "
        f"bit-identical to the graph route")
    del params, server
    torch.cuda.empty_cache()
    return row


def phase_slot_parity(device) -> dict:
    """The slot lane against the lock-step lane through ``run``: full width,
    2 layers, f32 (TF32 off), n_slots = n_requests = batch, no arrivals,
    greedy.  The token matrices must be equal; a difference fails, naming
    the first diverging (request, step)."""
    p = SLOT_PARITY
    over = (("n_layers", p["n_layers"]), ("dtype", "float32"),
            ("use_flash_attention", True))
    base = dict(arch=p["arch"], reduced=False, batch=p["batch"],
                prompt_len=p["prompt_len"], arch_overrides=over)
    lock = run(ExperimentSpec(objective=ServeJob(**base), T=p["T"],
                              seed=SLOT_SEED), device=device)
    slot = run(ExperimentSpec(objective=ServeJob(
        **base, n_slots=p["batch"], steps_per_launch=SLOT_K), T=p["T"],
        seed=SLOT_SEED), device=device)
    if not np.array_equal(lock.extra["prompts"], slot.extra["prompts"]):
        raise AssertionError("slot and lock-step lanes drew other prompts")
    if not np.array_equal(lock.x, slot.x):
        diff = np.argwhere(lock.x != slot.x)
        step = int(diff[:, 1].min())
        rid = int(diff[diff[:, 1] == step][0, 0])
        raise AssertionError(f"slot lane diverged from the lock-step lane at "
                             f"request {rid}, step {step}")
    log(f"slot lane ≡ lock-step lane ({p['arch']} full width, "
        f"{p['n_layers']} layers, f32, TF32 off, batch {p['batch']}, "
        f"prompt {p['prompt_len']}, T={p['T']}): token matrices "
        "bit-identical")
    return {"equal": True}


def _fig1_problem(device):
    A, b = make_libsvm_like("w7a", n=10, seed=0)
    return LogRegProblem(A, b, lam=0.1, device=device)


def _fig2_problem(device):
    A, b = make_synthetic(1.0, 1.0, n=10, m=200, d=300, seed=0)
    return LogRegProblem(A, b, lam=0.1, batch_size=20, device=device)


def _theory_spec(prob, scheduler, timing, T, **kw):
    return ExperimentSpec(scheduler=scheduler, timing=timing, objective=prob,
                          T=T, stepsize=PAPER_GRID, log_every=100, seed=0,
                          **kw)


def _theory_run(label, spec, device, rows, data, backend=None):
    """One grid run through ``run``: timed, checked (finite grad norms, one
    host sync) and recorded in ``rows`` with ``data`` (the dataset's name
    and ζ(0))."""
    t0 = time.perf_counter()
    res = run(spec, backend=backend, device=device)
    wall = time.perf_counter() - t0
    e = res.extra
    finite = all(np.isfinite(g["grad_norms"]).all()
                 for g in res.grid.values())
    if not finite or not np.isfinite(res.x).all():
        raise AssertionError(f"{label}: non-finite iterate or grad norm")
    if e["host_syncs"] != 1:
        raise AssertionError(f"{label}: {e['host_syncs']} host syncs, not 1")
    row = {"cell": label, **data, "scheduler": spec.scheduler,
           "timing": spec.timing,
           "scenario": spec.scenario, "T": spec.T,
           "stochastic": spec.stochastic, "wall_s": wall,
           "loop_ms": e.get("loop_ms"), "runtime": e["runtime"],
           "graph_replays": e["graph_replays"], "host_syncs": e["host_syncs"],
           "gamma": res.gamma, "final_grad_norm": res.final_grad_norm,
           "tau_max": res.trace["tau_max"], "tau_c": res.trace["tau_c"]}
    rows.append(row)
    log(f"{label} {spec.scheduler} / {spec.timing}"
        f"{' / ' + spec.scenario if spec.scenario else ''}: wall "
        f"{wall:.3f} s, loop {row['loop_ms']} ms, {e['runtime']} route, "
        f"{e['graph_replays']} replays, γ = {res.gamma}, final grad norm "
        f"{res.final_grad_norm:.6g}")
    return res


def _same(label, got, want, fields=("x", "xs", "grad_norms")):
    for f in fields:
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"{label}: {f} not bit-identical")


def _close(label, got, want):
    for f in ("x", "grad_norms"):
        a, b = getattr(got, f), getattr(want, f)
        if not np.allclose(a, b, **THEORY_TOL):
            raise AssertionError(
                f"{label}: {f} card against CPU off by "
                f"{np.max(np.abs(a - b)):.3g} (rtol 1e-4, atol 1e-6)")
        log(f"{label}: {f} card against CPU max abs err "
            f"{np.max(np.abs(a - b)):.3g}")


def _paper_ordering(label, results) -> None:
    """Logs the survey's ordering of the final grad norms (reported, not
    gated: the stand-in data decides it); ``results`` in the order of
    ``THEORY_SCHEDULERS``."""
    pure, rand, shuf = (r.final_grad_norm for r in results)
    log(f"paper ordering ({label}): shuffled {shuf:.6g} ≤ 1.5 × random "
        f"{rand:.6g}: {shuf <= 1.5 * rand}; random ≤ pure {pure:.6g}: "
        f"{rand <= pure}")


def phase_theory_tier(device) -> list:
    """The theory tier on the card (phase 13 of the module docstring)."""
    t0 = time.perf_counter()
    rows = []
    fig1 = _fig1_problem(device)
    w7a = {"dataset": "w7a stand-in", "zeta0": fig1.zeta(np.zeros(fig1.d))}
    log(f"w7a stand-in: zeta(0) = {w7a['zeta0']:.6g}")
    runs = {}
    for timing in THEORY_TIMINGS:
        for sched in THEORY_SCHEDULERS:
            res = runs[sched, timing] = _theory_run(
                "fig1", _theory_spec(fig1, sched, timing, THEORY_T), device,
                rows, w7a)
            # (b) the chosen γ's trajectory ≡ a solo replay of the schedule
            solo = replay(res.schedule, fig1.grad_fn(), np.zeros(fig1.d),
                          res.gamma, log_every=100,
                          full_grad_fn=fig1.full_grad, device=device)
            _same(f"fig1 {sched} / {timing}: grid ≡ solo", res, solo)
    log("fig1: the chosen γ's trajectory is bit-identical to a solo replay "
        "in all six runs")
    for timing in THEORY_TIMINGS:
        _paper_ordering(f"fig1 {timing}", [runs[s, timing]
                                           for s in THEORY_SCHEDULERS])

    # (b) graph route ≡ eager loop on the card, T = 3000
    graph = runs["shuffled", "poisson:slow=8"]
    eager = _theory_run("fig1_eager", graph.spec, device, rows, w7a,
                        backend=SimulatorBackend(device, capture=False))
    for g in PAPER_GRID:
        for f in ("grad_norms", "losses"):
            if not np.array_equal(graph.grid[g][f], eager.grid[g][f]):
                raise AssertionError(f"graph ≢ eager: γ {g} {f}")
    _same("graph ≡ eager", graph, eager, ("x", "xs", "grad_norms", "losses"))
    log("fig1: the graph route is bit-identical to capture=False at T = "
        f"{THEORY_T} (every γ's grad norms and losses)")

    # (c) the card against the CPU, full-gradient and stochastic lanes
    fig2 = _fig2_problem(device)
    syn = {"dataset": "Syn(1, 1)", "zeta0": fig2.zeta(np.zeros(fig2.d))}
    lanes = (("cpu_full", fig1, _fig1_problem, False, w7a),
             ("cpu_stochastic", fig2, _fig2_problem, True, syn))
    for label, prob, make, stochastic, data in lanes:
        spec = _theory_spec(prob, "shuffled", "poisson:slow=8", THEORY_CPU_T,
                            stochastic=stochastic)
        card = _theory_run(label, spec, device, rows, data)
        cpu = run(dataclasses.replace(spec, objective=make("cpu")),
                  device="cpu")
        if cpu.gamma != card.gamma:
            raise AssertionError(f"{label}: γ {card.gamma} on the card, "
                                 f"{cpu.gamma} on the CPU")
        _close(label, card, cpu)

    # (d) the Fig. 2 stochastic cell
    log(f"Syn(1, 1): zeta(0) = {syn['zeta0']:.6g}")
    _paper_ordering("fig2 poisson:slow=8", [
        _theory_run("fig2", _theory_spec(fig2, sched, "poisson:slow=8",
                                         THEORY_T, stochastic=True),
                    device, rows, syn)
        for sched in THEORY_SCHEDULERS])

    # (e) one scenario world through SimulatorBackend
    spec = _theory_spec(fig1, "pure", "poisson:slow=8", THEORY_T,
                        scenario=THEORY_SCENARIO)
    res = _theory_run("scenario", spec, device, rows, w7a,
                      backend=SimulatorBackend(device))
    world = realise_world(parse_scenario(THEORY_SCENARIO),
                          spec.make_scheduler(), spec.make_timing(),
                          THEORY_T, seed=spec.seed).schedule
    for f in ("workers", "assign_iters", "unfinished_assign_iters"):
        if not np.array_equal(getattr(res.schedule, f), getattr(world, f)):
            raise AssertionError(f"scenario schedule: {f} differs from "
                                 "the host realisation")
    log(f"scenario: the schedule equals the host realisation bit for bit "
        f"(tau_max {world.tau_max()}, tau_c {world.tau_c()})")
    del fig1, fig2
    torch.cuda.empty_cache()
    log(f"theory tier: {len(rows)} runs in {time.perf_counter() - t0:.1f} s")
    return rows


def main() -> None:
    t0 = time.perf_counter()
    kind = phase_device()
    device = torch.device("cuda")
    phase_build()
    flash = phase_kernels(device)
    phase_main_path(device, flash)
    updates = phase_update_kernels(device)
    phase_train_main(device, updates["fused_adam_delayed"])
    phase_train_others(device, updates)
    phase_momentum_paths(device, updates)
    ssd = phase_ssd_kernel(device)
    phase_ssm_main_path(device, ssd)
    phase_guards(device)
    slot_rows = [phase_slot_cell(device, cell) for cell in SLOT_CELLS]
    slot_parity = phase_slot_parity(device)
    theory = phase_theory_tier(device)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    entries = [flash] + [updates[k] for k in AU.KERNELS] + [ssd]
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"slot_lane": slot_rows, "slot_parity": slot_parity}))
    print(json.dumps({"theory_tier": theory}))
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
