"""Where the serving path's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch qwen2-0.5b|mamba2-370m] [--no-flash] [--no-ssd] \
        [--slots N] [--trace-dir DIR]

Runs a serving main path's configuration at full width (a batch of 4
prompts of 1024 tokens, greedy decode): qwen2-0.5b (the default) with the
flash kernel on, or with plain attention under ``--no-flash``; or
mamba2-370m with the SSD chunk kernel on, or with the einsum branch under
``--no-ssd``.  It warms the lock-step path up (one prefill and ``STEPS``
decode steps), times
a second prefill and decode with the host clock around
``torch.cuda.synchronize()``, then records the same work under
``torch.profiler`` and prints, for prefill and for decode apart:

* wall time, the summed device time of its kernels and the device's idle
  share (``1 − device / wall``);
* the kernels that took most device time.

With ``--slots N`` it profiles the continuous-batching slot lane instead:
``SlotServer`` with N slots serves 4·N requests of 512-token prompts, 64
tokens each, Poisson arrivals every 2 decode steps on average, ``pure``
admission, 8 decode steps per captured chunk.  After one warm-up serve
(which captures the chunk) it times a warm serve and then records one
under ``torch.profiler``, and prints the serve's wall time, tokens/s, the
chunk replays' device span (CUDA events around each replay) per decode
step, host waits per chunk, occupancy, the device time by kernel and the
idle share over the serve.

``--trace-dir`` also writes the profiler's Chrome traces there
(``prefill.json``, ``decode.json``, or ``slots.json``).  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..configs import get_arch
from ..device import resolve_device
from ..distributed import Server, ServeConfig, SlotConfig, SlotServer
from ..distributed import draw_arrivals
from ..models import init_params, prefill

ARCHS = ("qwen2-0.5b", "mamba2-370m")
BATCH, PROMPT_LEN, STEPS, SEED = 4, 1024, 8, 0
TOP = 12                        # kernels listed per phase
#: the slot lane's cell: requests per slot, prompt length, tokens per
#: request, arrivals, admission, decode steps per chunk
SLOT_REQUESTS, SLOT_PROMPT, SLOT_T = 4, 512, 64
SLOT_ARRIVAL, SLOT_ADMISSION, SLOT_K = "poisson:gap=2", "pure", 8


def kernel_times(prof) -> dict:
    """``{name: [device ms, count]}`` of the device activities (kernels,
    copies, memsets) a finished profiler recorded, read from its raw
    events: building its per-op tables (``key_averages``) for the
    ~350,000 kernels of a slot serve takes minutes."""
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            row = out.setdefault(e.name(), [0.0, 0])
            row[0] += e.duration_ns() / 1e6
            row[1] += 1
    return out


def idle_share(kernels: dict, wall_s: float) -> float:
    """``1 − device / wall`` of one profiled run."""
    return 1 - sum(ms for ms, _ in kernels.values()) / (wall_s * 1e3)


def profiled(fn):
    """``fn()`` under ``torch.profiler`` (CPU and CUDA activities), timed
    with the host clock around ``torch.cuda.synchronize()``; returns (its
    result, wall seconds, ``kernel_times``, the profiler)."""
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, kernel_times(prof), prof


def _report(name: str, kernels: dict, wall_s: float) -> None:
    dev_ms = sum(ms for ms, _ in kernels.values())
    print(f"{name}: wall {wall_s * 1e3:.3f} ms, device {dev_ms:.3f} ms, idle "
          f"share {idle_share(kernels, wall_s):.3f}")
    for key, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"  {ms:9.3f} ms  {n:5d}x  {key[:90]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default=ARCHS[0])
    ap.add_argument("--no-flash", action="store_true",
                    help="plain attention (dense family)")
    ap.add_argument("--no-ssd", action="store_true",
                    help="the einsum SSD branch (ssm family)")
    ap.add_argument("--slots", type=int, default=None, metavar="N",
                    help="profile the slot lane with N slots")
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    cfg = get_arch(args.arch).with_(use_flash_attention=not args.no_flash,
                                    use_ssd_kernel=not args.no_ssd)
    params = init_params(cfg, SEED, device)
    if args.slots:
        _profile_slots(cfg, params, args.slots, device, args.trace_dir)
        return
    ctx = PROMPT_LEN + STEPS + 1
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (BATCH, PROMPT_LEN))
    tokens = torch.as_tensor(prompts, dtype=torch.int64, device=device)
    server = Server(cfg, ServeConfig(batch=BATCH, ctx_len=ctx),
                    device=device)

    def serve(pre_ctx=None, dec_ctx=None):
        """One prefill and ``STEPS`` decode steps, each under its own
        context; returns (prefill seconds, decode seconds)."""
        with pre_ctx or contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, cache = prefill(cfg, params, {"tokens": tokens},
                                  ctx_len=ctx)
            first = torch.argmax(last, dim=-1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        with dec_ctx or contextlib.nullcontext():
            t2 = time.perf_counter()
            server.generate(params, first.cpu().numpy(), STEPS,
                            start_pos=PROMPT_LEN, cache=cache)
            t3 = time.perf_counter()
        return t1 - t0, t3 - t2

    serve()                                                 # warm-up
    pre_s, dec_s = serve()
    kernel = (f"ssd_kernel={cfg.use_ssd_kernel}" if cfg.family == "ssm"
              else f"flash={cfg.use_flash_attention}")
    print(f"{cfg.name} L={cfg.n_layers} d={cfg.d_model} batch={BATCH} "
          f"prompt={PROMPT_LEN} {kernel}: "
          f"prefill {pre_s * 1e3:.3f} ms, decode {dec_s / STEPS * 1e3:.3f}"
          f" ms/step = {BATCH * STEPS / dec_s:.1f} tok/s")

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    p_pre, p_dec = profile(activities=acts), profile(activities=acts)
    pre_s, dec_s = serve(p_pre, p_dec)
    _report("prefill (profiled)", kernel_times(p_pre), pre_s)
    _report(f"decode, {STEPS} steps (profiled)", kernel_times(p_dec), dec_s)
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        p_pre.export_chrome_trace(os.path.join(args.trace_dir, "prefill.json"))
        p_dec.export_chrome_trace(os.path.join(args.trace_dir, "decode.json"))


def _profile_slots(cfg, params, n_slots: int, device, trace_dir) -> None:
    """One warm slot-lane serve timed, then one under the profiler."""
    n_req = SLOT_REQUESTS * n_slots
    server = SlotServer(cfg, SlotConfig(n_slots=n_slots,
                                        ctx_len=SLOT_PROMPT + SLOT_T,
                                        seed=SEED, steps_per_launch=SLOT_K),
                        device=device)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (n_req, SLOT_PROMPT))
    arrivals = draw_arrivals(n_req, SLOT_ARRIVAL, seed=SEED)

    def serve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = server.serve(params, prompts, SLOT_T, admission=SLOT_ADMISSION,
                           arrivals=arrivals)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    serve()                                     # warm-up: captures the chunk
    res, wall = serve()
    kernel = (f"ssd_kernel={cfg.use_ssd_kernel}" if cfg.family == "ssm"
              else f"flash={cfg.use_flash_attention}")
    print(f"{cfg.name} L={cfg.n_layers} d={cfg.d_model} slots={n_slots} "
          f"requests={n_req} prompt={SLOT_PROMPT} T={SLOT_T} "
          f"arrival={SLOT_ARRIVAL} admission={SLOT_ADMISSION} K={SLOT_K} "
          f"{kernel}: serve {wall * 1e3:.3f} ms, "
          f"{n_req * SLOT_T / wall:.1f} tok/s, {res.decode_steps} decode "
          f"steps in {res.chunks} chunk replays, chunk device span "
          f"{res.chunk_device_ms:.3f} ms = "
          f"{res.chunk_device_ms / res.decode_steps:.4f} ms/step, host waits "
          f"{res.host_waits} ({res.host_waits / res.chunks:.3f} per chunk), "
          f"occupancy {res.occupancy:.3f}, compile counts "
          f"{server.compile_counts()}")
    (res, _), wall, kernels, prof = profiled(serve)
    _report(f"slot serve, {res.decode_steps} decode steps, {n_req} "
            f"prefills (profiled)", kernels, wall)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "slots.json"))


if __name__ == "__main__":
    main()
