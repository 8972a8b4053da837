"""Where the serving path's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch qwen2-0.5b|mamba2-370m] [--no-flash] [--no-ssd] \
        [--trace-dir DIR]

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

``--trace-dir`` also writes the profiler's Chrome traces there
(``prefill.json``, ``decode.json``).  Needs a CUDA card.
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
from ..distributed import Server, ServeConfig
from ..models import init_params, prefill

ARCHS = ("qwen2-0.5b", "mamba2-370m")
BATCH, PROMPT_LEN, STEPS, SEED = 4, 1024, 8, 0
TOP = 12                        # kernels listed per phase


def _report(name: str, prof, wall_s: float) -> None:
    # device-side rows only: a CPU op's row repeats its kernels' time
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
    wall_ms = wall_s * 1e3
    print(f"{name}: wall {wall_ms:.3f} ms, device {dev_ms:.3f} ms, idle "
          f"share {1 - dev_ms / wall_ms:.3f}")
    for e in rows[:TOP]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default=ARCHS[0])
    ap.add_argument("--no-flash", action="store_true",
                    help="plain attention (dense family)")
    ap.add_argument("--no-ssd", action="store_true",
                    help="the einsum SSD branch (ssm family)")
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    cfg = get_arch(args.arch).with_(use_flash_attention=not args.no_flash,
                                    use_ssd_kernel=not args.no_ssd)
    params = init_params(cfg, SEED, device)
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
    _report("prefill (profiled)", p_pre, pre_s)
    _report(f"decode, {STEPS} steps (profiled)", p_dec, dec_s)
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        p_pre.export_chrome_trace(os.path.join(args.trace_dir, "prefill.json"))
        p_dec.export_chrome_trace(os.path.join(args.trace_dir, "decode.json"))


if __name__ == "__main__":
    main()
