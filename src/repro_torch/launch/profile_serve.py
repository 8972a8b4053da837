"""Where the serving path's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch qwen2-0.5b|mamba2-370m|zamba2-7b|deepseek-moe-16b|
                seamless-m4t-large-v2|pixtral-12b] \
        [--no-flash] [--no-ssd] [--slots N] [--trace-dir DIR]
    torchrun --nproc-per-node N -m repro_torch.launch.profile_serve \
        --arch deepseek-moe-16b --mesh data=1,model=N [--slots S]
        [--n-layers L] [--f32] [--json-out PATH]

Runs a serving main path's configuration at full width (a batch of 4
prompts of 1024 tokens, greedy decode): qwen2-0.5b (the default) or
deepseek-moe-16b with the flash kernel on, or with plain attention under
``--no-flash``; mamba2-370m with the SSD chunk kernel on, or with the
einsum branch under ``--no-ssd``; or zamba2-7b with both kernels on, each
switched off by its flag.  The audio and vlm families run at the model
level (``prefill`` with their modality inputs, then ``Server.generate``
from its cache), since ``ServeBackend`` and the slot lane refuse them:
seamless-m4t-large-v2 with 4 × 1024 frames and prompts of 256 tokens,
pixtral-12b with prompts of 1024 tokens whose first 256 positions are
patches (:func:`model_batch`, ``batch_specs``' shapes).  It warms the
lock-step path up (one prefill and ``STEPS`` decode steps), times
a second prefill and decode with the host clock around
``torch.cuda.synchronize()``, then records the same work under
``torch.profiler`` and prints, for prefill and for decode apart:

* wall time, the summed device time of its kernels and the device's idle
  share (``1 − device / wall``);
* the kernels that took most device time.

With ``--slots N`` it profiles the continuous-batching slot lane instead:
``SlotServer`` with N slots serves 4·N requests (``--slot-requests R``:
R·N) of 512-token prompts, 64
tokens each, Poisson arrivals every 2 decode steps on average, ``pure``
admission, 8 decode steps per captured chunk.  After one warm-up serve
(which captures the chunk) it times a warm serve and then records one
under ``torch.profiler``, and prints the serve's wall time, tokens/s, the
chunk replays' device span (CUDA events around each replay) per decode
step, host waits per chunk, occupancy, the device time by kernel and the
idle share over the serve.

``--mesh data=D[,pod=P][,model=M]`` serves under ``torchrun``, one
process per card (NCCL), every rank timing the same work; rank 0 prints.
The lock-step lane: the prompts' rows over the data axes, every family
tensor-parallel over the model axis (``Server(mesh=...)``, each rank
holding its blocks of the params and the cache), with each collective
kind's launches and operand bytes of a prefill and of a decode step.  The
slot lane (``--slots N``): ``SlotServer(mesh=...)``, each data rank
holding N / D of the slots and each rank its blocks of the params and the
ragged cache; its chunk runs eagerly there.  ``--json-out`` appends the
timed numbers as one JSON line, with the timed serve's greedy tokens (the
lock-step lane's first token of the prefill and the ``STEPS`` decoded
ones; the slot lane's token matrix and TTFT), so runs on several meshes
can be held to one another.  The slot lane's line splits the profiled
serve's device time into the compute kernels' and NCCL's, so a mesh's
device time a decode step is read off the compute stream.
``--n-layers`` cuts the depth; ``--f32`` runs with f32 params and
activations, where a mesh's greedy tokens equal one card's (in bf16 an
ulp between the two summation orders can move the MoE's routing and so a
token).

``--trace-dir`` also writes the profiler's Chrome traces there
(``prefill.json``, ``decode.json``, or ``slots.json``).  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..configs import get_arch
from ..device import resolve_device
from ..distributed import Server, ServeConfig, SlotConfig, SlotServer
from ..distributed import collectives, draw_arrivals
from ..models import batch_specs, init_params, prefill
from ..tree import tree_map

ARCHS = ("qwen2-0.5b", "mamba2-370m", "zamba2-7b", "deepseek-moe-16b",
         "seamless-m4t-large-v2", "pixtral-12b")
BATCH, PROMPT_LEN, STEPS, SEED = 4, 1024, 8, 0
TOP = 12                        # kernels listed per phase
#: the slot lane's cell: requests per slot, prompt length, tokens per
#: request, arrivals, admission, decode steps per chunk
SLOT_REQUESTS, SLOT_PROMPT, SLOT_T = 4, 512, 64
SLOT_ARRIVAL, SLOT_ADMISSION, SLOT_K = "poisson:gap=2", "pure", 8


def model_batch(cfg, batch: int, seq: int, seed: int, device) -> dict:
    """A prefill batch of ``batch_specs(cfg, batch, seq)``'s shapes: the
    tokens from ``numpy.random.default_rng(seed)`` (the serving lanes'
    prompt stream), the stubbed modality inputs (audio frames, vlm
    patches) f32 standard normals from a ``torch.Generator`` on
    ``device`` seeded with ``seed``."""
    gen = torch.Generator(device).manual_seed(seed)
    out = {}
    for k, sp in sorted(batch_specs(cfg, batch, seq).items()):
        if sp.dtype == "int32":
            out[k] = torch.as_tensor(np.random.default_rng(seed).integers(
                0, cfg.vocab, sp.shape), dtype=torch.int64, device=device)
        else:
            out[k] = torch.randn(sp.shape, generator=gen, device=device)
    return out


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


def _rules_name(rules) -> str:
    from ..distributed.sharding import SEQ_PARALLEL_RULES

    return "seq_parallel" if rules == SEQ_PARALLEL_RULES else "default"


def _switches(cfg) -> str:
    """The kernel switches that the family reads."""
    out = []
    if cfg.family != "ssm":
        out.append(f"flash={cfg.use_flash_attention}")
    if cfg.family in ("ssm", "hybrid"):
        out.append(f"ssd_kernel={cfg.use_ssd_kernel}")
    return " ".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default=ARCHS[0])
    ap.add_argument("--no-flash", action="store_true",
                    help="plain attention (dense, moe and hybrid families)")
    ap.add_argument("--no-ssd", action="store_true",
                    help="the einsum SSD branch (ssm and hybrid families)")
    ap.add_argument("--slots", type=int, default=None, metavar="N",
                    help="profile the slot lane with N slots")
    ap.add_argument("--slot-requests", type=int, default=SLOT_REQUESTS,
                    metavar="R", help="the slot lane's requests per slot")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--mesh", default=None,
                    metavar="data=D[,pod=P][,model=M]",
                    help="under torchrun: serve over the launcher's "
                         "processes, one per card")
    ap.add_argument("--json-out", default=None, metavar="PATH",
                    help="append the timed numbers and the greedy tokens "
                         "as one JSON line")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth")
    ap.add_argument("--f32", action="store_true",
                    help="f32 params and activations")
    ap.add_argument("--auto-rules", action="store_true",
                    help="per-arch sharding rules on the mesh (sequence "
                         "parallelism where the heads do not divide the "
                         "model axis)")
    args = ap.parse_args(argv)
    if not args.mesh:
        if args.auto_rules:
            ap.error("--auto-rules picks the sharding rules of a mesh: "
                     "pass --mesh")
        return _serve(args, ap, None)
    import torch.distributed as dist

    from .mesh import ProcessMesh, init_process_group
    from .train import parse_mesh

    mesh = parse_mesh(args.mesh)
    init_process_group("cuda")
    try:
        _serve(args, ap, ProcessMesh(mesh.shape))
    finally:
        dist.destroy_process_group()


def _serve(args, ap, mesh) -> None:
    from ..distributed.sharding import auto_rules, sharded_trace

    lead = mesh is None or mesh.rank == 0
    out = print if lead else (lambda *a, **k: None)
    device = resolve_device("cuda")
    cfg = get_arch(args.arch).with_(use_flash_attention=not args.no_flash,
                                    use_ssd_kernel=not args.no_ssd)
    if args.n_layers:
        cfg = cfg.with_(n_layers=args.n_layers)
    if args.f32:
        cfg = cfg.with_(dtype="float32")
    rules = auto_rules(cfg, mesh.shape.get("model", 1)) \
        if getattr(args, "auto_rules", False) else None
    if args.slots and cfg.family in ("audio", "vlm"):
        ap.error(f"the slot lane serves token-only prompts; {args.arch} "
                 "runs at the model level only (omit --slots)")
    if args.slots:
        server = SlotServer(cfg, SlotConfig(
            n_slots=args.slots, ctx_len=SLOT_PROMPT + SLOT_T, seed=SEED,
            steps_per_launch=SLOT_K), device=device, mesh=mesh,
            rules=rules)
    else:
        batch = model_batch(cfg, BATCH, PROMPT_LEN, SEED, device)
        plen = batch["tokens"].shape[1]    # audio: PROMPT_LEN // dec_ratio
        ctx = plen + STEPS + 1
        server = Server(cfg, ServeConfig(batch=BATCH, ctx_len=ctx),
                        device=device, mesh=mesh, rules=rules)
    params = init_params(cfg, SEED, device,
                         shardings=server.param_shardings())
    if args.f32:
        params = tree_map(lambda t: t.float(), params)
    if args.slots:
        _profile_slots(server, params, args, lead)
        return
    run_prefill = prefill
    if mesh is not None:
        rows = server.batch_sharding()
        batch = {k: rows.local(v) for k, v in batch.items()}
        run_prefill = sharded_trace(prefill, mesh, server.rules)

    def serve(pre_ctx=None, dec_ctx=None):
        """One prefill and ``STEPS`` decode steps, each under its own
        context; returns (prefill seconds, decode seconds, the greedy
        tokens (B, 1 + STEPS))."""
        with pre_ctx or contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, cache = run_prefill(cfg, params, batch, ctx_len=ctx)
            first = torch.argmax(last, dim=-1)
            if mesh is not None:
                first = server.batch_sharding().gather(first)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        with dec_ctx or contextlib.nullcontext():
            t2 = time.perf_counter()
            toks = server.generate(params, first.cpu().numpy(), STEPS,
                                   start_pos=plen, cache=cache)
            t3 = time.perf_counter()
        return t1 - t0, t3 - t2, np.concatenate(
            [first.cpu().numpy()[:, None], toks], 1)

    serve()                                                 # warm-up
    before = collectives.snapshot()
    pre_s, dec_s, tokens = serve()
    coll = collectives.since(before)
    kernel = _switches(cfg)
    inputs = " ".join(f"{k}={tuple(v.shape)}" for k, v in batch.items())
    peak = torch.cuda.max_memory_allocated() / 2**30
    out(f"{cfg.name} L={cfg.n_layers} d={cfg.d_model} {inputs} {kernel}"
        + (f" mesh={mesh.shape} rules={_rules_name(server.rules)}"
           if mesh is not None else "") + ": "
        f"prefill {pre_s * 1e3:.3f} ms, decode {dec_s / STEPS * 1e3:.3f}"
        f" ms/step = {BATCH * STEPS / dec_s:.1f} tok/s; peak memory "
        f"{peak:.2f} GiB"
        + (f"; collectives of a prefill and {STEPS} steps {coll}"
           if mesh is not None else ""))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    p_pre, p_dec = profile(activities=acts), profile(activities=acts)
    prof_pre_s, prof_dec_s, _ = serve(p_pre, p_dec)
    if args.json_out and lead:
        # the profiled prefill's device time on this rank: its attention
        # (the flash kernel) and all of it
        kt = kernel_times(p_pre)
        flash = [(ms, n) for k, (ms, n) in kt.items() if "flash_fwd" in k]
        with open(args.json_out, "a") as f:
            f.write(json.dumps({
                "arch": cfg.name, "n_layers": cfg.n_layers,
                "mesh": None if mesh is None else mesh.shape,
                "rules": _rules_name(server.rules),
                "batch": BATCH, "prompt_len": plen,
                "prefill_ms": pre_s * 1e3,
                "decode_ms_per_step": dec_s / STEPS * 1e3,
                "prefill_flash_device_ms": sum(ms for ms, _ in flash),
                "prefill_flash_launches": sum(n for _, n in flash),
                "prefill_device_ms": sum(ms for ms, _ in kt.values()),
                "dtype": cfg.dtype, "collectives": coll, "peak_gib": peak,
                "tokens": tokens.tolist(),
                "device": torch.cuda.get_device_name()}) + "\n")
    pre_s, dec_s = prof_pre_s, prof_dec_s
    if lead:
        _report("prefill (profiled)", kernel_times(p_pre), pre_s)
        _report(f"decode, {STEPS} steps (profiled)", kernel_times(p_dec),
                dec_s)
    if args.trace_dir and lead:
        os.makedirs(args.trace_dir, exist_ok=True)
        p_pre.export_chrome_trace(os.path.join(args.trace_dir, "prefill.json"))
        p_dec.export_chrome_trace(os.path.join(args.trace_dir, "decode.json"))


def _profile_slots(server, params, args, lead: bool) -> None:
    """One warm slot-lane serve timed, then one under the profiler; rank 0
    prints (and appends ``--json-out``'s line)."""
    cfg, n_slots, mesh = server.cfg, server.slots.n_slots, server.mesh
    n_req = args.slot_requests * n_slots
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
    before = collectives.snapshot()
    res, wall = serve()
    coll = collectives.since(before)
    (_, _), p_wall, kernels, prof = profiled(serve)
    nccl = sum(ms for k, (ms, _) in kernels.items() if "nccl" in k.lower())
    compute = sum(ms for ms, _ in kernels.values()) - nccl
    tok_s = n_req * SLOT_T / wall
    if not lead:
        return
    print(f"{cfg.name} L={cfg.n_layers} d={cfg.d_model} slots={n_slots} "
          f"requests={n_req} prompt={SLOT_PROMPT} T={SLOT_T} "
          f"arrival={SLOT_ARRIVAL} admission={SLOT_ADMISSION} K={SLOT_K} "
          f"{_switches(cfg)}"
          + (f" mesh={mesh.shape}" if mesh is not None else "") + ": "
          f"serve {wall * 1e3:.3f} ms, {tok_s:.1f} tok/s, "
          f"{res.decode_steps} decode steps in {res.chunks} chunks "
          f"({'graph replays' if server.capture else 'eager'}), chunk "
          f"device span {res.chunk_device_ms:.3f} ms = "
          f"{res.chunk_device_ms / res.decode_steps:.4f} ms/step, host waits "
          f"{res.host_waits} ({res.host_waits / res.chunks:.3f} per chunk), "
          f"occupancy {res.occupancy:.3f}, mean TTFT "
          f"{float(np.mean(res.ttft_steps)):.3f} steps, compile counts "
          f"{server.compile_counts()}"
          + (f"; collectives of a serve {coll}" if mesh is not None else ""))
    _report(f"slot serve, {res.decode_steps} decode steps, {n_req} "
            f"prefills (profiled; compute kernels {compute:.3f} ms, NCCL "
            f"{nccl:.3f} ms)", kernels, p_wall)
    if args.json_out:
        with open(args.json_out, "a") as f:
            f.write(json.dumps({
                "arch": cfg.name, "n_layers": cfg.n_layers, "lane": "slots",
                "mesh": None if mesh is None else mesh.shape,
                "slots": n_slots, "requests": n_req,
                "prompt_len": SLOT_PROMPT, "max_new": SLOT_T,
                "dtype": cfg.dtype, "serve_ms": wall * 1e3, "tok_s": tok_s,
                "decode_steps": res.decode_steps, "chunks": res.chunks,
                "chunk_span_ms_per_step":
                    res.chunk_device_ms / res.decode_steps,
                "compute_kernel_ms_per_step": compute / res.decode_steps,
                "nccl_kernel_ms_per_step": nccl / res.decode_steps,
                "profiled_wall_ms": p_wall * 1e3,
                "idle_share": idle_share(kernels, p_wall),
                "ttft_steps_mean": float(np.mean(res.ttft_steps)),
                "ttft_steps": res.ttft_steps.tolist(),
                "collectives": coll, "tokens": res.tokens.tolist(),
                "device": torch.cuda.get_device_name()}) + "\n")
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace_dir, "slots.json"))


if __name__ == "__main__":
    main()
