"""Dry-run: trace every (arch × input shape) step on ``meta`` and cost it.

Counterpart of ``repro/launch/dryrun.py``.  PyTorch has no lowering step,
so where the JAX dry-run lowers and compiles the step with
``ShapeDtypeStruct`` stand-ins, this one builds the port's real train,
prefill or decode step on ``meta`` tensors (:func:`build_step`, from
``models.specs.meta_tree``) and runs it under ``launch/op_cost.py``'s
tally: nothing is allocated on any device, and the count is of the step
the port runs.  Each record keeps the JAX keys where they mean the same
thing (``arch``, ``shape``, ``mesh``, ``n_devices``, ``family``, ``kind``,
``sliding_window``, ``ok``, ``error`` / ``traceback``,
``memory.peak_bytes_est``, ``analytic_state_bytes``) and renames what
differs: ``trace_s`` for ``lower_s`` (no ``compile_s``), ``op_cost`` for
``hlo_cost``.  It adds ``fits`` (the estimated peak within the card's
``HBM_BYTES``) and ``sharded_state_bytes``, the analytic per-device state
under the sharding rules on both production H100 meshes.

The traced program is one card's (mesh ``h100x1``, ``n_devices`` 1) at
the shape's global batch.  The dense and MoE families run
tensor-parallel over a model axis on bound meshes (``models/tp.py``), but
the dry-run traces no process group: tracing a rank of the production
meshes (model axis 8) waits for ROADMAP.md queue 1, item 14b, so
``--multi-pod`` and ``--both-meshes`` are refused.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--out experiments/dryrun]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, get_arch
from ..configs.base import ArchConfig, InputShape
from ..distributed.async_trainer import AsyncConfig, AsyncTrainer
from ..distributed.sharding import (DEFAULT_RULES, Rules, auto_rules,
                                    bytes_per_device)
from ..models import model as M
from ..models.specs import init_tree, meta_tree
from ..optim import OptConfig
from . import op_cost
from .mesh import HBM_BYTES, Mesh, make_production_mesh

LONG_WINDOW = 8192   # SWA engaged for full-attention archs on long_500k
#: the traced program's mesh: one card
MESH_NAME = "h100x1"
HOST = Mesh({"data": 1, "model": 1})
#: the production meshes the analytic state is sharded over
PRODUCTION = {"h100x256": make_production_mesh(),
              "h100x512": make_production_mesh(multi_pod=True)}


def arch_for_shape(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """long_500k requires sub-quadratic attention: SSM/hybrid run natively;
    every other family gets the sliding-window variant."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return cfg.with_(sliding_window=LONG_WINDOW)
    return cfg


def _trainer(cfg, device, update_impl="reference", microbatches=1,
             n_groups=1) -> AsyncTrainer:
    tr = AsyncTrainer(cfg, OptConfig(update_impl=update_impl),
                      AsyncConfig(delay_rounds=1, microbatches=microbatches),
                      device=device)
    tr.n_groups = n_groups
    return tr


def _tokens(cfg, shape, device, seed):
    gen = torch.Generator(device).manual_seed(seed)
    return torch.randint(0, cfg.vocab, shape, generator=gen, device=device,
                         dtype=torch.int32)


def _batch(cfg, shape: InputShape, device, seed):
    """The train / prefill batch: meta stand-ins, or on a real device
    random tokens and the stubbed modality inputs from ``seed``."""
    specs = M.batch_specs(cfg, shape.global_batch, shape.seq_len)
    if device.type == "meta":
        return meta_tree(specs)
    batch = init_tree(specs, seed, device)
    batch["tokens"] = _tokens(cfg, tuple(batch["tokens"].shape), device, seed)
    return batch


def input_specs(cfg: ArchConfig, shape: InputShape, device="meta", *,
                trainer: AsyncTrainer = None, seed: int = 0) -> dict:
    """The step's inputs by name, for ``shape``'s global batch: train
    ``state`` (``trainer``'s), ``batch`` and the ``(n_groups,)`` ``mask``;
    prefill ``params`` and ``batch``; decode ``params``, ``cache`` and
    ``tokens``.  On ``meta`` they are stand-ins
    (:func:`models.specs.meta_tree`, where JAX takes
    ``ShapeDtypeStruct`` stand-ins); on a real device they are made from ``seed``:
    the trainer's initial state or the params, random tokens (and modality
    inputs), a fresh cache."""
    device = torch.device(device)
    meta = device.type == "meta"
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"state": (meta_tree(trainer.state_specs()) if meta
                          else trainer.init_state(seed)),
                "batch": _batch(cfg, shape, device, seed),
                "mask": torch.ones((trainer.n_groups,), dtype=torch.float32,
                                   device=device)}
    params = (meta_tree(M.param_specs(cfg)) if meta
              else M.init_params(cfg, seed, device))
    if shape.kind == "prefill":
        return {"params": params, "batch": _batch(cfg, shape, device, seed)}
    if meta:
        return {"params": params,
                "cache": meta_tree(M.cache_specs(cfg, B, S)),
                "tokens": torch.empty((B,), dtype=torch.int32,
                                      device=device)}
    return {"params": params, "cache": M.init_cache(cfg, B, S, device),
            "tokens": _tokens(cfg, (B,), device, seed)}


def build_step(cfg: ArchConfig, shape: InputShape, device="meta", *,
               update_impl: str = "reference", microbatches: int = 1,
               n_groups: int = 1, seed: int = 0):
    """→ (step fn, its positional args from :func:`input_specs`): the
    port's train step (``AsyncTrainer.train_step_fn`` at delay 1), prefill
    or one lock-step decode step at the cache's last position."""
    S = shape.seq_len
    if shape.kind == "train":
        tr = _trainer(cfg, device, update_impl, microbatches, n_groups)
        x = input_specs(cfg, shape, device, trainer=tr, seed=seed)
        return tr.train_step_fn(), (x["state"], x["batch"], x["mask"])
    x = input_specs(cfg, shape, device, seed=seed)
    if shape.kind == "prefill":
        def prefill(params, batch):
            return M.prefill(cfg, params, batch, ctx_len=S)
        return prefill, (x["params"], x["batch"])

    def decode(params, cache, tokens):
        return M.decode_step(cfg, params, cache, tokens, S - 1, S)
    return decode, (x["params"], x["cache"], x["tokens"])


def state_bytes(cfg: ArchConfig, shape: InputShape, mesh,
                rules: Rules = DEFAULT_RULES) -> int:
    """Analytic per-device bytes of the step's state under the rules, as
    the JAX dry-run counts them: train params + Adam moments + the delayed
    buffer (ZeRO over the data axes); serve params (ZeRO), plus the cache
    for decode."""
    if shape.kind == "train":
        sp = _trainer(cfg, "meta").state_specs()
        return sum(bytes_per_device(t, mesh, rules, zero=True)
                   for t in (sp["params"], sp["opt"]["m"], sp["opt"]["v"],
                             sp["gbuf"]))
    n = bytes_per_device(M.param_specs(cfg), mesh, rules, zero=True)
    if shape.kind == "decode":
        n += bytes_per_device(
            M.cache_specs(cfg, shape.global_batch, shape.seq_len), mesh,
            rules)
    return n


def run_one(arch, shape, *, rules: Rules = DEFAULT_RULES,
            verbose: bool = True, microbatches: int = 1, auto: bool = False,
            update_impl: str = "reference", n_groups: int = 1) -> dict:
    """Trace and cost one (arch × shape) step on ``meta`` → its record.
    ``arch`` is a registry name or an ``ArchConfig`` (a reduced one, say);
    ``shape`` a name of ``SHAPES`` or an ``InputShape``."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = arch_for_shape(get_arch(arch) if isinstance(arch, str) else arch,
                         shape)
    if auto:
        rules = auto_rules(cfg, PRODUCTION["h100x256"].shape["model"])
    rec = {
        "arch": cfg.name, "shape": shape.name, "mesh": MESH_NAME,
        "n_devices": 1, "family": cfg.family, "kind": shape.kind,
        "sliding_window": cfg.sliding_window, "update_impl": update_impl,
        "ok": False,
    }
    try:
        t0 = time.perf_counter()
        fn, args = build_step(cfg, shape, "meta", update_impl=update_impl,
                              microbatches=microbatches, n_groups=n_groups)
        cost = op_cost.analyze(fn, *args)
        rec["trace_s"] = round(time.perf_counter() - t0, 2)
        rec["memory"] = {"argument_bytes": cost.argument_bytes,
                         "peak_bytes_est": cost.peak_live_bytes}
        rec["fits"] = cost.peak_live_bytes <= HBM_BYTES
        rec["analytic_state_bytes"] = state_bytes(cfg, shape, HOST, rules)
        rec["sharded_state_bytes"] = {
            name: state_bytes(cfg, shape, mesh, rules)
            for name, mesh in PRODUCTION.items()}
        rec["op_cost"] = cost.as_dict()
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — a dry-run failure IS the signal
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    if verbose:
        if rec["ok"]:
            oc = rec["op_cost"]
            extra = (f"peak={rec['memory']['peak_bytes_est'] / 1e9:.2f}GB "
                     f"fits={rec['fits']} flops={oc['dot_flops']:.3g} "
                     f"bytes={oc['hbm_bytes']:.3g} trace={rec['trace_s']}s")
        else:
            extra = rec["error"][:160]
        print(f"[{'OK ' if rec['ok'] else 'FAIL'}] {rec['arch']:24s} "
              f"{shape.name:12s} {MESH_NAME:8s} {extra}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true",
                    help="refused: the port traces one card")
    ap.add_argument("--all", action="store_true",
                    help="every (arch × shape) on h100x1")
    ap.add_argument("--both-meshes", action="store_true",
                    help="refused: the port traces one card")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--auto-rules", action="store_true",
                    help="per-arch sharding rules (the analytic sharded "
                         "state bytes only: the traced step is one card's)")
    ap.add_argument("--update-impl", default="reference",
                    choices=["reference", "pallas", "pallas_pooled"],
                    help="the train step's server update (the kernels "
                         "count once per launch with their formulas)")
    ap.add_argument("--suffix", default="")
    args = ap.parse_args(argv)
    for flag in ("multi_pod", "both_meshes"):
        if getattr(args, flag):
            ap.error(f"--{flag.replace('_', '-')} traces a rank of the "
                     "production meshes (model axis 8), which the dry-run "
                     "does not do yet: ROADMAP.md queue 1, item 14b; the "
                     "port traces the step of one card")

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    combos = [(a, s) for a in archs for s in shapes]
    n_ok = 0
    for a, s in combos:
        rec = run_one(a, s, auto=args.auto_rules,
                      update_impl=args.update_impl)
        n_ok += rec["ok"]
        tag = f"{a}_{s}_{MESH_NAME}{args.suffix}.json"
        with open(os.path.join(args.out, tag), "w") as f:
            json.dump(rec, f, indent=1)
    print(f"\n{n_ok}/{len(combos)} combinations traced OK")
    if n_ok < len(combos):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
