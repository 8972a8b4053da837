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

By default the traced program is one card's (mesh ``h100x1``,
``n_devices`` 1) at the shape's global batch, and each record lands under
``experiments/dryrun_torch/`` (the JAX dry-run's directory,
``experiments/dryrun/``, stays the JAX package's).  ``--both-meshes`` traces
instead the step of one rank (rank 0) of each production mesh, ``32x8``
(data 32 × model 8, 256 cards) and ``2x32x8`` (pod 2 × data 32 × model 8,
512 cards), and ``--multi-pod`` of the second alone: the rank holds its
blocks of the params, the cache and the optimizer state at model 8 and
the data axes' share of the global batch (the trainer takes its rows of
the global batch; prefill and decode are handed the rank's rows), and
runs the model under the mesh's ``TP`` (``models/tp.py``) and the
trainer's data-parallel round.  No process group is made: the mesh is a
``launch.mesh.TracedMesh``, whose collectives return their outputs'
shapes on ``meta`` and count their operand bytes
(``op_cost.collective_bytes``).  On the per-leaf routes the rank's train
state is its per-leaf ZeRO blocks (``AsyncTrainer.state_shardings``), each
layer gathered over the data axes on use through the stand-ins, the
differentiable gather included; under rules that split the residual on
``seq`` (``--auto-rules`` where the arch's heads do not divide the model
axis, as qwen2-0.5b's 14) the rank's layers run sequence-parallel on its
block of the rows (``models.tp.TP.for_seq``), so its flash covers S/8
query rows at their offset.  A train record's ``traced_state_bytes``
(the params, moments and delayed buffer the traced rank holds) then
equals ``analytic_state_bytes``, the rules with ZeRO as the JAX dry-run
counts them.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--out experiments/dryrun_torch]
  python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, get_arch
from ..configs.base import ArchConfig, InputShape
from ..distributed.async_trainer import (AsyncConfig, AsyncTrainer,
                                         held_state_bytes)
from ..distributed.sharding import (DEFAULT_RULES, Rules, auto_rules,
                                    bytes_per_device, local_specs,
                                    sharded_trace, tree_shardings)
from ..models import model as M
from ..models.specs import Spec, init_tree, meta_tree
from ..optim import OptConfig
from . import op_cost
from .mesh import (HBM_BYTES, Mesh, TracedMesh, make_production_mesh,
                   mesh_devices)

LONG_WINDOW = 8192   # SWA engaged for full-attention archs on long_500k
#: the traced program's mesh: one card
MESH_NAME = "h100x1"
HOST = Mesh({"data": 1, "model": 1})
#: the production meshes the analytic state is sharded over
PRODUCTION = {"h100x256": make_production_mesh(),
              "h100x512": make_production_mesh(multi_pod=True)}
#: the production meshes a rank is traced on, by their records' names
RANK_MESHES = {"32x8": PRODUCTION["h100x256"],
               "2x32x8": PRODUCTION["h100x512"]}


def arch_for_shape(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """long_500k requires sub-quadratic attention: SSM/hybrid run natively;
    every other family gets the sliding-window variant."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return cfg.with_(sliding_window=LONG_WINDOW)
    return cfg


def _trainer(cfg, device, update_impl="reference", microbatches=1,
             n_groups=1, mesh=None, rules=DEFAULT_RULES) -> AsyncTrainer:
    """The train step's trainer; on a (traced) mesh its worker groups are
    the data shards, the JAX trainer's default."""
    tr = AsyncTrainer(cfg, OptConfig(update_impl=update_impl),
                      AsyncConfig(delay_rounds=1, microbatches=microbatches),
                      device=device, mesh=mesh, rules=rules)
    if mesh is None:
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
                trainer: AsyncTrainer = None, seed: int = 0, mesh=None,
                rules: Rules = DEFAULT_RULES) -> dict:
    """The step's inputs by name, for ``shape``'s global batch: train
    ``state`` (``trainer``'s), ``batch`` and the ``(n_groups,)`` ``mask``;
    prefill ``params`` and ``batch``; decode ``params``, ``cache`` and
    ``tokens``.  On ``meta`` they are stand-ins
    (:func:`models.specs.meta_tree`, where JAX takes
    ``ShapeDtypeStruct`` stand-ins); on a real device they are made from ``seed``:
    the trainer's initial state or the params, random tokens (and modality
    inputs), a fresh cache.  With ``mesh`` (a ``TracedMesh``, on ``meta``)
    they are its rank's: the trainer's local state, the blocks of the
    params and the cache, the rank's rows of a prefill or decode batch
    (the trainer takes its rows of the global batch itself)."""
    device = torch.device(device)
    meta = device.type == "meta"
    B, S = shape.global_batch, shape.seq_len

    def local(specs, r=rules):
        if mesh is None:
            return specs
        return local_specs(specs, tree_shardings(specs, mesh, r))

    # a rank is handed its rows of the batch with every position: the
    # layers take their block of a sequence the rules split themselves
    batch_rules = dataclasses.replace(rules, model_priority=tuple(
        n for n in rules.model_priority if n != "seq"))

    if shape.kind == "train":
        return {"state": (meta_tree(trainer.local_state_specs()) if meta
                          else trainer.init_state(seed)),
                "batch": _batch(cfg, shape, device, seed),
                "mask": torch.ones((trainer.n_groups,), dtype=torch.float32,
                                   device=device)}
    params = (meta_tree(local(M.param_specs(cfg))) if meta
              else M.init_params(cfg, seed, device))
    if shape.kind == "prefill":
        batch = meta_tree(local(M.batch_specs(cfg, B, S), batch_rules)) \
            if mesh is not None else _batch(cfg, shape, device, seed)
        return {"params": params, "batch": batch}
    if meta:
        return {"params": params,
                "cache": meta_tree(local(M.cache_specs(cfg, B, S))),
                "tokens": meta_tree(local(Spec((B,), ("batch",), "zeros",
                                               "int32")))}
    return {"params": params, "cache": M.init_cache(cfg, B, S, device),
            "tokens": _tokens(cfg, (B,), device, seed)}


def build_step(cfg: ArchConfig, shape: InputShape, device="meta", *,
               update_impl: str = "reference", microbatches: int = 1,
               n_groups: int = 1, seed: int = 0, mesh=None,
               rules: Rules = DEFAULT_RULES):
    """→ (step fn, its positional args from :func:`input_specs`): the
    port's train step (``AsyncTrainer.train_step_fn`` at delay 1), prefill
    or one lock-step decode step at the cache's last position.  With
    ``mesh`` (a ``TracedMesh``) the step of its rank, under the mesh's
    context."""
    S = shape.seq_len
    if shape.kind == "train":
        tr = _trainer(cfg, device, update_impl, microbatches, n_groups, mesh,
                      rules)
        x = input_specs(cfg, shape, device, trainer=tr, seed=seed,
                        mesh=mesh, rules=rules)
        return tr.train_step_fn(), (x["state"], x["batch"], x["mask"])
    x = input_specs(cfg, shape, device, seed=seed, mesh=mesh, rules=rules)
    wrap = (lambda f: f) if mesh is None else \
        (lambda f: sharded_trace(f, mesh, rules))
    if shape.kind == "prefill":
        def prefill(params, batch):
            return M.prefill(cfg, params, batch, ctx_len=S)
        return wrap(prefill), (x["params"], x["batch"])

    def decode(params, cache, tokens):
        return M.decode_step(cfg, params, cache, tokens, S - 1, S)
    return wrap(decode), (x["params"], x["cache"], x["tokens"])


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
            update_impl: str = "reference", n_groups: int = 1,
            mesh: str = MESH_NAME) -> dict:
    """Trace and cost one (arch × shape) step on ``meta`` → its record.
    ``arch`` is a registry name or an ``ArchConfig`` (a reduced one, say);
    ``shape`` a name of ``SHAPES`` or an ``InputShape``; ``mesh`` is
    ``"h100x1"`` (one card) or a name of :data:`RANK_MESHES` (rank 0 of
    that mesh, its worker groups the data shards)."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = arch_for_shape(get_arch(arch) if isinstance(arch, str) else arch,
                         shape)
    if auto:
        rules = auto_rules(cfg, PRODUCTION["h100x256"].shape["model"])
    whole = RANK_MESHES.get(mesh, HOST)
    rec = {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh,
        "n_devices": mesh_devices(whole), "family": cfg.family,
        "kind": shape.kind, "sliding_window": cfg.sliding_window,
        "update_impl": update_impl, "ok": False,
    }
    try:
        t0 = time.perf_counter()
        fn, args = build_step(
            cfg, shape, "meta", update_impl=update_impl,
            microbatches=microbatches, n_groups=n_groups, rules=rules,
            mesh=TracedMesh(whole.shape) if mesh in RANK_MESHES else None)
        cost = op_cost.analyze(fn, *args)
        rec["trace_s"] = round(time.perf_counter() - t0, 2)
        if shape.kind == "train":
            rec["traced_state_bytes"] = held_state_bytes(args[0])
        rec["memory"] = {"argument_bytes": cost.argument_bytes,
                         "peak_bytes_est": cost.peak_live_bytes}
        rec["fits"] = cost.peak_live_bytes <= HBM_BYTES
        rec["analytic_state_bytes"] = state_bytes(cfg, shape, whole, rules)
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
                     f"bytes={oc['hbm_bytes']:.3g} "
                     f"coll={oc['collective_bytes']:.3g} "
                     f"trace={rec['trace_s']}s")
        else:
            extra = rec["error"][:160]
        print(f"[{'OK ' if rec['ok'] else 'FAIL'}] {rec['arch']:24s} "
              f"{shape.name:12s} {mesh:8s} {extra}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true",
                    help="trace rank 0 of the multi-pod mesh (pod 2 x "
                         "data 32 x model 8) instead of one card")
    ap.add_argument("--all", action="store_true",
                    help="every (arch × shape)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="trace rank 0 of both production meshes (32x8, "
                         "2x32x8) instead of one card")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--auto-rules", action="store_true",
                    help="per-arch sharding rules (sequence parallelism "
                         "where the heads do not divide the model axis; "
                         "on one card they move only the analytic sharded "
                         "state bytes)")
    ap.add_argument("--update-impl", default="reference",
                    choices=["reference", "pallas", "pallas_pooled"],
                    help="the train step's server update (the kernels "
                         "count once per launch with their formulas)")
    ap.add_argument("--suffix", default="")
    args = ap.parse_args(argv)
    meshes = (list(RANK_MESHES) if args.both_meshes else
              ["2x32x8"] if args.multi_pod else [MESH_NAME])

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    combos = [(a, s, m) for a in archs for s in shapes for m in meshes]
    n_ok = 0
    for a, s, m in combos:
        rec = run_one(a, s, auto=args.auto_rules,
                      update_impl=args.update_impl, mesh=m)
        n_ok += rec["ok"]
        tag = f"{a}_{s}_{m}{args.suffix}.json"
        with open(os.path.join(args.out, tag), "w") as f:
            json.dump(rec, f, indent=1)
    print(f"\n{n_ok}/{len(combos)} combinations traced OK")
    if n_ok < len(combos):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
