"""Roofline analysis from the dry-run's records, with H100 constants.

Counterpart of ``repro/launch/roofline.py``.  For each (arch × shape) traced
on one card (``*_h100x1.json``) or as rank 0 of a production mesh
(``--mesh 32x8`` / ``2x32x8``: the dry-run's ``--both-meshes`` records),
the three roofline terms come from the traced op count (``op_cost``: one
card's program):

    compute_term    = dot_flops / PEAK_FLOPS_BF16          [s]
    memory_term     = hbm_bytes / HBM_BW                   [s]
    collective_term = collective_bytes / NVLINK_BW         [s]

and the bound is the largest of them, the least time the card could take
for the step.  ``model_flops`` (6·N·D dense, 6·N_active·D MoE; 2·N·D for a
prefill; 2·N per decoded token) over the traced flops is the usefulness
ratio: what the step computes beyond the algorithm (recompute under
``remat``, attention, replicated work).

Usage: python -m repro_torch.launch.roofline [--dir experiments/dryrun_torch]
       [--mesh h100x1|32x8|2x32x8]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from ..configs import SHAPES, get_arch
from ..models.model import n_active_params
from .mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


def model_flops(arch: str, shape_name: str) -> float:
    """Useful (algorithmic) FLOPs for the whole step, all devices."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    n_act = n_active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        if cfg.family == "audio":
            tokens = shape.global_batch * (shape.seq_len
                                           + shape.seq_len // cfg.dec_ratio)
        return 6.0 * n_act * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        if cfg.family == "audio":
            tokens = shape.global_batch * (shape.seq_len
                                           + shape.seq_len // cfg.dec_ratio)
        return 2.0 * n_act * tokens
    # decode: one token per sequence
    return 2.0 * n_act * shape.global_batch


def _suggest(dom: str, rec: dict) -> str:
    if dom == "collective":
        return ("reduce collective volume: wider model-parallel tiles / "
                "bf16 collectives / overlap FSDP all-gathers with compute")
    if dom == "memory":
        if rec["kind"] == "decode":
            return ("decode is cache-bandwidth-bound: shrink/quantise the KV "
                    "cache or raise batch to amortise weight reads")
        return "fuse elementwise chains and cut remat recompute traffic"
    return ("compute-bound: raise MFU via larger matmul tiles; if the "
            "usefulness ratio is low, fix sharding to remove replicated work")


def terms(oc: dict) -> dict:
    """The three roofline terms of one ``op_cost`` dict, in seconds."""
    return {"compute": oc["dot_flops"] / PEAK_FLOPS_BF16,
            "memory": oc["hbm_bytes"] / HBM_BW,
            "collective": oc["collective_bytes"] / NVLINK_BW}


def analyze_record(rec: dict, chips: int) -> dict:
    oc = rec["op_cost"]
    t = terms(oc)
    dom = max(t, key=t.get)
    mf = model_flops(rec["arch"], rec["shape"])
    return {
        "arch": rec["arch"], "shape": rec["shape"], "family": rec["family"],
        "compute_s": t["compute"], "memory_s": t["memory"],
        "collective_s": t["collective"], "bound_s": t[dom],
        "dominant": dom,
        "model_flops": mf,
        "op_flops_total": oc["dot_flops"] * chips,
        "useful_ratio": mf / max(oc["dot_flops"] * chips, 1.0),
        "mem_gb_per_dev": rec["memory"]["peak_bytes_est"] / 1e9,
        "fits": rec.get("fits"),
        "suggestion": _suggest(dom, rec),
    }


def load_table(dirname: str, mesh: str = "h100x1") -> list:
    rows = []
    for f in sorted(glob.glob(os.path.join(dirname, f"*_{mesh}.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        if not rec.get("ok"):
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "error": rec.get("error", "?")})
            continue
        rows.append(analyze_record(rec, rec["n_devices"]))
    return rows


def render_markdown(rows: list) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant "
           "| useful | GB/dev | fits |\n|---|---|---|---|---|---|---|---|---|")
    out = [hdr]
    for r in rows:
        if "error" in r:
            out.append(f"| {r['arch']} | {r['shape']} | FAIL: {r['error'][:40]} |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.3f} | "
            f"{r['mem_gb_per_dev']:.2f} | {r['fits']} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="h100x1",
                    choices=["h100x1", "32x8", "2x32x8"])
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    rows = load_table(args.dir, args.mesh)
    print(render_markdown(rows))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
