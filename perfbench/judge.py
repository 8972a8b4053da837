"""The numbers that decide ``correct``, each held to its limit.

* Training: the program's first rounds against the reference's, each
  number taken by the worst step or leaf —
  ``loss_gap`` |loss_p − loss_r| / |loss_r| over the rounds;
  ``grad_gap`` |‖g_p‖ − ‖g_r‖| / max(‖g_r‖, median leaf's ‖g_r‖) of the
  gradient the optimizer holds after round 0 (its delayed buffer);
  ``change_gap`` the same of each leaf's change ‖p − p0‖ after the
  rounds, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's in both applied rounds (they move under
  Adam by round-off alone).
* Serving: ``logit_gap``, the widest gap by which a served token's logit
  lies below the reference's best at its position, over a sample of the
  finished requests, teacher-forced on the served tokens.

Limits live in ``perfbench/limits/<cell>.json`` with the readings they
were set from; a number that file does not list is not compared.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
#: leaves whose reference gradient is under this share of the median leaf's
NOUGHT = 1e-3


def limits(cell: str, base: str = HERE) -> dict:
    with open(os.path.join(base, "limits", f"{cell}.json")) as f:
        return {k: v["limit"] for k, v in json.load(f)["numbers"].items()}


def _worst(prog: dict, ref: dict, keys) -> float:
    keys = list(keys)
    med = float(np.median([ref[k] for k in ref]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` as :func:`reference.asgrad.run_rounds` returns
    them (the program's from its state)."""
    loss = max(abs(a - b) / abs(b)
               for a, b in zip(prog["losses"], ref["losses"]))
    med0 = float(np.median(list(ref["grad0"].values())))
    med1 = float(np.median(list(ref["grad1"].values())))
    moved = [k for k in ref["change"]
             if ref["grad0"][k] >= NOUGHT * med0
             or ref["grad1"][k] >= NOUGHT * med1]
    return {"loss_gap": loss,
            "grad_gap": _worst(prog["grad0"], ref["grad0"], ref["grad0"]),
            "change_gap": _worst(prog["change"],
                                 {k: ref["change"][k] for k in moved},
                                 moved)}


def logit_gap(ref_logits, tokens) -> float:
    """The widest ``max(ref) − ref[token]`` over the positions; logits
    (n, V) float32 and tokens (n,) on one device."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, tokens[:, None])[:, 0]
    return float((best - got).max())


def checks(numbers: dict, lims: dict) -> list:
    """``[(name, value, limit)]`` of the numbers the cell's limits hold
    (a number whose readings gave no limit is not compared); a value
    passes when finite and at most its limit."""
    return [(k, float(numbers[k]), float(lim)) for k, lim in lims.items()]


def passed(rows: list) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in rows)
