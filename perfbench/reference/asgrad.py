"""The AsGrad round, plainly: the pure scheduler's participation, the
participation-weighted loss and gradient, and the delayed server update.

* **Participation** (the paper's Alg. 2, "pure"): n workers, worker i
  taking s_i = 1 + (slow − 1)·i/(n − 1) time units a job ("fixed"
  timing); each finished worker starts its next job at once.  Gradients
  arrive in the order of their finish times (ties by job number), one a
  round: round q's mask is 1 for the worker whose job finished q-th.
  Worker g owns rows [g·B/n, (g+1)·B/n) of the round's batch.
* **Loss**: next-token cross entropy, Σ w·nll over Σ w·(S − 1) + 1e-6.
* **Delayed server update** (eq. 2, delay 1): round q computes the fresh
  gradient g_q at its params and applies the buffered g_{q−1} (zero at
  round 0, whose step is gated to 0): clip to global norm 1, then Adam
  (β 0.9 / 0.95, ε 1e-8, bias corrections at the step count, which every
  round advances); the new params are stored in the weights' own dtype.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from ..weights import leaves as _paths, put
from .common import F32, exact_f32, weighted_xent


def pure_masks(n: int, slow: float, rounds: int) -> np.ndarray:
    """(rounds, n) participation of the pure scheduler under fixed
    timing."""
    speeds = 1.0 + (slow - 1.0) * np.arange(n) / max(n - 1, 1)
    heap = [(float(speeds[w]), w, w) for w in range(n)]   # (finish, job, w)
    heapq.heapify(heap)
    job = n
    out = np.zeros((rounds, n), np.float32)
    for q in range(rounds):
        finish, _, w = heapq.heappop(heap)
        out[q, w] = 1.0
        heapq.heappush(heap, (finish + float(speeds[w]), job, w))
        job += 1
    return out


def run_rounds(forward, ar, params0: dict, batches: list, masks, r: dict,
               opt: dict, drop_half: bool = False) -> dict:
    """The first ``len(batches)`` rounds from ``params0``.

    Returns the losses, each leaf's gradient norm of round 0 (what the
    optimizer holds after one round), of round 1, and each leaf's change
    ‖p − p0‖ after the rounds.  ``drop_half`` plants a fault: half of the
    participating rows are left out and the mean taken over the rest."""
    with exact_f32():
        dtypes = {p: t.dtype for p, t in _paths(params0)}
        p = {k: t.detach().to(F32) for k, t in _paths(params0)}
        m = {k: torch.zeros_like(t) for k, t in p.items()}
        v = {k: torch.zeros_like(t) for k, t in p.items()}
        buf = {k: torch.zeros_like(t) for k, t in p.items()}
        b1, b2, eps = opt["beta1"], opt["beta2"], opt["eps"]
        losses, gnorms = [], []
        for q, tokens in enumerate(batches):
            n = masks.shape[1]
            rows = tokens.shape[0] // n
            w = torch.as_tensor(np.repeat(masks[q], rows), device=tokens.device)
            keep = torch.nonzero(w > 0)[:, 0]
            if drop_half:
                keep = keep[::2]
            leaves = {k: t.clone().requires_grad_(True) for k, t in p.items()}
            tree: dict = {}
            for k, t in leaves.items():
                put(tree, k, t)
            lg = forward(ar, tree, tokens[keep], r)
            loss = weighted_xent(lg, tokens[keep], w[keep])
            loss.backward()
            del lg
            grad = {k: t.grad.detach() for k, t in leaves.items()}
            losses.append(float(loss.detach()))
            gnorms.append({k: float(torch.linalg.vector_norm(g))
                           for k, g in grad.items()})
            # the delayed update: apply the buffered gradient
            norm = torch.sqrt(sum(torch.sum(g * g) for g in buf.values()))
            clip = torch.clamp(opt["clip_norm"] / (norm + 1e-12), max=1.0)
            c = q + 1
            bc1, bc2 = 1.0 - b1 ** c, 1.0 - b2 ** c
            lr = opt["lr"] * (1.0 if q > 0 else 0.0)
            for k in p:
                g = buf[k] * clip
                m[k] = b1 * m[k] + (1 - b1) * g
                v[k] = b2 * v[k] + (1 - b2) * g * g
                step = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
                p[k] = (p[k] - lr * step).to(dtypes[k]).to(F32)
            buf = grad
        change = {k: float(torch.linalg.vector_norm(
            p[k] - params0_f32)) for k, params0_f32 in
            ((k, t.detach().to(F32)) for k, t in _paths(params0))}
    return {"losses": losses, "grad0": gnorms[0],
            "grad1": gnorms[1] if len(gnorms) > 1 else gnorms[0],
            "change": change}
