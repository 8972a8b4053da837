"""Empirical estimators for the paper's theory quantities (Defs 1–4).

Counterpart of ``repro/core/trace.py``: the same estimators over the
port's ``per_worker_grad_fn`` (a tensor on the problem's device per call,
read back to numpy here), plus the schedule summary ``RunResult.trace``
carries.  These let a run check the *bounds used in the proofs* against the
realised schedules — e.g. Prop. C.1 bounds ν² ≤ τ_C·τ_max·ζ²·T for pure
async; we measure the left side directly.
"""
from __future__ import annotations

import numpy as np

from .engine import Schedule


def _grads(per_worker_grad_fn, x, n: int) -> np.ndarray:
    """(n, d) float numpy: ∇f_i(x) for every worker i."""
    return np.stack([per_worker_grad_fn(x, i).detach().cpu().numpy()
                     for i in range(n)])


def heterogeneity_zeta(per_worker_grad_fn, x, n_workers: int) -> float:
    """max_i ||∇f_i(x) − ∇f(x)|| at a point (Assumption 3 witness)."""
    gs = _grads(per_worker_grad_fn, x, n_workers)
    mean = gs.mean(axis=0)
    return float(np.max(np.linalg.norm(gs - mean, axis=-1)))


def sequence_correlation(
    schedule: Schedule,
    per_worker_grad_fn,
    xs_at_chunks,
    tau: int,
) -> np.ndarray:
    """σ²_{k,τ} (Def. 3): for each chunk k of length τ, the max over j of
    ||Σ_{t=kτ}^{kτ+j} (∇f_{i_t}(x_{kτ}) − ∇f(x_{kτ}))||².

    ``xs_at_chunks[k]`` must be the iterate at the chunk start (the replay's
    snapshot log provides these).
    """
    T = schedule.T
    n = schedule.n_workers
    n_chunks = T // tau
    out = np.zeros(n_chunks)
    for k in range(n_chunks):
        gs = _grads(per_worker_grad_fn, xs_at_chunks[k], n)
        gbar = gs.mean(axis=0)
        dev = gs - gbar                       # (n, d)
        idx = schedule.workers[k * tau : (k + 1) * tau]
        partial = np.cumsum(dev[idx], axis=0)  # (τ, d)
        out[k] = float(np.max(np.sum(partial * partial, axis=-1)))
    return out


def delay_variance(
    schedule: Schedule,
    per_worker_grad_fn,
    xs_all,
) -> float:
    """ν² (Def. 4): Σ_t ||Σ_{j=π_t}^{t−1} (∇f_{i_j}(x_{π_j}) − ∇f(x_{π_j}))||².

    ``xs_all[t]`` must be x_t for every t (use replay with log_every=1).
    Cost: one per-worker gradient sweep per iteration — use small T.
    """
    T = schedule.T
    n = schedule.n_workers
    devs = np.zeros((T,) + np.asarray(xs_all[0]).shape)
    for j in range(T):
        pj = int(schedule.assign_iters[j])
        gs = _grads(per_worker_grad_fn, xs_all[pj], n)
        devs[j] = gs[schedule.workers[j]] - gs.mean(axis=0)
    prefix = np.concatenate([np.zeros((1,) + devs.shape[1:]), np.cumsum(devs, axis=0)])
    total = 0.0
    for t in range(T):
        pt = int(schedule.assign_iters[t])
        s = prefix[t] - prefix[pt]
        total += float(np.sum(s * s))
    return total


def summarize(schedule: Schedule) -> dict:
    """One-line schedule summary (Defs 1–2 + balance)."""
    jpw = schedule.jobs_per_worker()
    return {
        "T": schedule.T,
        "tau_max": schedule.tau_max(),
        "tau_avg": round(schedule.tau_avg(), 3),
        "tau_c": schedule.tau_c(),
        "wait_b": schedule.wait_b,
        "jobs_min": int(jpw.min()),
        "jobs_max": int(jpw.max()),
        "jobs_std": round(float(jpw.std()), 3),
    }
