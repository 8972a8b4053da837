"""Exact AsGrad replay: x_{t+1} = x_t − γ̃ · g_{i_t}(x_{π_t}), on one device.

Counterpart of ``repro/core/simulator.py``.  Given a :class:`Schedule`
(which fixes i_t and π_t), the optimisation is a loop over T steps with a
ring buffer of past iterates: x is written into slot t mod D *before*
x_{π_t} is read from slot π_t mod D (D = τ_max + 1), so a delay of 0 reads
the current iterate.

The device loop.  Every schedule-dependent input — the worker, the ring
slots, the snapshot slot, γ̃ and the mini-batch rows — sits in a device
table indexed by a device-resident step cursor that each step advances.
On CUDA one ``torch.cuda.CUDAGraph`` captures a chunk of ``CHUNK_STEPS``
steps for every γ (and one more graph the ``T mod CHUNK_STEPS`` tail); the
host replays the chunk graph and never reads the device until the run
ends.  A capture that fails raises: nothing falls back to the eager loop.
On the CPU, and on CUDA with ``capture=False`` (the card's parity oracle),
the same step function runs eagerly.

``grad_fn(x, worker, idx)`` is a per-worker gradient oracle (see
``repro_torch.objectives``): ``worker`` is a 0-d device int tensor, and
``idx`` the step's row of the mini-batch table ``batch_idx`` (``None`` for
the paper's full-gradient runs).  The JAX package's PRNG key stream
(threefry) cannot be reproduced by torch generators, so the caller draws
the ``(T, bs)`` table (or injects the JAX package's draws).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from .engine import Schedule

#: steps per captured CUDA graph chunk (one more graph covers the tail)
CHUNK_STEPS = 100


@dataclasses.dataclass
class ReplayResult:
    x: np.ndarray                 # final iterate
    xs: Optional[np.ndarray]      # (T//log_every, d) iterate snapshots
    log_ts: Optional[np.ndarray]  # matching iteration indices
    grad_norms: Optional[np.ndarray]  # ||∇f(x)|| at the snapshots
    losses: Optional[np.ndarray]      # f(x) at the snapshots
    #: how the loop ran: device, runtime ("graph" | "eager"), graph_replays,
    #: chunk_steps, host_syncs (blocking device → host reads) and, on CUDA,
    #: loop_ms (CUDA events around the T steps)
    stats: Optional[dict] = None


def delay_adaptive_stepsizes(gamma: float, delays: np.ndarray, tau_c: int) -> np.ndarray:
    """[Mishchenko et al. 22 / Koloskova et al. 22]-style delay adaptivity:
    γ_t = γ · min(1, τ_C / (τ_t + 1)) — shrinks the step for very stale
    gradients, removing the τ_max dependence (Table 1, footnote b)."""
    d = np.asarray(delays, dtype=np.float64)
    return (gamma * np.minimum(1.0, tau_c / (d + 1.0))).astype(np.float32)


def _server_steps(schedule: Schedule, stepsize) -> np.ndarray:
    """(T,) float32 per-gradient γ̃, computed as the JAX package does."""
    g = np.asarray(stepsize, dtype=np.float32)
    if g.ndim == 0:
        return np.full(schedule.T, float(g) / schedule.wait_b, dtype=np.float32)
    return (g.astype(np.float32) / schedule.wait_b).astype(np.float32)


def _step_table(schedule: Schedule, log_ts: np.ndarray) -> tuple[int, np.ndarray]:
    """(ring size D, (T, 4) int64 rows [worker, write slot, read slot,
    snapshot slot]); steps that log no snapshot write a spare slot."""
    T = schedule.T
    D = max(schedule.tau_max() + 1, 1)
    snap = np.full(T, len(log_ts), dtype=np.int64)
    snap[log_ts] = np.arange(len(log_ts))
    table = np.stack([np.asarray(schedule.workers, dtype=np.int64),
                      np.arange(T, dtype=np.int64) % D,
                      schedule.assign_iters.astype(np.int64) % D,
                      snap], axis=1)
    return D, table


class _Loop:
    """The replay's device state and its step, shared by the graph and the
    eager routes (so they issue the same kernels).  The iterates, rings and
    snapshots of all γ are stacked, since copies are exact; each γ's
    gradient is taken alone, on a stale iterate gathered into a tensor of
    its own, with the exact unbatched shapes, so every γ of a grid is
    bit-identical to a solo replay."""

    def __init__(self, schedule, grad_fn, x0, gam, batch_idx, clip, log_ts,
                 device):
        self.device = device
        self.grad_fn = grad_fn
        D, table = _step_table(schedule, log_ts)
        self.table = torch.from_numpy(table).to(device)
        self.gam = torch.from_numpy(np.ascontiguousarray(gam)).to(device)
        self.batch_idx = (None if batch_idx is None else
                          torch.as_tensor(batch_idx, dtype=torch.int64)
                          .to(device))
        if self.batch_idx is not None and self.batch_idx.shape[0] != schedule.T:
            raise ValueError(f"batch_idx has {self.batch_idx.shape[0]} rows "
                             f"for T = {schedule.T} steps")
        self.clip = (None if clip is None else
                     torch.tensor(clip, dtype=torch.float32, device=device))
        self.x0 = torch.as_tensor(x0, dtype=torch.float32).to(device)
        G, d = gam.shape[1], self.x0.shape[0]
        self.x = self.x0.repeat(G, 1)                          # (G, d)
        self.rings = torch.zeros((G, D, d), device=device)
        self.snaps = torch.zeros((G, len(log_ts) + 1, d), device=device)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=device)

    def reset(self) -> None:
        self.x.copy_(self.x0)
        self.rings.zero_()
        self.snaps.zero_()
        self.cursor.zero_()

    def step(self) -> None:
        row = self.table.index_select(0, self.cursor)[0]
        worker, slot, read_slot, snap_slot = row[0], row[1:2], row[2:3], row[3:4]
        gams = self.gam.index_select(0, self.cursor)[0]
        idx = (None if self.batch_idx is None
               else self.batch_idx.index_select(0, self.cursor)[0])
        self.rings.index_copy_(1, slot, self.x.unsqueeze(1))
        for i in range(self.x.shape[0]):
            x_stale = self.rings[i].index_select(0, read_slot)[0]
            g = self.grad_fn(x_stale, worker, idx)
            if self.clip is not None:
                norm = torch.sqrt(torch.sum(g * g))
                g = g * torch.clamp(self.clip / (norm + 1e-12), max=1.0)
            self.x[i].addcmul_(gams[i], g, value=-1.0)
        self.snaps.index_copy_(1, snap_slot, self.x.unsqueeze(1))
        self.cursor.add_(1)


def _capture(loop: _Loop, T: int, K: int, watch=None) -> list:
    """The CUDA graphs whose replays, in order, run T steps of ``loop``:
    one graph of K steps replayed ⌊T/K⌋ times, then one of the T mod K
    tail steps.  A failed capture raises.  ``watch`` (a
    :class:`repro_torch.obs.CompileWatch`) counts each capture, keyed by
    the number G of stepsizes: ``grid[G,chunk]`` and ``grid[G,tail]``."""
    G = loop.x.shape[0]
    # warm-up on a side stream (cuBLAS handles, workspaces, the allocator),
    # then back to the initial state: capture itself executes nothing
    side = torch.cuda.Stream(loop.device)
    side.wait_stream(torch.cuda.current_stream(loop.device))
    with torch.cuda.stream(side):
        loop.step()
    torch.cuda.current_stream(loop.device).wait_stream(side)
    loop.reset()
    main = torch.cuda.CUDAGraph()
    with torch.cuda.graph(main):
        for _ in range(K):
            loop.step()
    if watch is not None:
        watch.captured(f"grid[{G},chunk]")
    graphs = [main] * (T // K)
    if T % K:
        tail = torch.cuda.CUDAGraph()
        with torch.cuda.graph(tail, pool=main.pool()):
            for _ in range(T % K):
                loop.step()
        if watch is not None:
            watch.captured(f"grid[{G},tail]")
        graphs.append(tail)
    return graphs


def _drive(loop: _Loop, T: int, capture: bool, watch=None):
    """Run T steps of ``loop``: CUDA graph chunks on CUDA (unless
    ``capture=False``), the eager loop otherwise.  Returns (stats, graphs,
    events): the graphs and the two CUDA events around the steps (``None``
    off CUDA) must outlive the queued work."""
    cuda = loop.device.type == "cuda"
    K = max(1, min(CHUNK_STEPS, T))
    graphs = _capture(loop, T, K, watch) if cuda and capture else []
    stats = {"runtime": "graph" if graphs else "eager",
             "graph_replays": len(graphs),
             "chunk_steps": K if graphs else None}
    events = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
              if cuda else None)
    if cuda:
        events[0].record()
    if graphs:
        for graph in graphs:
            graph.replay()
    else:
        for _ in range(T):
            loop.step()
    if cuda:
        events[1].record()
    return stats, graphs, events


def _replay(schedule: Schedule, grad_fn: Callable, x0, gam: np.ndarray, *,
            batch_idx, clip, log_every, full_grad_fn, loss_fn, device,
            capture, watch=None) -> list[ReplayResult]:
    """Replay ``schedule`` for each column of ``gam`` ((T, G) γ̃)."""
    device = resolve_device(device)
    T = schedule.T
    log_ts = np.arange(0, T, log_every)
    loop = _Loop(schedule, grad_fn, x0, gam, batch_idx, clip, log_ts, device)
    stats, graphs, events = _drive(loop, T, capture, watch)

    n_log = len(log_ts)
    parts = []                                   # packed: one read for all
    for x, snap in zip(loop.x, loop.snaps):
        snaps = snap[:n_log]
        parts += [x, snaps.reshape(-1)]
        if full_grad_fn is not None:
            parts.append(torch.linalg.vector_norm(
                torch.func.vmap(full_grad_fn)(snaps), dim=-1))
        if loss_fn is not None:
            parts.append(torch.func.vmap(loss_fn)(snaps).reshape(-1))
    flat = torch.cat(parts).cpu().numpy()        # the run's one host sync
    stats.update(device=str(device), host_syncs=1)
    if events is not None:      # device-timeline span of the T steps
        stats["loop_ms"] = events[0].elapsed_time(events[1])
    del graphs

    d = loop.x0.shape[0]
    pieces = iter(np.split(flat, np.cumsum([p.numel() for p in parts])[:-1]))
    out = []
    for _ in loop.x:
        x, xs = next(pieces), next(pieces).reshape(n_log, d)
        gn = next(pieces) if full_grad_fn is not None else None
        ls = next(pieces) if loss_fn is not None else None
        out.append(ReplayResult(x=x, xs=xs, log_ts=log_ts, grad_norms=gn,
                                losses=ls, stats=dict(stats)))
    return out


def replay_grid(
    schedule: Schedule,
    grad_fn: Callable,
    x0,
    stepsizes,
    *,
    batch_idx=None,
    clip: Optional[float] = None,
    log_every: int = 50,
    full_grad_fn: Optional[Callable] = None,
    loss_fn: Optional[Callable] = None,
    device="cuda",
    capture: bool = True,
    watch=None,
) -> list[ReplayResult]:
    """Replay one schedule under several server stepsizes in one loop.

    The schedule is gradient-value-independent, so a stepsize grid search
    need only build it once; every step advances all γ (one captured graph
    per chunk on CUDA).  Returns one :class:`ReplayResult` per γ, each
    bit-identical to ``replay(schedule, grad_fn, x0, γ, ...)`` on the same
    device: the trajectories are not batched into one product, which would
    change the reduction order.
    """
    gam = np.stack([_server_steps(schedule, g) for g in stepsizes], axis=1)
    return _replay(schedule, grad_fn, x0, gam, batch_idx=batch_idx, clip=clip,
                   log_every=log_every, full_grad_fn=full_grad_fn,
                   loss_fn=loss_fn, device=device, capture=capture,
                   watch=watch)


def replay(
    schedule: Schedule,
    grad_fn: Callable,
    x0,
    stepsize,
    *,
    batch_idx=None,
    clip: Optional[float] = None,
    log_every: int = 50,
    full_grad_fn: Optional[Callable] = None,
    loss_fn: Optional[Callable] = None,
    device="cuda",
    capture: bool = True,
    watch=None,
) -> ReplayResult:
    """Run the schedule on ``device`` (default CUDA).  ``stepsize`` is the
    *server* stepsize γ (a scalar or a (T,) array); waiting variants apply
    γ/wait_b per gradient (Prop. C.2 equivalence).  ``batch_idx`` is the
    (T, bs) mini-batch table of a stochastic ``grad_fn``.  The snapshot at
    ``log_ts[k]`` is the iterate *after* that step.  ``watch`` (a
    :class:`repro_torch.obs.CompileWatch`) counts the graph captures."""
    gam = _server_steps(schedule, stepsize)[:, None]
    return _replay(schedule, grad_fn, x0, gam, batch_idx=batch_idx, clip=clip,
                   log_every=log_every, full_grad_fn=full_grad_fn,
                   loss_fn=loss_fn, device=device, capture=capture,
                   watch=watch)[0]


def run_async_sgd(
    scheduler,
    timing,
    grad_fn,
    x0,
    stepsize,
    T: int,
    **kw,
):
    """Convenience: build the schedule and replay it."""
    from .engine import build_schedule

    sched = build_schedule(scheduler, timing, T)
    return sched, replay(sched, grad_fn, x0, stepsize, **kw)
