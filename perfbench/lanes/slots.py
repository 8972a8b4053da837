"""Lane ``slots``: continuous-batching serving through the program's own
entry, ``SlotServer.serve``.

Set-up builds one server on the harness's weights and warms it with a
short serve of the cell's own shapes (the captured decode chunk and the
batch-1 prefill at the prompt length).  The window is back-to-back serves
of ``requests_per_serve`` requests, until ``--seconds`` have passed.
Each serve's prompts are fresh uniform token ids from (seed, serve); its
arrivals, on the program's decode-step clock, are ``requests_per_serve``
exponential gaps of mean ``mean_gap_steps`` taken at fixed quantiles, in
an order drawn from (``arrival_seed``, serve): the same Poisson-like
schedule for every seed, so a run's seed changes the prompts and not the
queueing.  Every token is observed through the serve's ``on_token``
stream on the host clock (``metrics/ttft_p95_ms.hostbound.py`` says how
the latencies are read).  After the window a sample of the finished
requests, drawn from the seed, is checked against the reference's
teacher-forced forward pass over prompt and served tokens
(``perfbench.judge.logit_gap``).
"""
from __future__ import annotations

import bisect
import gc
import importlib
import math
import time

import numpy as np
import torch

from perfbench import judge, weights
from perfbench.lanes.train import check_layout
from perfbench.reference.common import Arith, exact_f32


#: the traffic index of the warm-up serve (the window's serves count from 0)
WARM = 2**31


def arrivals(seed: int, serve: int, n: int, mean_gap: float) -> np.ndarray:
    """n arrival steps: exponential gaps at the quantiles (i + ½)/n, in
    an order drawn from (seed, serve)."""
    gaps = -mean_gap * np.log1p(-(np.arange(n) + 0.5) / n)
    order = np.random.default_rng([int(seed) % 2**63, serve]).permutation(n)
    return np.floor(np.cumsum(gaps[order])).astype(np.int64)


def prompts(seed: int, serve: int, n: int, length: int, vocab: int):
    rng = np.random.default_rng([int(seed) % 2**63, serve, 0])
    return rng.integers(0, vocab, (n, length), dtype=np.int64)


class Session:
    def __init__(self, ctx, seed: int):
        from repro_torch.configs import get_arch
        from repro_torch.distributed import SlotConfig, SlotServer
        from repro_torch.models import model as M

        t, c = ctx.traffic, ctx.config
        self.ctx, self.seed, self.r = ctx, seed, c["run"]
        self.cfg = get_arch(c["registry"]).with_(**c["run"],
                                                 **t["arch_switches"])
        t0 = time.perf_counter()
        self.params = weights.make(self.r, seed, ctx.device)
        check_layout(self.params, M.param_specs(self.cfg))
        ctx.sync()
        t1 = time.perf_counter()
        self.P, self.T = t["prompt_len"], t["max_new"]
        self.server = SlotServer(self.cfg, SlotConfig(
            n_slots=t["n_slots"], ctx_len=self.P + self.T,
            temperature=0.0, seed=0, steps_per_launch=t["steps_per_launch"]),
            device=ctx.device)
        ctx.sync()
        ctx.log(f"weights {t1 - t0:.1f} s, server "
                f"{time.perf_counter() - t1:.1f} s")

    def serve(self, n_req: int, index: int, hook=None) -> dict:
        """One serve of ``n_req`` requests (traffic of serve ``index``),
        observed through ``on_token`` on the host clock; ``hook(step)``
        is called with each folded token's decode step."""
        t = self.ctx.traffic
        pr = prompts(self.seed, index, n_req, self.P, self.r["vocab"])
        arr = arrivals(t["arrival_seed"], index, n_req, t["mean_gap_steps"])
        fold, first, last, count = {}, {}, {}, {}
        clock = time.perf_counter

        def on_token(rid, tok, step):
            now = clock()
            fold.setdefault(step, now)
            first.setdefault(rid, now)
            last[rid] = now
            count[rid] = count.get(rid, 0) + 1
            if hook is not None:
                hook(step)

        t0 = clock()
        res = self.server.serve(self.params, pr, self.T,
                                admission=t["admission"], arrivals=arr,
                                on_token=on_token)
        wall = clock() - t0
        steps = sorted(fold)
        ttft, tpot = [], []
        for rid in range(n_req):
            if rid not in first:
                continue
            i = bisect.bisect_left(steps, int(arr[rid])) - 1
            reached = fold[steps[i]] if i >= 0 else t0
            ttft.append(first[rid] - reached)
            if count[rid] > 1:
                tpot.append((last[rid] - first[rid]) / (count[rid] - 1))
        failed = (len(res.evictions) + len(res.timeouts) + len(res.shed)
                  + len(res.drained))
        return {"wall_s": wall, "requests": n_req, "failed": failed,
                "tokens": int((res.tokens >= 0).sum()),
                "ttft_s": ttft, "tpot_s": tpot,
                "decode_steps": res.decode_steps,
                "chunk_device_ms": res.chunk_device_ms,
                "prompts": pr, "served": res.tokens}

    def free(self) -> None:
        self.server = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_logits(self, seqs, ar=None):
        """The reference's logits at the served positions: (n, T, V) for
        the sequences prompt + served tokens (n, P + T)."""
        fam = importlib.import_module(f"perfbench.reference.{self.r['family']}")
        with exact_f32(), torch.no_grad():
            x = torch.as_tensor(seqs, device=self.ctx.device)
            lg = fam.forward(ar or Arith(), self.params, x, self.r,
                             last=self.T + 1)
        return lg[:, :self.T]              # positions P−1 … P+T−2


def sample(rng, serves: list, k: int) -> list:
    """``k`` (serve, request) pairs of finished requests, drawn from
    ``rng``."""
    done = [(i, j) for i, s in enumerate(serves)
            for j in range(s["requests"]) if (s["served"][j] >= 0).all()]
    pick = rng.choice(len(done), size=min(k, len(done)), replace=False)
    return [done[i] for i in sorted(pick)]


def sequences(serves: list, picks: list) -> tuple:
    seqs = np.stack([np.concatenate([serves[i]["prompts"][j],
                                     serves[i]["served"][j]])
                     for i, j in picks])
    toks = np.stack([serves[i]["served"][j] for i, j in picks])
    return seqs, toks


def gap(lg, toks, device) -> float:
    t = torch.as_tensor(toks, device=device).reshape(-1)
    return judge.logit_gap(lg.reshape(-1, lg.shape[-1]), t)


def run(ctx) -> dict:
    t = ctx.traffic
    ctx.log(f"lane starts {time.time() - ctx.t0:.1f} s after the process")
    s = Session(ctx, ctx.seed)
    t0 = time.perf_counter()
    s.serve(t["warm_requests"], WARM)         # captures the chunk, warms
    ctx.log(f"warm serve {time.perf_counter() - t0:.1f} s; set-up "
            f"{ctx.setup_done():.1f} s")
    serves, t0, i = [], time.perf_counter(), 0
    while True:
        serves.append(s.serve(t["requests_per_serve"], i))
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    rec = {"window_s": time.perf_counter() - t0, "errors": []}
    rec["serves"] = [{k: v for k, v in x.items()
                      if k not in ("prompts", "served")} for x in serves]
    if ctx.trace:
        # one more serve, traced from the fold of decode step a to that of
        # step b (the middle of a serve, where the slots are full), then
        # with the host's operations from b to c
        a, b, c = t["traced_steps"]
        plan = [(a, b, ctx.tracer()), (b, c, ctx.tracer(host=True))]

        def hook(step):
            for lo, hi, tr in plan:
                if step >= hi and tr.running:
                    tr.stop()
                elif lo <= step < hi and tr.trace is None \
                        and not tr.running:
                    tr.start()

        s.serve(t["requests_per_serve"], i, hook)
        for _, _, tr in plan:
            if tr.running:
                tr.stop()
        rec["trace"], rec["host_trace"] = (tr.trace for _, _, tr in plan)
    rec["attempted"] = sum(x["requests"] for x in serves)
    rec["failed"] = sum(x["failed"] for x in serves)
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(ctx.device)
                                if ctx.device.type == "cuda" else 0)
    s.free()
    picks = sample(np.random.default_rng([int(ctx.seed) % 2**63, 7]),
                   serves, t["checked_requests"])
    if not picks:
        rec["errors"].append("no request finished in the window")
        rec["checks"] = []
        return rec
    seqs, toks = sequences(serves, picks)
    t1 = time.perf_counter()
    g = gap(s.reference_logits(seqs), toks, ctx.device)
    ctx.log(f"window {rec['window_s']:.1f} s, {len(serves)} serves; "
            f"reference {time.perf_counter() - t1:.1f} s")
    rec["checks"] = judge.checks({"logit_gap": g},
                                 judge.limits(ctx.cell["name"], ctx.base))
    if not math.isfinite(g):
        rec["errors"].append("the reference's logits are not finite")
    return rec
