"""Lane ``train``: AsGrad training rounds through the program's own entry,
``AsyncTrainer`` driven by ``PlanExecutor.run_scan``.

Set-up builds one trainer and its state from the harness's weights,
lowers the traffic's schedule (scheduler, timing, workers) into the
program's plan for ``plan_rounds`` rounds, and drives the first rounds
(``checked_rounds``, one launch each, then one launch of the window's
length to warm it) through the window's own call and feed.  What the
program holds after them is kept for the check.  The window is whole
launches of ``rounds_per_launch`` rounds, each ending in its metric read,
until ``--seconds`` have passed, all through one ``PlanExecutor``.  Every
round's batch is ``global_batch`` fresh sequences of ``seq_len`` uniform
token ids; the batches of all ``plan_rounds`` rounds are drawn in set-up,
in one call on the device from the seed, and each round takes its own
from there, as the program's own synthesis does (``feed``).  Then the
reference replays the checked rounds from the same weights and batches
(``perfbench.judge``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import time

import numpy as np
import torch

from perfbench import judge, weights
from perfbench.reference import asgrad
from perfbench.reference.common import Arith


def tokens(seed: int, rounds: int, batch: int, seq: int, vocab: int,
           device) -> torch.Tensor:
    """Every round's batch, ``(rounds, batch, seq)`` uniform int64 ids
    drawn in one call on ``device`` from a generator of its own, seeded
    from ``seed`` apart from the weights'."""
    key = np.random.SeedSequence([int(seed), 1]).generate_state(1,
                                                                np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key[0]))
    return torch.randint(0, vocab, (rounds, batch, seq), generator=gen,
                         device=device, dtype=torch.int64)


def feed(ex, pool: torch.Tensor) -> None:
    """Round q of ``ex`` takes ``pool[q]`` where it lies on the device.

    The executor's public ``batch_fn`` route takes host arrays and copies
    them to the device every round, a copy that waits for the stream
    (``torch.as_tensor`` on pageable memory): host and device then take
    turns each round.  The program's own path draws its batches on the
    device (``make_batch_fn``) and never waits so; this hands the
    harness's batches to the same per-round hook."""
    if not callable(getattr(ex, "_batch_of", None)):
        raise RuntimeError("PlanExecutor no longer takes its batches from "
                           "_batch_of(q); feed the harness's batches anew")
    ex._batch_of = lambda q: {"tokens": pool[q]}


def check_layout(tree: dict, specs) -> None:
    """The harness's weights have the program's leaves, shapes and
    dtypes."""
    from repro_torch.models.specs import torch_dtype
    from repro_torch.tree import tree_map

    want = weights.shapes(tree_map(
        lambda s: torch.empty(s.shape, dtype=torch_dtype(s.dtype),
                              device="meta"), specs))
    got = weights.shapes(tree)
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))[:6]
        raise ValueError(f"the configuration's weights differ from the "
                         f"program's layout: {diff}")


class Session:
    """One trainer, its plan and its state on the device."""

    def __init__(self, ctx, seed: int):
        from repro_torch.api import ExperimentSpec, TrainerBackend, TrainJob
        from repro_torch.distributed import AsyncConfig, AsyncTrainer
        from repro_torch.models import model as M
        from repro_torch.optim import OptConfig
        from repro_torch.runtime import PlanExecutor, compile_plan

        t, c = ctx.traffic, ctx.config
        self.ctx, self.seed, self.run_sizes = ctx, seed, c["run"]
        self.B, self.S = t["global_batch"], t["seq_len"]
        self.n, self.K = t["workers"], t["rounds_per_launch"]
        job = TrainJob(arch=c["registry"], reduced=False, remat=t["remat"],
                       arch_overrides=tuple(sorted(c["run"].items())),
                       global_batch=self.B, seq_len=self.S,
                       delay_rounds=t["delay_rounds"], opt=t["opt"],
                       clip_norm=t["clip_norm"],
                       update_impl=t["update_impl"])
        self.cfg = job.make_arch()
        params = weights.make(self.run_sizes, seed, ctx.device)
        check_layout(params, M.param_specs(self.cfg))
        self.p0 = {p: x.clone() for p, x in weights.leaves(params)}
        self.tr = AsyncTrainer(
            self.cfg, OptConfig(name=t["opt"], lr=t["lr"],
                                beta1=t["beta1"], beta2=t["beta2"],
                                eps=t["eps"], clip_norm=t["clip_norm"],
                                update_impl=t["update_impl"]),
            AsyncConfig(delay_rounds=t["delay_rounds"]), device=ctx.device)
        self.tr.n_groups = self.n
        self.state = self.tr.init_state(params=params)
        del params
        timing = f"{t['timing']['pattern']}:slow={t['timing']['slow']}"
        spec = ExperimentSpec(objective=job, scheduler=t["scheduler"],
                              timing=timing, n_workers=self.n,
                              T=t["plan_rounds"], stepsize=t["lr"],
                              runtime="scan", rounds_per_launch=self.K)
        world = TrainerBackend.world_for(spec, self.n)
        self.plan = compile_plan(world.schedule, job, rounds=t["plan_rounds"],
                                 n_groups=self.n)
        self.batches = tokens(seed, self.plan.rounds, self.B, self.S,
                              self.run_sizes["vocab"], ctx.device)
        self.ex = PlanExecutor(self.tr, self.plan)
        feed(self.ex, self.batches)
        self.q = 0

    def launch(self, rounds: int):
        """The next ``rounds`` rounds as one ``run_scan`` launch, ending in
        its metric read → the launch's losses."""
        lo, hi = self.q, self.q + rounds
        if hi > self.plan.rounds:
            raise RuntimeError(f"the plan holds {self.plan.rounds} rounds; "
                               "raise the traffic's plan_rounds")
        self.ex.plan = dataclasses.replace(      # run_scan ends at its end
            self.plan, masks=self.plan.masks[:hi],
            delay_scales=self.plan.delay_scales[:hi],
            data_keys=self.plan.data_keys[:hi])
        res = self.ex.run_scan(self.state, rounds_per_launch=rounds,
                               start_round=lo)
        self.state, self.q = res.state, hi
        return [float(x) for x in res.metrics["loss"]]

    def leaf_norms(self, tree: dict, minus: dict = None) -> dict:
        out = {}
        for p, x in weights.leaves(tree):
            x = x.float()
            if minus is not None:
                x = x - minus[p].float()
            out[p] = float(torch.linalg.vector_norm(x))
        return out

    def first_rounds(self, n: int) -> dict:
        """Rounds 0 … n−1, one launch each: the losses, the gradient the
        optimizer holds after round 0 (its delayed buffer) and each leaf's
        change after the n rounds, read from the program's state."""
        from repro_torch.optim.pool import unpool_tree

        losses, grad0 = [], None
        for q in range(n):
            losses += self.launch(1)
            if q == 0:
                grad0 = self.leaf_norms(unpool_tree(self.tr.pool_layout, {
                    dk: b["gbuf"] for dk, b in self.state["pools"].items()}))
        change = self.leaf_norms(self.tr.params_of(self.state), self.p0)
        return {"losses": losses, "grad0": grad0, "change": change}

    def free(self) -> None:
        self.state = self.tr = self.plan = self.ex = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, n: int, ar=None, drop_half: bool = False) -> dict:
        """The reference's first ``n`` rounds on the same weights and
        batches (``ar``: its arithmetic; ``drop_half``: a planted fault)."""
        t = self.ctx.traffic
        if t["scheduler"] != "pure" or t["timing"]["pattern"] != "fixed":
            raise ValueError("the reference replays the pure scheduler "
                             "under fixed timing only")
        fam = importlib.import_module(
            f"perfbench.reference.{self.run_sizes['family']}")
        masks = asgrad.pure_masks(self.n, t["timing"]["slow"], n)
        batches = [self.batches[q] for q in range(n)]
        p0 = {}
        for path, x in self.p0.items():
            weights.put(p0, path, x)
        opt = {k: t[k] for k in ("lr", "beta1", "beta2", "eps", "clip_norm")}
        return asgrad.run_rounds(fam.forward, ar or Arith(), p0, batches,
                                 masks, self.run_sizes, opt, drop_half)


def run(ctx) -> dict:
    t = ctx.traffic
    ctx.log(f"lane starts {time.time() - ctx.t0:.1f} s after the process")
    s = Session(ctx, ctx.seed)
    n = t["checked_rounds"]
    prog = s.first_rounds(n)
    s.launch(s.K)                               # the window's launch, warm
    ctx.log(f"set-up {ctx.setup_done():.1f} s")
    rec = {"global_batch": s.B, "seq_len": s.S, "errors": []}
    losses, t0 = [], time.perf_counter()
    while True:
        losses += s.launch(s.K)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    rec["window_s"] = time.perf_counter() - t0
    rec["rounds"] = len(losses)
    if ctx.trace:
        with ctx.traced(rec):
            for _ in range(t["traced_launches"]):
                s.launch(s.K)
        rec["traced_rounds"] = t["traced_launches"] * s.K
        with ctx.traced(rec, "host_trace", host=True):
            s.launch(s.K)
    rec["attempted"] = len(losses)
    rec["failed"] = sum(not math.isfinite(x) for x in losses)
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(ctx.device)
                                if ctx.device.type == "cuda" else 0)
    rec["pool_elements"] = {}
    for path, x in s.p0.items():
        dk = str(x.dtype).replace("torch.", "")
        rec["pool_elements"][dk] = rec["pool_elements"].get(dk, 0) \
            + x.numel()
    s.free()
    t1 = time.perf_counter()
    ref = s.reference(n)
    numbers = judge.train_numbers(prog, ref)
    ctx.log(f"window {rec['window_s']:.1f} s, {rec['rounds']} rounds; "
            f"reference {time.perf_counter() - t1:.1f} s")
    rec["checks"] = judge.checks(numbers, judge.limits(ctx.cell["name"], ctx.base))
    return rec
