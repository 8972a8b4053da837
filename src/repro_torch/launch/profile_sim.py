"""Where the theory tier's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_sim \\
        [--scheduler pure] [--timing fixed:slow=8] [--T 3000]
        [--profile-T 300] [--trace-dir DIR]

Runs the paper's Fig. 1 cell — the w7a stand-in (n = 10 workers, m = 2505,
d = 300), ``LogRegProblem(lam=0.1)`` with full local gradients, the paper's
7-γ grid, ``log_every=100`` — through ``run(ExperimentSpec(...))`` on the
card and prints:

* a cold run, then three warm runs: wall time, the step loop's span on
  the device timeline (CUDA events around the graph replays), graph
  replays and host syncs;
* one warm run of the same spec with ``capture=False`` (the eager loop on
  the card, the graph route's parity oracle);
* a run of ``--profile-T`` steps under ``torch.profiler``: the summed
  device time of its kernels and their count per step, the device's idle
  share over that run's step loop (1 − kernel time / loop span) and over
  that run (1 − kernel time / wall), and the kernels that took most device
  time; then the kernels' time per step scaled to T steps against the last
  warm run's loop span and wall time (the profiler stretches a run, so
  these are the shares of the unprofiled run).

``--trace-dir`` also writes the profiler's Chrome trace there (``sim.json``).
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..api import ExperimentSpec, SimulatorBackend
from ..device import resolve_device
from ..objectives import LogRegProblem, make_libsvm_like

TOP = 12                        # kernels listed
WARM_RUNS = 3
#: the paper's stepsize grid (App. A.1)
PAPER_GRID = (0.005, 0.004, 0.003, 0.002, 0.001, 0.0005, 0.0001)


def fig1_spec(prob, scheduler="pure", timing="fixed:slow=8", T=3000):
    """The Fig. 1 cell of ``chip_smoke.py``'s theory-tier phase."""
    return ExperimentSpec(scheduler=scheduler, timing=timing, objective=prob,
                          T=T, stepsize=PAPER_GRID, log_every=100, seed=0)


def _timed(backend, spec):
    t0 = time.perf_counter()
    res = backend.run(spec)
    return time.perf_counter() - t0, res


def _line(label, wall, res, T):
    e = res.extra
    print(f"{label}: wall {wall * 1e3:.3f} ms, loop span {e['loop_ms']:.3f} "
          f"ms ({T / wall:.0f} steps/s over the run), {e['runtime']} "
          f"route, {e['graph_replays']} graph replays, {e['host_syncs']} "
          f"host syncs; γ = {res.gamma}, final grad norm "
          f"{res.final_grad_norm:.6g}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scheduler", default="pure")
    ap.add_argument("--timing", default="fixed:slow=8")
    ap.add_argument("--T", type=int, default=3000)
    ap.add_argument("--profile-T", type=int, default=300)
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    A, b = make_libsvm_like("w7a", n=10, seed=0)
    prob = LogRegProblem(A, b, lam=0.1, device=device)
    spec = fig1_spec(prob, args.scheduler, args.timing, args.T)
    graph, eager = SimulatorBackend(device), SimulatorBackend(device,
                                                              capture=False)
    print(f"w7a stand-in n={prob.n} m={prob.m} d={prob.d}, "
          f"{args.scheduler} / {args.timing}, T={args.T}, "
          f"{len(PAPER_GRID)} γ")
    _line("cold", *_timed(graph, spec), args.T)
    for i in range(WARM_RUNS):
        warm_wall, warm = _timed(graph, spec)
        _line(f"warm {i}", warm_wall, warm, args.T)
    _line("eager", *_timed(eager, spec), args.T)

    short = fig1_spec(prob, args.scheduler, args.timing, args.profile_T)
    graph.run(short)                                     # warm at this T
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        wall, res = _timed(graph, short)
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    kernels = sum(e.count for e in rows)
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
    span = res.extra["loop_ms"]
    T = args.profile_T
    print(f"profiled, T={T}: wall {wall * 1e3:.3f} ms, loop span "
          f"{span:.3f} ms, kernels {dev_ms:.3f} ms ({kernels} launches, "
          f"{kernels / T:.1f} per step, {dev_ms * 1e3 / T:.2f} µs per "
          f"step); idle share over the loop {1 - dev_ms / span:.3f}, over "
          f"the run {1 - dev_ms / (wall * 1e3):.3f}")
    busy = dev_ms / T * args.T
    print(f"scaled to T={args.T}: kernels {busy:.3f} ms = "
          f"{busy / warm.extra['loop_ms']:.3f} of the last warm loop span, "
          f"idle share over that run {1 - busy / (warm_wall * 1e3):.3f}")
    for e in rows[:TOP]:
        print(f"  {e.self_device_time_total / T:9.3f} µs/step "
              f"{e.count / T:6.1f}x/step  {e.key[:90]}")
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace_dir, "sim.json"))
    torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
