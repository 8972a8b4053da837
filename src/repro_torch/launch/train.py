"""Training launcher: --arch × --scheduler → the trainer backend, on one
device.

Counterpart of ``repro/launch/train.py``, the production entry point: a
thin CLI over ``repro_torch.api`` whose flags build one ``ExperimentSpec``
+ ``TrainJob`` and hand them to ``TrainerBackend``.  The flags, their
names and their defaults are the JAX launcher's, plus ``--device`` (the
card by default; ``--device cpu`` runs the kernels' plain versions).  The
port runs on one device and has no mesh yet: ``--host-mesh``,
``--multi-pod`` and ``--auto-rules`` are refused (ROADMAP.md queue 1,
item 14).  ``--reduced`` gives the smoke-sized variant of the arch's
family; every family trains (dense, moe, ssm, hybrid, audio, vlm).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --device cpu --steps 20 --scheduler shuffled
"""
from __future__ import annotations

import argparse

#: flags of the JAX launcher that need a mesh, which the port lacks
MESH_FLAGS = ("host_mesh", "multi_pod", "auto_rules")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-sized variant of the arch family")
    ap.add_argument("--device", default="cuda",
                    help="where the run goes: 'cuda' (default) or 'cpu'")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--scheduler", default="shuffled",
                    choices=["pure", "pure_waiting", "random", "fedbuff",
                             "shuffled"])
    ap.add_argument("--wait-b", type=int, default=1)
    ap.add_argument("--pattern", default="poisson")
    ap.add_argument("--n-groups", type=int, default=0,
                    help="worker groups (0 = one group)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--delay-rounds", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--update-impl", default="reference",
                    choices=["reference", "pallas", "pallas_interpret",
                             "pallas_pooled", "pallas_pooled_interpret"],
                    help="server-update execution: the reference elementwise "
                         "path, the fused update kernels per leaf "
                         "('pallas') or once per dtype pool "
                         "('pallas_pooled'); the route follows the device "
                         "(CUDA kernels on the card, their plain versions "
                         "on the CPU); the *_interpret names are aliases")
    ap.add_argument("--delay-adaptive", action="store_true",
                    help="per-round stepsize scale from the schedule's "
                         "delay metadata (removes the tau_max dependence)")
    ap.add_argument("--runtime", default="scan", choices=["scan", "eager"],
                    help="'scan' runs --rounds-per-launch rounds per "
                         "launch (host sync once per chunk); 'eager' one "
                         "round at a time (the parity oracle)")
    ap.add_argument("--rounds-per-launch", type=int, default=8,
                    help="scan runtime: rounds per launch; on_step logging "
                         "and --ckpt-every barriers fire at these chunk "
                         "boundaries")
    ap.add_argument("--metrics", default="chunk",
                    choices=["chunk", "tap", "none"],
                    help="scan metric transport: 'chunk' reads curves back "
                         "at chunk boundaries; 'tap' streams every round "
                         "through a pinned host ring; 'none' keeps metrics "
                         "on the device (final state only).  On 'tap' / "
                         "'none' use --snapshot-every for periodic "
                         "checkpoints")
    ap.add_argument("--scenario", default=None,
                    help="non-stationary world spec (repro_torch.scenarios "
                         "grammar), e.g. 'straggler:k=2,factor=8;"
                         "elastic:every=32,span=8' or a fault world like "
                         "'nan_grad:k=1,every=32' (pair with --guards); "
                         "omit for the stationary world")
    ap.add_argument("--tau-report", action="store_true",
                    help="print the windowed tau-statistics report after "
                         "the run")
    ap.add_argument("--sync", action="store_true")
    ap.add_argument("--host-mesh", action="store_true",
                    help="refused: the port runs on one device (mesh: "
                         "ROADMAP.md queue 1, item 14)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="refused, as --host-mesh")
    ap.add_argument("--auto-rules", action="store_true",
                    help="refused, as --host-mesh")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="barrier-free durability (scan runtime, any "
                         "--metrics): an asynchronous snapshot of the state "
                         "every N rounds (chunk-boundary granularity), "
                         "finalised to checkpoints under "
                         "<--ckpt>/round-XXXXXXXX")
    ap.add_argument("--guards", action="store_true",
                    help="arm the trainer's non-finite guard rails: rounds "
                         "with non-finite loss/grads are skipped on the "
                         "device and the offending workers' stepsize backs "
                         "off and recovers")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace-event JSON of the run")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the schema-versioned JSONL metrics log")
    ap.add_argument("--obs-summary", action="store_true",
                    help="print the observability summary table after the "
                         "run")
    ap.add_argument("--heterogeneity", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    for flag in MESH_FLAGS:
        if getattr(args, flag):
            ap.error(f"--{flag.replace('_', '-')} needs a device mesh; the "
                     "PyTorch port trains on one device (--device) and has "
                     "no mesh yet: ROADMAP.md queue 1, item 14 (multi-GPU)")

    from ..api import ExperimentSpec, TrainerBackend, TrainJob
    from ..models import n_params
    from .. import checkpoint

    job = TrainJob(
        arch=args.arch, reduced=args.reduced,
        remat="none" if args.reduced else None,
        global_batch=args.global_batch, seq_len=args.seq_len,
        heterogeneity=args.heterogeneity,
        delay_rounds=0 if args.sync else args.delay_rounds,
        microbatches=args.microbatches,
        update_impl=args.update_impl,
        guards=args.guards)
    cfg = job.make_arch()
    scheduler = args.scheduler if args.wait_b == 1 \
        else f"{args.scheduler}:b={args.wait_b}"
    stepsize = f"delay_adaptive:{args.lr}" if args.delay_adaptive else args.lr
    spec = ExperimentSpec(
        scheduler=scheduler, timing=f"{args.pattern}:slow=6",
        objective=job, T=args.steps, n_workers=args.n_groups or None,
        stepsize=stepsize, seed=args.seed, runtime=args.runtime,
        rounds_per_launch=args.rounds_per_launch, metrics=args.metrics,
        scenario=args.scenario)

    print(f"arch={cfg.name} family={cfg.family} "
          f"params={n_params(cfg)/1e6:.1f}M device={args.device} "
          f"groups={args.n_groups or 'auto'} "
          f"scheduler={args.scheduler} b={args.wait_b} "
          f"delay={0 if args.sync else args.delay_rounds} "
          f"update_impl={args.update_impl} runtime={args.runtime}"
          + (f" K={args.rounds_per_launch} metrics={args.metrics}"
             if args.runtime == "scan" else "")
          + (f" scenario={args.scenario!r}" if args.scenario else ""))

    if (args.runtime == "scan" and args.ckpt and args.ckpt_every
            and args.ckpt_every % args.rounds_per_launch):
        print(f"warning: --ckpt-every={args.ckpt_every} is not a multiple "
              f"of --rounds-per-launch={args.rounds_per_launch}; scan "
              f"checkpoints hold the END-of-chunk state, so off-boundary "
              f"saves are mislabelled — align the two for exact resume")
    if (args.runtime == "scan" and args.metrics != "chunk"
            and args.ckpt and args.ckpt_every):
        print(f"warning: --metrics={args.metrics} never materialises "
              f"mid-run state on host, so --ckpt-every barriers cannot "
              f"fire; use --snapshot-every for barrier-free periodic "
              f"checkpoints on this transport")

    snapshot = None
    if args.snapshot_every:
        if args.runtime != "scan":
            ap.error("--snapshot-every is a scan-runtime knob")
        if not args.ckpt:
            ap.error("--snapshot-every needs --ckpt (snapshot directory)")
        snapshot = checkpoint.AsyncSnapshotter(
            args.ckpt, args.snapshot_every, meta={"arch": cfg.name})

    def on_step(i, state, m):
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss={m['loss']:.4f} "
                  f"|g|={m['grad_norm']:.3f} "
                  f"part={m['participation']:.2f}", flush=True)
        # the tap transport streams values only (state is None there)
        if state is not None and args.ckpt and args.ckpt_every \
                and (i + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt, state, step=i + 1,
                            meta={"arch": cfg.name})

    recorder = None
    if args.trace_out or args.metrics_out or args.obs_summary:
        from ..obs import Recorder
        recorder = Recorder()

    # only the scan runtime honours --metrics; eager keeps its per-round
    # callbacks (the executor rejects on_step solely for scan + "none")
    strip_on_step = args.metrics == "none" and args.runtime == "scan"
    backend = TrainerBackend(
        device=args.device, on_step=None if strip_on_step else on_step,
        snapshot=snapshot, recorder=recorder)
    res = backend.run(spec)
    final = "n/a" if res.losses is None else f"{res.losses[-1]:.4f}"
    tripped = res.extra.get("tripped_round")
    print(f"done in {res.seconds:.1f}s  final loss={final}  "
          f"tau_max={res.trace['tau_max']}  "
          f"launches={res.extra['launches']} "
          f"host_syncs={res.extra['host_syncs']} "
          f"tap_events={res.extra['tap_events']}"
          + (f" snapshots={res.extra['snapshots']}"
             if args.snapshot_every else "")
          + (f"  BREAKER TRIPPED at round {tripped}"
             if tripped is not None else ""))
    if recorder is not None:
        if args.trace_out:
            print("chrome trace:", recorder.export_chrome(args.trace_out))
        if args.metrics_out:
            print("metrics log:", recorder.export_metrics(args.metrics_out))
        if args.obs_summary:
            from ..obs import render_summary
            print(render_summary(res.extra["obs"], trace=res.trace))
    if args.tau_report:
        from ..scenarios import render_report, tau_report
        print(render_report(tau_report(
            res.schedule, args.scheduler,
            concurrency=spec.make_scheduler(
                res.extra["n_groups"]).concurrency(),
            scenario_spec=args.scenario or "")))
    if args.ckpt:
        checkpoint.save(args.ckpt, res.x, step=args.steps,
                        meta={"arch": cfg.name})
        print("final checkpoint:", args.ckpt)
    return res


if __name__ == "__main__":
    main()
