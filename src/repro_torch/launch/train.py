"""Training launcher: --arch × --scheduler × mesh → the trainer backend.

Counterpart of ``repro/launch/train.py``, the production entry point: a
thin CLI over ``repro_torch.api`` whose flags build one ``ExperimentSpec``
+ ``TrainJob`` and hand them to ``TrainerBackend``.  The flags, their
names and their defaults are the JAX launcher's, plus ``--device`` (the
card by default; ``--device cpu`` runs the kernels' plain versions) and
``--mesh``.  ``--reduced`` gives the smoke-sized variant of the arch's
family; every family trains (dense, moe, ssm, hybrid, audio, vlm).

One process trains on one device with no mesh.  Under ``torchrun`` (one
process per card, NCCL; gloo with ``--device cpu``) the processes are the
ranks of a mesh: ``--mesh data=N[,pod=P][,model=M]`` trains data-parallel
over the data axes (the AsGrad workers' batch rows split over them, the
pooled update ZeRO-sharded) and tensor-parallel over the model axis, every
family; ``--host-mesh`` is the JAX law, (data=1, model=world size);
``--multi-pod``, or no mesh flag on several ranks, is the production mesh,
which needs 512 (256) processes: a mesh whose device count is not the
world size exits 2 before any process group starts.  ``--auto-rules``
picks the arch's rules on the mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --device cpu --steps 20 --scheduler shuffled
  torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch qwen2-0.5b --reduced --mesh data=2 --n-groups 4 \\
      --update-impl pallas_pooled --steps 8
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch deepseek-moe-16b --reduced --mesh data=2,model=2 --steps 8
  torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch mamba2-370m --reduced --device cpu --host-mesh --steps 8
"""
from __future__ import annotations

import argparse
import os

#: the flags that pick the mesh and its rules
MESH_FLAGS = ("host_mesh", "multi_pod", "mesh", "auto_rules")


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
                    help="worker groups (0 = the data-axis size, one "
                         "without a mesh)")
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
                    help="this host's mesh, (data=1, model=world size): "
                         "several ranks train tensor-parallel")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the production multi-pod mesh (pod 2 x data 32 "
                         "x model 8): needs 512 processes")
    ap.add_argument("--mesh", default=None,
                    metavar="data=N[,pod=P][,model=M]",
                    help="a mesh over the launcher's processes (torchrun): "
                         "data-parallel over data and pod, tensor-parallel "
                         "over model; its device count must be the world "
                         "size")
    ap.add_argument("--auto-rules", action="store_true",
                    help="per-arch sharding rules on the mesh")
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


def parse_mesh(text: str):
    """``data=N[,pod=P][,model=M]`` → a Mesh (pod, data, model), model 1
    unless given."""
    from .mesh import Mesh

    try:
        sizes = {k: int(v) for k, v in
                 (item.split("=") for item in text.split(","))}
    except ValueError:
        sizes = {}
    if "data" not in sizes or set(sizes) - {"pod", "data", "model"} \
            or min(sizes.values()) < 1:
        raise ValueError(f"--mesh {text!r}: want data=N[,pod=P][,model=M]")
    return Mesh({**({"pod": sizes["pod"]} if "pod" in sizes else {}),
                 "data": sizes["data"], "model": sizes.get("model", 1)})


def choose_mesh(args, ap, world: int):
    """The mesh the flags and the launcher's world size ask for, or None
    (one process, no flag); exits 2 (``ap.error``) on a mesh whose device
    count is not the world size."""
    from .mesh import make_host_mesh, make_production_mesh, mesh_devices

    flag = next((f"--{f.replace('_', '-')}" for f in MESH_FLAGS[:3]
                 if getattr(args, f)), None)
    if args.host_mesh:
        mesh = make_host_mesh(world)
    elif args.multi_pod:
        mesh = make_production_mesh(multi_pod=True)
    elif args.mesh:
        try:
            mesh = parse_mesh(args.mesh)
        except ValueError as e:
            ap.error(str(e))
    elif world > 1:
        flag, mesh = "the production mesh", make_production_mesh()
    else:
        mesh = None
    if mesh is None:
        if args.auto_rules:
            ap.error("--auto-rules picks the sharding rules of a mesh: pass "
                     "--host-mesh or --mesh")
        return None
    n = mesh_devices(mesh)
    if n != world:
        ap.error(f"{flag} {mesh.shape} needs {n} processes, but the launcher "
                 f"started {world} (torchrun --nproc-per-node ...)")
    return mesh


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    mesh = choose_mesh(args, ap, int(os.environ.get("WORLD_SIZE", "1")))
    if mesh is None:
        return _train(args, ap, None)
    import torch.distributed as dist

    from .mesh import ProcessMesh, init_process_group

    init_process_group(args.device)
    try:
        return _train(args, ap, ProcessMesh(mesh.shape))
    finally:
        dist.destroy_process_group()


def _train(args, ap, mesh):
    """One run of the backend on ``mesh`` (a bound mesh, or None); only
    rank 0 prints."""
    from ..api import ExperimentSpec, TrainerBackend, TrainJob
    from ..distributed.sharding import DEFAULT_RULES, auto_rules
    from ..models import n_params
    from .. import checkpoint

    lead = mesh is None or mesh.rank == 0
    out = print if lead else (lambda *a, **k: None)

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

    rules = None
    if mesh is not None:
        rules = auto_rules(cfg, mesh.shape.get("model", 1)) \
            if args.auto_rules else DEFAULT_RULES
    out(f"arch={cfg.name} family={cfg.family} "
          f"params={n_params(cfg)/1e6:.1f}M device={args.device} "
          f"groups={args.n_groups or 'auto'} "
          f"scheduler={args.scheduler} b={args.wait_b} "
          f"delay={0 if args.sync else args.delay_rounds} "
          f"update_impl={args.update_impl} runtime={args.runtime}"
          + (f" K={args.rounds_per_launch} metrics={args.metrics}"
             if args.runtime == "scan" else "")
          + (f" scenario={args.scenario!r}" if args.scenario else "")
          + (f" mesh={mesh.shape}" if mesh is not None else "")
          + ("" if rules is None else " rules=" + (
              "seq_parallel" if "seq" in rules.model_priority
              else "default")))

    if (args.runtime == "scan" and args.ckpt and args.ckpt_every
            and args.ckpt_every % args.rounds_per_launch):
        out(f"warning: --ckpt-every={args.ckpt_every} is not a multiple "
              f"of --rounds-per-launch={args.rounds_per_launch}; scan "
              f"checkpoints hold the END-of-chunk state, so off-boundary "
              f"saves are mislabelled — align the two for exact resume")
    if (args.runtime == "scan" and args.metrics != "chunk"
            and args.ckpt and args.ckpt_every):
        out(f"warning: --metrics={args.metrics} never materialises "
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
            out(f"step {i:5d} loss={m['loss']:.4f} "
                  f"|g|={m['grad_norm']:.3f} "
                  f"part={m['participation']:.2f}", flush=True)
        # the tap transport streams values only (state is None there)
        if state is not None and args.ckpt and args.ckpt_every \
                and (i + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt, state, step=i + 1,
                            meta={"arch": cfg.name}, shardings=shardings)

    recorder = None
    if args.trace_out or args.metrics_out or args.obs_summary:
        from ..obs import Recorder
        recorder = Recorder()

    # only the scan runtime honours --metrics; eager keeps its per-round
    # callbacks (the executor rejects on_step solely for scan + "none")
    strip_on_step = args.metrics == "none" and args.runtime == "scan"
    backend = TrainerBackend(
        device=args.device, on_step=None if strip_on_step else on_step,
        snapshot=snapshot, recorder=recorder, mesh=mesh, rules=rules)
    shardings = backend.state_shardings(spec)
    res = backend.run(spec)
    final = "n/a" if res.losses is None else f"{res.losses[-1]:.4f}"
    tripped = res.extra.get("tripped_round")
    out(f"done in {res.seconds:.1f}s  final loss={final}  "
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
            out("chrome trace:", recorder.export_chrome(args.trace_out))
        if args.metrics_out:
            out("metrics log:", recorder.export_metrics(args.metrics_out))
        if args.obs_summary:
            from ..obs import render_summary
            out(render_summary(res.extra["obs"], trace=res.trace))
    if args.tau_report:
        from ..scenarios import render_report, tau_report
        out(render_report(tau_report(
            res.schedule, args.scheduler,
            concurrency=spec.make_scheduler(
                res.extra["n_groups"]).concurrency(),
            scenario_spec=args.scenario or "")))
    if args.ckpt:
        checkpoint.save(args.ckpt, res.x, step=args.steps,
                        meta={"arch": cfg.name}, shardings=shardings)
        out("final checkpoint:", args.ckpt)
    return res


if __name__ == "__main__":
    main()
