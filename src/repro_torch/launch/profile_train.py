"""Where the training path's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \\
        [--arch qwen2-0.5b] [--n-layers N]
        [--update-impl pallas|pallas_pooled|reference] [--remat none|full]
        [--opt adam|sgd] [--delay-rounds 1] [--rounds 4] [--warmup 2]
        [--trace-dir DIR] [--scenario SPEC] [--guards] [--json-out PATH]
    torchrun --nproc-per-node N -m repro_torch.launch.profile_train \\
        --update-impl pallas_pooled --mesh data=N[,model=M] [...]

Runs the training main path's configuration (qwen2-0.5b at full width,
global batch 8 × 512 tokens, 4 AsGrad workers under the ``pure``
scheduler, Adam with ``delay_rounds=1``, the fused update kernels) through
the same trainer, plan and executor as ``run(ExperimentSpec(objective=
TrainJob(...)))``.  After ``--warmup`` rounds it times ``--rounds`` rounds
as one scan launch with the host clock (the run ends in its metric read,
which waits for the device), then records the same rounds under
``torch.profiler`` and prints, per round:

* wall time, the summed device time of its kernels (device rows only) and
  the device's idle share (``1 − device / wall``); that device time split
  into the compute kernels' and NCCL's (on a mesh NCCL's kernels run on
  their own stream and include each collective's wait for the slowest
  rank, so the compute kernels' time is the rank's busy time);
* the update kernels' device time and their share of the device time;
* the sorts' device time (the sparsifier of a ``sparsify`` scenario);
* the kernels that took most device time.

``--update-impl pallas_pooled`` runs the update through the per-dtype
pools (one kernel launch per round), and ``--remat full`` recomputes each
layer's activations in the backward pass; the printed peak memory is the
one to compare with and without it.

``--arch`` trains another arch of the registry at full width on the same
settings (an audio arch takes 8 × 512 frames and 8 × 128 tokens, a vlm
arch patches in its first positions), and ``--n-layers`` cuts its depth
(a hybrid keeps ``attn_every``: 13 layers of zamba2-7b are two groups of
six and a one-layer tail) for archs whose state at full depth would not
fit one card.

``--scenario`` runs the rounds under a scenario world, its channels
lowered into the plan as ``TrainerBackend`` lowers them, and
``--guards`` arms the guard rails (``TrainJob(guards=True)``).

``--mesh data=N[,pod=P][,model=M]`` runs under ``torchrun``, one process
per card (NCCL): the trainer over the launcher's processes, data-parallel
over the data axes and tensor-parallel over the model axis
(``AsyncTrainer(mesh=...)``), every rank timing the same rounds; rank 0
prints, and adds each collective kind's launches and operand bytes a
round.  ``--json-out`` appends the run's numbers (ms a round, the loss
curve, the mesh, the collectives, the update kernels' launches a round as
their wrappers count them, the state the rank holds) as one JSON line, so
runs at several rank counts can be set side by side.

``--trace-dir`` also writes the profiler's Chrome trace there
(``train.json``).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..api import ExperimentSpec, TrainerBackend, TrainJob
from ..device import resolve_device
from ..distributed import collectives
from ..distributed.async_trainer import held_state_bytes
from ..kernels import async_update as AU
from ..runtime import PlanExecutor, compile_plan

TOP = 15                        # kernels listed
#: substrings of the update kernels' names in csrc/async_update.cu
UPDATE_KERNELS = ("async_update_kernel", "sgd_step_kernel", "adam_kernel")
#: substring of the sort kernels' names (the sparsifier's sorts)
SORT_KERNELS = ("Sort", "sort")


def main_path_spec(update_impl="pallas", opt="adam", delay_rounds=1, T=8,
                   scenario=None, guards=False, remat="none",
                   arch="qwen2-0.5b", n_layers=None):
    """The training main path of ``chip_smoke.py`` (under ``scenario``
    with ``guards``: its faults phase; with ``arch`` and ``n_layers``: its
    families' training phase)."""
    over = (("n_layers", n_layers),) if n_layers else ()
    job = TrainJob(arch=arch, reduced=False, global_batch=8,
                   seq_len=512, update_impl=update_impl, opt=opt,
                   delay_rounds=delay_rounds, guards=guards, remat=remat,
                   arch_overrides=over)
    return ExperimentSpec(objective=job, scheduler="pure",
                          timing="fixed:slow=5", n_workers=4, T=T,
                          stepsize=3e-4, seed=0, runtime="scan",
                          rounds_per_launch=4, scenario=scenario)


def _executor(tr, spec, n_groups, rounds):
    world = TrainerBackend.world_for(spec, n_groups)
    plan = compile_plan(world.schedule, spec.objective, rounds=rounds,
                        n_groups=n_groups, seed=spec.seed,
                        availability=world.availability,
                        zipf_as=world.zipf_as,
                        grad_density=world.grad_density,
                        fault_gain=world.fault_gain)
    return PlanExecutor(tr, plan)


def _report(prof, wall_s: float, rounds: int, print=print) -> dict:
    """Print the profiled rounds' breakdown; → their device, compute-kernel
    and NCCL-kernel ms a round."""
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3 / rounds
    nccl_ms = sum(e.self_device_time_total for e in rows
                  if "nccl" in e.key.lower()) / 1e3 / rounds
    upd_ms = sum(e.self_device_time_total for e in rows
                 if any(k in e.key for k in UPDATE_KERNELS)) / 1e3 / rounds
    sort_ms = sum(e.self_device_time_total for e in rows
                  if any(k in e.key for k in SORT_KERNELS)) / 1e3 / rounds
    wall_ms = wall_s * 1e3 / rounds
    print(f"profiled, per round: wall {wall_ms:.3f} ms, device "
          f"{dev_ms:.3f} ms, idle share {1 - dev_ms / wall_ms:.3f}; update "
          f"kernels {upd_ms:.3f} ms = {upd_ms / dev_ms:.3f} of device time; "
          f"sorts {sort_ms:.3f} ms = {sort_ms / dev_ms:.3f}; compute "
          f"kernels {dev_ms - nccl_ms:.3f} ms, NCCL {nccl_ms:.3f} ms")
    for e in rows[:TOP]:
        print(f"  {e.self_device_time_total / 1e3 / rounds:9.3f} ms/round "
              f"{e.count // rounds:5d}x/round  {e.key[:90]}")
    return {"device_ms": dev_ms, "compute_kernel_ms": dev_ms - nccl_ms,
            "nccl_kernel_ms": nccl_ms, "profiled_wall_ms": wall_s * 1e3 /
            rounds}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the arch's depth (full depth by default)")
    ap.add_argument("--update-impl", default="pallas")
    ap.add_argument("--remat", default="none", choices=("none", "full"))
    ap.add_argument("--opt", default="adam")
    ap.add_argument("--delay-rounds", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--scenario", default=None)
    ap.add_argument("--guards", action="store_true")
    ap.add_argument("--mesh", default=None,
                    metavar="data=N[,pod=P][,model=M]",
                    help="under torchrun: the trainer over the launcher's "
                         "processes, one per card")
    ap.add_argument("--json-out", default=None, metavar="PATH",
                    help="append the run's numbers as one JSON line")
    ap.add_argument("--auto-rules", action="store_true",
                    help="per-arch sharding rules on the mesh (sequence "
                         "parallelism where the heads do not divide the "
                         "model axis)")
    args = ap.parse_args(argv)
    if args.auto_rules and not args.mesh:
        ap.error("--auto-rules picks the sharding rules of a mesh: pass "
                 "--mesh")
    mesh = None
    if args.mesh:
        import torch.distributed as dist

        from .mesh import ProcessMesh, init_process_group
        from .train import parse_mesh

        init_process_group("cuda")
        try:
            mesh = ProcessMesh(parse_mesh(args.mesh).shape)
            _run(args, mesh)
        finally:
            dist.destroy_process_group()
    else:
        _run(args, mesh)


def _run(args, mesh) -> None:
    lead = mesh is None or mesh.rank == 0
    out = print if lead else (lambda *a, **k: None)
    device = resolve_device("cuda")
    spec = main_path_spec(args.update_impl, args.opt, args.delay_rounds,
                          T=args.warmup + args.rounds,
                          scenario=args.scenario, guards=args.guards,
                          remat=args.remat, arch=args.arch,
                          n_layers=args.n_layers)
    rules = None
    if getattr(args, "auto_rules", False):
        from ..configs import get_arch
        from ..distributed.sharding import auto_rules

        rules = auto_rules(get_arch(args.arch), mesh.shape.get("model", 1))
    tr, cfg, n_groups = TrainerBackend(
        device, mesh=mesh, rules=rules)._make_trainer(
        spec, spec.objective, spec.stepsize.gamma, False, device)
    state = tr.init_state(spec.seed)
    state = _executor(tr, spec, n_groups, args.warmup).run_scan(
        state, rounds_per_launch=args.warmup, metrics="none").state
    ex = _executor(tr, spec, n_groups, args.rounds)

    def timed():
        nonlocal state
        t0 = time.perf_counter()
        res = ex.run_scan(state, rounds_per_launch=args.rounds)
        state = res.state
        return time.perf_counter() - t0, res

    before, upd_before = collectives.snapshot(), dict(AU.launches)
    wall, res = timed()
    coll = {k: [n // args.rounds, b // args.rounds]
            for k, (n, b) in collectives.since(before).items()}
    upd = {k: (n - upd_before[k]) // args.rounds
           for k, n in AU.launches.items() if n > upd_before[k]}
    ms = wall * 1e3 / args.rounds
    peak = torch.cuda.max_memory_allocated() / 2**30
    out(f"{cfg.name} L={cfg.n_layers} d={cfg.d_model} batch "
          f"{spec.objective.global_batch}x{spec.objective.seq_len} "
          f"opt={args.opt} delay_rounds={args.delay_rounds} "
          f"update_impl={tr.update_impl} remat={cfg.remat} "
          f"guards={args.guards} scenario="
          f"{args.scenario} mesh={None if mesh is None else mesh.shape} "
          f"seq_parallel={'seq' in tr.rules.model_priority}: "
          f"{ms:.3f} ms per round (warm, {args.rounds} rounds, one launch); "
          f"loss {res.metrics['loss'][0]:.5f} -> "
          f"{res.metrics['loss'][-1]:.5f}; peak memory {peak:.2f} GiB, "
          f"state {held_state_bytes(state) / 2**30:.2f} GiB; update kernel "
          f"launches a round {upd}"
          + (f"; collectives a round {coll}" if mesh is not None else ""))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        wall, _ = timed()
    split = _report(prof, wall, args.rounds, out)
    if args.json_out and lead:
        with open(args.json_out, "a") as f:
            f.write(json.dumps({
                "arch": cfg.name, "n_layers": cfg.n_layers,
                "update_impl": tr.update_impl, "remat": cfg.remat,
                "mesh": None if mesh is None else mesh.shape,
                "seq_parallel": "seq" in tr.rules.model_priority,
                "ranks": tr.ranks, "ms_per_round": ms,
                "losses": res.metrics["loss"].tolist(),
                "grad_norms": res.metrics["grad_norm"].tolist(),
                "collectives_per_round": coll,
                "update_launches_per_round": upd, "peak_gib": peak,
                "state_gib": held_state_bytes(state) / 2**30, **split,
                "device": torch.cuda.get_device_name()}) + "\n")
    if args.trace_dir and lead:
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace_dir, "train.json"))


if __name__ == "__main__":
    main()
