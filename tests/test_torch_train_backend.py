"""`repro_torch.api.TrainerBackend` end to end against the JAX backend.

The JAX ``TrainerBackend`` (eager runtime) and the port's run the same spec
on qwen2-0.5b reduced (bf16).  The port takes the JAX run's initial params
and its device-synthesised batches through its two injection hooks
(``params_fn``, ``batch_fn``), so only the arithmetic differs; the JAX side
runs its reference update.  The loss curves agree to rtol 5e-3, the
trainer-curve tolerance of ``tests/test_optim_fused.py:285-286``, and the
masks and delay scales are array-equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402

from repro.api import ExperimentSpec as JSpec                  # noqa: E402
from repro.api import TrainerBackend as JBackend               # noqa: E402
from repro.api import TrainJob as JTrainJob                    # noqa: E402
from repro.models import model as JM                           # noqa: E402
from repro.runtime import compile_plan as j_compile_plan       # noqa: E402
from repro.runtime import make_batch_fn as j_make_batch_fn     # noqa: E402
from repro_torch.api import ExperimentSpec, TrainerBackend, TrainJob, run  # noqa: E402
from repro_torch.kernels import async_update as AU             # noqa: E402
from torch_parity import port_params                           # noqa: E402

JOB = dict(global_batch=4, seq_len=16)
SPEC = dict(scheduler="pure", timing="fixed:slow=4", n_workers=2, T=4,
            seed=1)


def _jax_inputs(jspec, adaptive):
    """The JAX run's initial params and its per-round batches."""
    job = jspec.objective
    cfg = job.make_arch()
    params = JM.init_params(cfg, jax.random.PRNGKey(jspec.seed))
    masks, schedule = JBackend.masks_for(jspec, jspec.n_workers)
    plan = j_compile_plan(schedule, job, rounds=min(jspec.T, masks.shape[0]),
                          n_groups=jspec.n_workers, seed=jspec.seed,
                          adaptive=adaptive)
    batch_of = jax.jit(j_make_batch_fn(plan, cfg))
    batches = [np.asarray(batch_of(jnp.asarray(k))["tokens"])
               for k in plan.data_keys]
    return params, batches


@pytest.mark.parametrize("impl,stepsize,runtime", [
    ("reference", 1e-2, "eager"),
    ("pallas", "delay_adaptive:0.01", "scan"),
])
def test_loss_curve_matches_jax_backend(impl, stepsize, runtime):
    jspec = JSpec(objective=JTrainJob(**JOB), stepsize=stepsize, **SPEC)
    want = JBackend(runtime="eager").run(jspec)
    adaptive = jspec.stepsize.kind == "delay_adaptive"
    params, batches = _jax_inputs(jspec, adaptive)

    spec = ExperimentSpec(objective=TrainJob(update_impl=impl, **JOB),
                          stepsize=stepsize, runtime=runtime, **SPEC)
    got = TrainerBackend("cpu", params_fn=lambda cfg, dev: port_params(params),
                         batch_fn=lambda q: {"tokens": batches[q]}).run(spec)
    np.testing.assert_allclose(got.losses, want.losses, rtol=5e-3)
    np.testing.assert_allclose(got.grad_norms, want.grad_norms, rtol=5e-3,
                               atol=1e-6)
    np.testing.assert_array_equal(got.extra["masks"], want.extra["masks"])
    if adaptive:
        np.testing.assert_array_equal(got.extra["delay_scales"],
                                      want.extra["delay_scales"])
    assert got.trace == want.trace
    assert got.extra["plan_summary"] == want.extra["plan_summary"]
    for k in ("arch", "n_groups", "rounds_per_launch", "metrics_mode",
              "tap_events"):
        assert got.extra[k] == want.extra[k], k
    assert got.extra["update_impl"] == impl
    assert got.extra["update_launches"] == dict.fromkeys(AU.KERNELS, 0)


def test_run_defaults_to_cuda_and_raises_without_it():
    spec = ExperimentSpec(objective=TrainJob(**JOB), **SPEC)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(spec)
    res = run(spec, device="cpu")
    assert res.backend == "trainer" and res.extra["device"] == "cpu"
    assert res.x["params"]["embed"].device.type == "cpu"
    assert len(res.losses) == SPEC["T"] and np.isfinite(res.losses).all()


def test_grid_policy_runs_the_sequential_loop():
    """A grid policy on the scan runtime goes through the grid lane (one
    trainer, one plan with a γ-axis, even under metrics="none"); the eager
    runtime keeps the sequential loop, whose winner equals the lane's bit
    for bit (γ ratio 1/4 is exact in f32); an on_step callback keeps it
    too.  That run is pooled and guarded: guards run in every run of the
    loop (a clean world skips nothing and keeps every health scale at 1),
    and the pooled curve equals the per-leaf reference run's within the
    trainer-curve tolerance of tests/test_optim_pool.py (rtol 5e-3)."""
    spec = ExperimentSpec(objective=TrainJob(**JOB), stepsize=(1e-2, 2.5e-3),
                          metrics="none", **{**SPEC, "T": 3})
    lane = TrainerBackend("cpu").run(spec)
    assert lane.extra["grid_lane"] is True and lane.extra["n_grid"] == 2
    assert lane.extra["plan_summary"]["n_grid"] == 2
    assert lane.gamma in (1e-2, 2.5e-3) and lane.losses is not None
    eager = TrainerBackend("cpu", runtime="eager").run(spec)
    assert "grid_lane" not in eager.extra and eager.gamma == lane.gamma
    np.testing.assert_array_equal(eager.losses, lane.losses)
    seen = []
    pooled = TrainerBackend("cpu", on_step=lambda i, s, m: seen.append(i)).run(
        dataclasses.replace(spec, objective=TrainJob(
            guards=True, update_impl="pallas_pooled", **JOB)))
    assert "grid_lane" not in pooled.extra and seen == [0, 1, 2] * 2
    assert pooled.gamma == lane.gamma
    np.testing.assert_allclose(pooled.losses, eager.losses, rtol=5e-3)
    assert all(m["skipped"] == 0.0 and m["gscale"] == 1.0
               for m in pooled.extra["metrics"])
    assert pooled.x["guard"]["health"].tolist() == [1.0] * SPEC["n_workers"]
