"""The port's loss, train step and executor against the JAX package.

qwen2-0.5b reduced (2 layers, d 256, vocab 512).  States cross with
``models.convert.state_from_numpy`` (bf16 as its bits), batches and masks
are numpy.  The JAX trainer runs its reference update throughout: in f32
the port's fused route (the update kernels' plain versions) and its
reference route both agree with it to f32 rounding, since casting the step
or the result to f32 is the identity; the fused kernels themselves are held
to their Pallas twins in ``test_torch_update_kernels.py``.  In float32 (``dtype="float32"`` and f32 params) the port is
held to rtol 1e-4 / atol 1e-5 (losses, grad norms, grads: the two
frameworks reduce in other orders) and the state after the rounds to a
1e-4 relative L2 error per leaf.  One leaf is looser under Adam, the k
bias (1e-2): the softmax nearly cancels it, so its gradient is orders of
magnitude below the others and Adam's normalised step m/√v turns the
frameworks' ulp-level differences in it into visible step differences
(2.5e-3 measured; every other leaf stays below 4e-5).  In bf16 the loss to
rtol 3e-2 and each gradient leaf to a 3e-2 relative L2 error (bf16
activations round at other places in the two frameworks, so elementwise
bounds on single gradient entries say little); the bf16 loss curve of
whole runs is held in ``test_torch_train_backend.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402
from jax.sharding import Mesh                                  # noqa: E402

from repro.configs import get_arch                             # noqa: E402
from repro.distributed import AsyncConfig as JAsyncConfig      # noqa: E402
from repro.distributed import AsyncTrainer as JTrainer         # noqa: E402
from repro.models import model as JM                           # noqa: E402
from repro.optim import OptConfig as JOptConfig                # noqa: E402
from repro_torch.api import ExperimentSpec, TrainJob           # noqa: E402
from repro_torch.api import TrainerBackend                     # noqa: E402
from repro_torch.configs import get_arch as t_get_arch         # noqa: E402
from repro_torch.distributed import AsyncConfig, AsyncTrainer  # noqa: E402
from repro_torch.faults import GuardConfig                     # noqa: E402
from repro_torch.models import model as TM                     # noqa: E402
from repro_torch.models import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.optim import OptConfig                        # noqa: E402
from torch_parity import f32, port_params, tree_f32            # noqa: E402

F32_TOL = dict(rtol=1e-4, atol=1e-5)
B, S, GROUPS = 4, 16, 2
MASKS = np.asarray([[1, 1], [1, 0], [0, 2], [1, 1]], np.float32)


def _cfgs(dtype):
    over = dict(remat="none", dtype=dtype)
    return (get_arch("qwen2-0.5b").reduced().with_(**over),
            t_get_arch("qwen2-0.5b").reduced().with_(**over))


def _tokens(vocab, seed, b=B):
    return np.random.default_rng(seed).integers(0, vocab, (b, S)).astype(
        np.int32)


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    if dtype == "float32":
        jp = tree_f32(jp)
    tp = port_params(jp)
    tok = _tokens(jcfg.vocab, 1)
    w = np.asarray([1.0, 1.0, 0.0, 2.0], np.float32)

    def jloss(p):
        return JM.loss_fn(jcfg, p, {"tokens": jnp.asarray(tok)},
                          example_weights=jnp.asarray(w))[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    leaves = {k: v for k, v in tp.items()}
    tp = jax.tree_util.tree_map(lambda t: t.requires_grad_(True), tp)
    tl, parts = TM.loss_fn(tcfg, tp, {"tokens": torch.from_numpy(tok)},
                           example_weights=torch.from_numpy(w))
    tl.backward()
    assert leaves and float(parts["aux"]) == 0.0
    jflat = jax.tree_util.tree_leaves_with_path(jg)
    if dtype == "float32":
        np.testing.assert_allclose(tl.item(), float(jl), **F32_TOL)
    else:
        np.testing.assert_allclose(tl.item(), float(jl), rtol=3e-2)
    for path, g in jflat:
        node = tp
        for key in path:
            node = node[key.key]
        assert node.grad.dtype == node.dtype
        if dtype == "float32":
            np.testing.assert_allclose(f32(node.grad), f32(g), err_msg=str(path),
                                       **F32_TOL)
        else:
            assert _rel_l2(f32(node.grad), f32(g)) < 3e-2, path


def test_loss_refuses_remat():
    """``remat="full"`` is taken now: the loss and every gradient equal
    ``remat="none"``'s bit for bit (the recomputed activations are the
    same operations on the same inputs; its parity with JAX's
    ``jax.checkpoint``: tests/test_torch_tap_grid.py)."""
    _, tcfg = _cfgs("float32")
    tok = torch.from_numpy(_tokens(tcfg.vocab, 2)).long()
    base = TM.init_params(tcfg, 0, "cpu")
    out = {}
    for remat in ("full", "none"):
        p = jax.tree_util.tree_map(
            lambda t: t.clone().requires_grad_(True), base)
        loss, _ = TM.loss_fn(tcfg.with_(remat=remat), p, {"tokens": tok})
        loss.backward()
        out[remat] = [loss.detach()] + [t.grad for t in
                                        jax.tree_util.tree_leaves(p)]
    for a, b in zip(out["full"], out["none"]):
        assert torch.equal(a, b)


def _pair(dtype, *, opt="adam", impl="reference", momentum=0.0, **acfg):
    """(jax trainer, jitted step, state), (port trainer, step, state) from
    one JAX init state."""
    jcfg, tcfg = _cfgs(dtype)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jt = JTrainer(jcfg, mesh, opt=JOptConfig(name=opt, lr=1e-2,
                                             momentum=momentum,
                                             update_impl="reference"),
                  async_cfg=JAsyncConfig(**acfg))
    jt.n_groups = GROUPS
    js = jt.init_state(jax.random.PRNGKey(0))
    if dtype == "float32":
        js = dict(js, params=tree_f32(js["params"]))
        if "gbuf" in js:
            js["gbuf"] = tree_f32(js["gbuf"])
    tt = AsyncTrainer(tcfg, opt=OptConfig(name=opt, lr=1e-2,
                                          momentum=momentum,
                                          update_impl=impl),
                      async_cfg=AsyncConfig(**acfg), device="cpu")
    tt.n_groups = GROUPS
    ts = state_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    return (jax.jit(jt.train_step_fn()), js), (tt.train_step_fn(), ts)


def _assert_state(ts, js, opt):
    """Counters bitwise, float leaves to a relative L2 error (module doc)."""
    got = state_to_numpy(ts)
    for path, want in jax.tree_util.tree_leaves_with_path(js):
        keys = tuple(k.key for k in path)
        node = got
        for key in keys:
            node = node[key]
        want = np.asarray(want)
        if want.dtype.kind == "i":
            np.testing.assert_array_equal(node, want, err_msg=str(keys))
            continue
        loose = opt == "adam" and keys == ("params", "blocks", "attn", "bk")
        assert _rel_l2(node, want) < (1e-2 if loose else 1e-4), keys


@pytest.mark.parametrize("opt,impl,acfg,scales", [
    ("adam", "reference", dict(delay_rounds=1, microbatches=2),
     (1.0, 0.5, 1.0, 0.25)),
    ("adam", "pallas", dict(delay_rounds=1), None),
    ("adam", "pallas", dict(delay_rounds=0), None),
    ("sgd", "pallas", dict(delay_rounds=1, delay_adaptive=True), None),
], ids=["adam-ref-delayed-microbatch-scale", "adam-fused-delayed",
        "adam-fused-sync", "sgd-fused-delayed-adaptive"])
def test_train_step_matches_jax_f32(opt, impl, acfg, scales):
    (jstep, js), (tstep, ts) = _pair("float32", opt=opt, impl=impl, **acfg)
    p0 = {k: v.clone() for k, v in ts["params"]["blocks"]["mlp"].items()}
    for q, mask in enumerate(MASKS):
        tok = _tokens(512, 10 + q)
        jargs = (js, {"tokens": jnp.asarray(tok)}, jnp.asarray(mask))
        targs = (ts, {"tokens": torch.from_numpy(tok)}, torch.from_numpy(mask))
        if scales is not None:
            jargs += (jnp.float32(scales[q]),)
            targs += (torch.tensor(scales[q]),)
        js, jm = jstep(*jargs)
        ts, tm = tstep(*targs)
        for k in ("loss", "ce", "grad_norm", "participation"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                       err_msg=f"round {q} {k}", **F32_TOL)
        if q == 0 and acfg["delay_rounds"] > 0:
            # the step-0 gate: an empty buffer moves nothing
            for k, v in ts["params"]["blocks"]["mlp"].items():
                assert torch.equal(v, p0[k]), k
    _assert_state(ts, js, opt)


@pytest.mark.parametrize("delay", [1, 0])
def test_momentum_train_step_matches_jax_f32(delay):
    """AsyncTrainer with heavy-ball SGD (momentum 0.9, clip 1.0) on the
    fused route (``sgd_momentum_delayed`` / ``sgd_momentum_step``, their
    plain versions here) against the JAX trainer's reference update on
    injected state, batches and masks: in f32 the two arithmetics agree to
    rounding (clipping the gradient or scaling it in the kernel is the same
    product)."""
    (jstep, js), (tstep, ts) = _pair("float32", opt="sgd", impl="pallas",
                                     momentum=0.9, delay_rounds=delay)
    for q, mask in enumerate(MASKS):
        tok = _tokens(512, 30 + q)
        js, jm = jstep(js, {"tokens": jnp.asarray(tok)}, jnp.asarray(mask))
        ts, tm = tstep(ts, {"tokens": torch.from_numpy(tok)},
                       torch.from_numpy(mask))
        for k in ("loss", "ce", "grad_norm", "participation"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                       err_msg=f"round {q} {k}", **F32_TOL)
    assert ts["opt"]["m"]["embed"].abs().sum() > 0     # the buffer moved
    _assert_state(ts, js, "sgd")


def test_state_crosses_bitwise_both_ways():
    (_, js), (_, ts) = _pair("bfloat16", delay_rounds=1)
    back = state_to_numpy(ts)
    for path, want in jax.tree_util.tree_leaves_with_path(js):
        node = back
        for key in path:
            node = node[key.key]
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            want = want.view(np.uint16)
        assert node.dtype == want.dtype, path
        np.testing.assert_array_equal(node, want, err_msg=str(path))
    assert ts["params"]["embed"].dtype == torch.bfloat16
    assert ts["gbuf"]["embed"].dtype == torch.bfloat16
    assert ts["opt"]["m"]["embed"].dtype == torch.float32
    assert ts["opt"]["count"].dtype == torch.int32
    with pytest.raises(ValueError, match="trainer state"):
        state_to_numpy({"params": {}})


def test_trainer_refuses_unported_knobs():
    """``remat`` is taken now, and a round with it equals one without, bit
    for bit; guards and the channels are taken (their parity with JAX:
    tests/test_torch_faults.py), and guards must be a ``GuardConfig``."""
    _, tcfg = _cfgs("float32")
    with pytest.raises(TypeError, match="GuardConfig"):
        AsyncTrainer(tcfg, async_cfg=AsyncConfig(guards=object()),
                     device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(tcfg.vocab, 3, b=2)).long()}
    stepped = {}
    for remat in ("full", "none"):
        tr = AsyncTrainer(tcfg.with_(remat=remat), device="cpu")
        stepped[remat] = tr.train_step_fn()(tr.init_state(0), batch,
                                            torch.ones(1), grad_density=0.5)
    assert int(stepped["full"][0]["step"]) == 1
    assert np.isfinite(stepped["full"][1]["loss"].item())
    for a, b in zip(jax.tree_util.tree_leaves(stepped["full"]),
                    jax.tree_util.tree_leaves(stepped["none"])):
        assert torch.equal(a, b)
    specs = tr.state_specs()
    assert set(specs) == {"params", "opt", "step", "gbuf"}
    assert specs["opt"]["m"]["embed"].dtype == "float32"
    guarded = AsyncTrainer(tcfg, async_cfg=AsyncConfig(
        guards=GuardConfig()), device="cpu")
    assert guarded.state_specs()["guard"]["health"].shape == (1,)
    assert guarded.init_state(0)["guard"]["health"].tolist() == [1.0]


# ---------------------------------------------------------------------------
# the port's executor: scan ≡ eager, dispatch accounting
# ---------------------------------------------------------------------------
def _spec(**kw):
    job = TrainJob(global_batch=4, seq_len=16, update_impl="pallas",
                   arch_overrides=(("n_layers", 1),))
    base = dict(objective=job, n_workers=2, T=5, stepsize=1e-2,
                rounds_per_launch=2)
    return ExperimentSpec(**{**base, **kw})


def test_scan_equals_eager_and_counts_dispatch():
    scan = TrainerBackend("cpu").run(_spec(runtime="scan"))
    eager = TrainerBackend("cpu").run(_spec(runtime="eager"))
    np.testing.assert_array_equal(scan.losses, eager.losses)
    np.testing.assert_array_equal(scan.grad_norms, eager.grad_norms)
    for a, b in zip(jax.tree_util.tree_leaves(scan.x),
                    jax.tree_util.tree_leaves(eager.x)):
        assert torch.equal(a, b)
    assert (scan.extra["launches"], scan.extra["host_syncs"]) == (3, 1)
    assert (eager.extra["launches"], eager.extra["host_syncs"]) == (5, 5)
    seen = []
    cb = TrainerBackend("cpu", on_step=lambda i, s, m: seen.append(i)).run(
        _spec())
    assert seen == list(range(5)) and cb.extra["host_syncs"] == 3
    np.testing.assert_array_equal(cb.losses, scan.losses)
    none = TrainerBackend("cpu", metrics="none").run(_spec())
    assert none.losses is None and none.extra["host_syncs"] == 0
    for a, b in zip(jax.tree_util.tree_leaves(none.x),
                    jax.tree_util.tree_leaves(scan.x)):
        assert torch.equal(a, b)
    # the tap streams every round's row: the chunk curves bit for bit,
    # no host sync
    tap = TrainerBackend("cpu", metrics="tap").run(_spec())
    np.testing.assert_array_equal(tap.losses, scan.losses)
    np.testing.assert_array_equal(tap.grad_norms, scan.grad_norms)
    assert (tap.extra["launches"], tap.extra["host_syncs"],
            tap.extra["tap_events"]) == (3, 0, 5)
    for a, b in zip(jax.tree_util.tree_leaves(tap.x),
                    jax.tree_util.tree_leaves(scan.x)):
        assert torch.equal(a, b)


def test_adaptive_plan_feeds_delay_scales():
    res = TrainerBackend("cpu").run(_spec(stepsize="delay_adaptive:0.01",
                                          scheduler="fedbuff:b=2"))
    assert res.extra["delay_scales"] is not None
    assert res.extra["plan_summary"]["adaptive"] is True
    assert np.isfinite(res.losses).all()
    assert dataclasses.asdict(res.spec.objective)["update_impl"] == "pallas"
