"""The audio (seamless-m4t-large-v2) and vlm (pixtral-12b) families: the
port against the JAX package.

Both archs reduced, in f32 (``dtype="float32"``, f32 params carried from
the JAX init with ``models.convert``); tokens, frames and patches are drawn
with numpy from a seed.  ``forward_logits``, ``prefill`` with its cache
(audio's cross k/v have the frames' length: ``cache_specs`` declares
``ctx_len``, as in the JAX package), ``decode_step`` over several
positions, the loss and every gradient, and rounds of the trainer are held
at 1e-4: elementwise rtol 1e-4 / atol 1e-5 where the values are computed
once (logits, cache, loss), a relative L2 error of 1e-4 per gradient leaf
and per param leaf after Adam rounds (the frameworks sum in other orders,
so a few entries near zero are further out than an elementwise rtol
allows).  The ``TrainerBackend`` curve runs on the JAX run's params and
batches at the trainer-curve tolerance (rtol 5e-3).  With
``use_flash_attention`` the port's prefill runs the kernel's plain version
here (non-causal in the encoder and the cross-attention), which must equal
the plain route within f32 rounding.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402
from jax.sharding import Mesh                                  # noqa: E402

from repro.api import ExperimentSpec as JSpec                  # noqa: E402
from repro.api import TrainerBackend as JBackend               # noqa: E402
from repro.api import TrainJob as JTrainJob                    # noqa: E402
from repro.configs import get_arch                             # noqa: E402
from repro.distributed import AsyncConfig as JAsyncConfig      # noqa: E402
from repro.distributed import AsyncTrainer as JTrainer         # noqa: E402
from repro.models import model as JM                           # noqa: E402
from repro.optim import OptConfig as JOptConfig                # noqa: E402
from repro_torch.api import (ExperimentSpec, ServeJob,         # noqa: E402
                             TrainerBackend, TrainJob, run)
from repro_torch.configs import get_arch as t_get_arch         # noqa: E402
from repro_torch.distributed import (AsyncConfig, AsyncTrainer,  # noqa: E402
                                     SlotConfig, SlotServer)
from repro_torch.launch import train as launch_train           # noqa: E402
from repro_torch.models import model as TM                     # noqa: E402
from repro_torch.models import (init_params, param_specs,      # noqa: E402
                                params_from_numpy, params_to_numpy)
from repro_torch.optim import OptConfig                        # noqa: E402
from repro_torch.tree import tree_leaves_with_path             # noqa: E402
from torch_parity import (f32, jax_run_inputs, port_params,    # noqa: E402
                          rel_l2, torch_batch, tree_f32)

ARCHS = ("seamless-m4t-large-v2", "pixtral-12b")
F32_TOL = dict(rtol=1e-4, atol=1e-5)
B, SEQ, STEPS = 2, 16, 3


def _cfgs(arch, **over):
    over = dict(dtype="float32", remat="none", **over)
    return (get_arch(arch).reduced().with_(**over),
            t_get_arch(arch).reduced().with_(**over))


def _batch(cfg, seed, b=B, seq=SEQ):
    """numpy inputs of ``batch_specs``' shapes: tokens, frames / patches."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, sp in JM.batch_specs(cfg, b, seq).items():
        out[k] = (rng.integers(0, cfg.vocab, sp.shape).astype(np.int32)
                  if sp.dtype == "int32"
                  else rng.standard_normal(sp.shape).astype(np.float32))
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.cache
def _jax_serve(arch):
    """JAX's f32 params, inputs, logits, prefill (logits, cache) and the
    decoded logits of ``STEPS`` greedy steps."""
    jcfg, _ = _cfgs(arch)
    jp = tree_f32(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    batch = _batch(jcfg, 1)
    S = batch["tokens"].shape[1]
    ctx = S + STEPS
    logits = jax.jit(lambda p, b: JM.forward_logits(jcfg, p, b)[0])(
        jp, _jb(batch))
    last, cache = jax.jit(lambda p, b: JM.prefill(jcfg, p, b, ctx_len=ctx))(
        jp, _jb(batch))
    step = jax.jit(lambda p, c, t, pos: JM.decode_step(jcfg, p, c, t, pos,
                                                       ctx))
    tok, decoded, c = jnp.argmax(last, -1).astype(jnp.int32), [], cache
    for i in range(STEPS):
        lo, c = step(jp, c, tok, jnp.int32(S + i))
        decoded.append((np.asarray(tok), np.asarray(lo)))
        tok = jnp.argmax(lo, -1).astype(jnp.int32)
    return jp, batch, np.asarray(logits), (np.asarray(last), cache), decoded


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_batch_specs_and_init_law_match_jax(arch):
    """The same param paths, shapes and dtypes at full width and reduced;
    the batch specs of JAX's shapes (audio: frames of seq, tokens
    shortened by dec_ratio; vlm: patches); the new ``(None, "embed")``
    leaves drawn with JAX's fan-in law."""
    for full in (True, False):
        jcfg, tcfg = get_arch(arch), t_get_arch(arch)
        if not full:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        want = {p: (s.shape, s.dtype) for p, s in
                tree_leaves_with_path(JM.param_specs(jcfg))}
        assert {p: (s.shape, s.dtype) for p, s in tree_leaves_with_path(
            param_specs(tcfg))} == want
        assert TM.n_params(tcfg) == JM.n_params(jcfg)
        for b, seq in ((2, 64), (8, 512), (1, 8)):
            jb, tb = JM.batch_specs(jcfg, b, seq), TM.batch_specs(tcfg, b, seq)
            assert {k: (s.shape, s.dtype) for k, s in tb.items()} == \
                {k: (s.shape, s.dtype) for k, s in jb.items()}
    new = "frontend_proj" if arch.startswith("seamless") else "projector"
    jcfg, tcfg = get_arch(arch).reduced(), t_get_arch(arch).reduced()
    want = float(np.asarray(JM.init_params(jcfg, jax.random.PRNGKey(0))[new],
                            np.float32).std())
    got = init_params(tcfg, 0, device="cpu")[new].float().std().item()
    assert abs(got - want) < 0.05 * want
    fan_in = param_specs(tcfg)[new].shape[0]         # frontend / vision dim
    assert abs(got - fan_in ** -0.5) < 0.05 * got


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_jax(arch):
    jp, batch, logits, (last, jcache), decoded = _jax_serve(arch)
    _, tcfg = _cfgs(arch)
    tp = port_params(jp)
    tb = torch_batch(batch)
    np.testing.assert_allclose(f32(TM.forward_logits(tcfg, tp, tb)[0]),
                               logits, **F32_TOL)
    S = batch["tokens"].shape[1]
    tl, tcache = TM.prefill(tcfg, tp, tb, ctx_len=S + STEPS)
    np.testing.assert_allclose(f32(tl), last, **F32_TOL)
    want = dict(tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jcache)))
    got = dict(tree_leaves_with_path(tcache))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        np.testing.assert_allclose(f32(got[path]), w, err_msg=path,
                                   **F32_TOL)
    specs = dict(tree_leaves_with_path(TM.cache_specs(tcfg, B, S + STEPS)))
    if tcfg.family == "audio":
        frames = batch["frames"].shape[1]
        assert got["['cross_k']"].shape[2] == frames != S + STEPS
        # the declared spec keeps JAX's ctx_len rows
        assert specs["['cross_k']"].shape[2] == S + STEPS
        jspecs = JM.cache_specs(_cfgs(arch)[0], B, S + STEPS)
        assert {p: (s.shape, s.dtype) for p, s in specs.items()} == {
            p: (s.shape, s.dtype) for p, s in tree_leaves_with_path(jspecs)}
    for i, (tok, want_lo) in enumerate(decoded):
        lo, tcache = TM.decode_step(tcfg, tp, tcache,
                                    torch.from_numpy(tok).long(), S + i,
                                    S + STEPS)
        np.testing.assert_allclose(f32(lo), want_lo, err_msg=f"step {i}",
                                   **F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_route_equals_plain_route(arch):
    """``use_flash_attention=True`` (the kernel's plain version on the CPU;
    the audio encoder and cross-attention non-causal, Sq ≠ Sk) against
    the plain route: logits and prefill within f32 rounding."""
    jp, batch, _, _, _ = _jax_serve(arch)
    _, tcfg = _cfgs(arch)
    tp, tb = port_params(jp), torch_batch(batch)
    on = tcfg.with_(use_flash_attention=True)
    with torch.no_grad():
        np.testing.assert_allclose(f32(TM.forward_logits(on, tp, tb)[0]),
                                   f32(TM.forward_logits(tcfg, tp, tb)[0]),
                                   **F32_TOL)
        (a, ca), (b, cb) = (TM.prefill(c, tp, tb) for c in (on, tcfg))
    np.testing.assert_allclose(f32(a), f32(b), **F32_TOL)
    for (path, x), (_, y) in zip(tree_leaves_with_path(ca),
                                 tree_leaves_with_path(cb)):
        np.testing.assert_allclose(f32(x), f32(y), err_msg=path, **F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_and_train_rounds_match_jax(arch):
    """Loss and every gradient leaf against ``jax.grad`` (remat none and
    full on the port), then two Adam rounds with delay 1 under
    participation masks against the JAX trainer's reference update."""
    jcfg, tcfg = _cfgs(arch)
    jp = tree_f32(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    batch = _batch(jcfg, 2, b=4)
    w = np.asarray([1.0, 0.0, 1.0, 2.0], np.float32)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: JM.loss_fn(
        jcfg, p, _jb(batch), example_weights=jnp.asarray(w))[0]))(jp)
    want = dict(tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jg)))
    for remat in ("none", "full"):
        tp = jax.tree_util.tree_map(lambda t: t.requires_grad_(True),
                                    port_params(jp))
        loss, parts = TM.loss_fn(tcfg.with_(remat=remat), tp,
                                 torch_batch(batch),
                                 example_weights=torch.from_numpy(w))
        loss.backward()
        assert float(parts["aux"]) == 0.0
        np.testing.assert_allclose(loss.item(), float(jl), **F32_TOL)
        got = dict(tree_leaves_with_path(tp))
        assert sorted(got) == sorted(want)
        for path, g in want.items():
            assert rel_l2(f32(got[path].grad), g) < 1e-4, (remat, path)

    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jt = JTrainer(jcfg, mesh, opt=JOptConfig(name="adam", lr=1e-2,
                                             update_impl="reference"),
                  async_cfg=JAsyncConfig(delay_rounds=1))
    tt = AsyncTrainer(tcfg, opt=OptConfig(name="adam", lr=1e-2,
                                          update_impl="pallas"),
                      async_cfg=AsyncConfig(delay_rounds=1), device="cpu")
    jt.n_groups = tt.n_groups = 2
    js = jt.init_state(jax.random.PRNGKey(0))
    js = dict(js, params=tree_f32(js["params"]), gbuf=tree_f32(js["gbuf"]))
    ts = tt.init_state(0, params=port_params(js["params"]))
    jstep, tstep = jax.jit(jt.train_step_fn()), tt.train_step_fn()
    for q, mask in enumerate(np.asarray([[1, 1], [0, 2], [1, 0]],
                                        np.float32)):
        b = _batch(jcfg, 20 + q, b=4)
        js, jm = jstep(js, _jb(b), jnp.asarray(mask))
        ts, tm = tstep(ts, torch_batch(b), torch.from_numpy(mask))
        for k in ("loss", "ce", "grad_norm", "participation"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                       err_msg=f"round {q} {k}", **F32_TOL)
    got = dict(tree_leaves_with_path(ts["params"]))
    for path, w_ in tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, js["params"])):
        assert rel_l2(f32(got[path]), w_) < 1e-4, path


@pytest.mark.parametrize("arch", ARCHS)
def test_backend_curve_matches_jax(arch):
    """``run(TrainJob(arch=...))``: the port's scan runtime with the pooled
    update on the JAX run's params and batches (tokens and the modality
    draws), against the JAX backend's eager reference run (bf16 params;
    vlm in bf16, audio with f32 activations); and the port's own draws:
    f32 standard normals of the spec's shape."""
    # the audio run with f32 activations (bf16 params): in bf16 its grad
    # norm drifts 5.3e-3 from JAX's by round 3 (the two frameworks round
    # bf16 at other places through the encoder, the decoder and the cross
    # memory), as far as the tolerance itself
    over = (("dtype", "float32"),) if arch.startswith("seamless") else ()
    job = dict(arch=arch, arch_overrides=over, global_batch=4, seq_len=16)
    spec = dict(scheduler="pure", timing="fixed:slow=4", n_workers=2, T=4,
                seed=1, stepsize=1e-2)
    jspec = JSpec(objective=JTrainJob(**job), **spec)
    want = JBackend(runtime="eager").run(jspec)
    params, batches = jax_run_inputs(jspec)
    modal = "frames" if arch.startswith("seamless") else "patches"
    assert batches[0][modal].dtype == np.float32
    got = TrainerBackend(
        "cpu", params_fn=lambda cfg, dev: port_params(params),
        batch_fn=lambda q: torch_batch(batches[q])).run(ExperimentSpec(
            objective=TrainJob(update_impl="pallas_pooled", **job), **spec))
    np.testing.assert_allclose(got.losses, want.losses, rtol=5e-3)
    np.testing.assert_allclose(got.grad_norms, want.grad_norms, rtol=5e-3,
                               atol=1e-6)
    np.testing.assert_array_equal(got.extra["masks"], want.extra["masks"])

    from repro_torch.runtime import compile_plan, make_batch_fn
    tjob = TrainJob(**job)
    cfg = tjob.make_arch()
    masks, sched = TrainerBackend.masks_for(ExperimentSpec(objective=tjob,
                                                           **spec), 2)
    plan = compile_plan(sched, tjob, rounds=4, n_groups=2, seed=1)
    drawn = make_batch_fn(plan, cfg, torch.device("cpu"))(0)
    for k, sp in TM.batch_specs(cfg, 4, 16).items():
        assert tuple(drawn[k].shape) == sp.shape, k
        assert (drawn[k].dtype == torch.float32) == (sp.dtype == "float32")
    x = drawn[modal]
    assert abs(x.mean().item()) < 0.2 and abs(x.std().item() - 1) < 0.2
    assert int(drawn["tokens"].max()) < cfg.vocab
    assert torch.equal(drawn["tokens"], make_batch_fn(
        plan, cfg, torch.device("cpu"))(0)["tokens"])


def test_vlm_prompt_shorter_than_its_patches():
    """A prompt of 1 token is lengthened to the P patches and runs, as in
    the JAX package (and equals it); 2 … P − 1 tokens break JAX's shapes,
    and the port refuses them."""
    jp, _, _, _, _ = _jax_serve("pixtral-12b")
    jcfg, tcfg = _cfgs("pixtral-12b")
    tp = port_params(jp)
    P = jcfg.n_patches
    for S in (1, P - 1):
        batch = _batch(jcfg, 5, seq=16)
        batch["tokens"] = batch["tokens"][:, :S]
        if S == 1:
            want = JM.forward_logits(jcfg, jp, _jb(batch))[0]
            got = TM.forward_logits(tcfg, tp, torch_batch(batch))[0]
            assert got.shape == (B, P, tcfg.vocab) == want.shape
            np.testing.assert_allclose(f32(got), np.asarray(want), **F32_TOL)
            continue
        with pytest.raises(ValueError):
            JM.forward_logits(jcfg, jp, _jb(batch))
        with pytest.raises(ValueError, match="shorter than"):
            TM.forward_logits(tcfg, tp, torch_batch(batch))
        with pytest.raises(ValueError, match="shorter than"):
            TM.prefill(tcfg, tp, torch_batch(batch))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_backend_and_slot_server_refuse(arch, monkeypatch):
    """Neither serving lane takes these families: a ``ServeJob`` carries
    token prompts only.  ``run(ServeJob)`` raises before any parameter is
    made (``init_params`` is never reached), on both lanes; the slot
    server refuses at construction."""
    from repro_torch import models

    def no_init(*a, **k):
        raise AssertionError("params were initialised")

    monkeypatch.setattr(models, "init_params", no_init)
    family = t_get_arch(arch).family
    for job in (ServeJob(arch=arch), ServeJob(arch=arch, n_slots=2)):
        with pytest.raises(NotImplementedError, match=family):
            run(ExperimentSpec(objective=job, T=4), device="cpu")
    with pytest.raises(NotImplementedError, match=family):
        SlotServer(t_get_arch(arch).reduced(),
                   SlotConfig(n_slots=1, ctx_len=8), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_cross_numpy_both_ways(arch):
    """The new leaves (frontend_proj, enc_blocks, enc_norm, the cross
    blocks; projector) cross to numpy and back bit for bit, and a JAX
    tree crosses in."""
    params = init_params(t_get_arch(arch).reduced(), 3, device="cpu")
    back = params_from_numpy(params_to_numpy(params), device="cpu")
    new = ("frontend_proj", "enc_blocks", "enc_norm") \
        if arch.startswith("seamless") else ("projector",)
    assert all(k in back for k in new)
    for (path, a), (_, b) in zip(tree_leaves_with_path(params),
                                 tree_leaves_with_path(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    jp = JM.init_params(get_arch(arch).reduced(), jax.random.PRNGKey(0))
    got = dict(tree_leaves_with_path(params_to_numpy(port_params(jp))))
    for path, w in tree_leaves_with_path(jax.tree_util.tree_map(np.asarray,
                                                                 jp)):
        assert np.array_equal(got[path], w.view(np.uint16)
                              if w.dtype.name == "bfloat16" else w), path


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_on_the_cpu(arch, capsys):
    res = launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--steps", "4", "--n-groups", "2"])
    assert len(res.losses) == 4 and np.isfinite(res.losses).all()
    assert res.extra["device"] == "cpu" and res.extra["arch"] == arch
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "final loss=" in out


@pytest.mark.parametrize("flag", ["--host-mesh", "--multi-pod",
                                  "--auto-rules"])
def test_train_cli_refuses_mesh_flags(flag, capsys, monkeypatch):
    """What the port cannot run is refused with exit 2, naming the flag:
    the multi-pod mesh (512 processes) under a launch of one process;
    ``--auto-rules`` without a mesh asks for one.  The host mesh of a
    launch of two ranks is the audio family's too now (data 1, model 2:
    tensor-parallel, ``tests/test_torch_tp_families_cli.py``), so it is
    taken, not refused."""
    argv = ["--arch", "seamless-m4t-large-v2", "--reduced", "--device",
            "cpu", flag]
    if flag == "--host-mesh":
        ap = launch_train.parser()
        mesh = launch_train.choose_mesh(ap.parse_args(argv), ap, 2)
        assert mesh.shape == {"data": 1, "model": 2}
        return
    with pytest.raises(SystemExit) as e:
        launch_train.main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert flag in err
    if flag == "--auto-rules":
        assert "--host-mesh or --mesh" in err
    else:
        assert "needs 512 processes" in err and "started 1" in err
