"""The port's hybrid family (zamba2-7b: Mamba2 layers with one shared
attention + MLP block before every ``attn_every`` of them) against the JAX
model, and its two serving lanes against the JAX ``Server`` and
``SlotServer``.

zamba2-7b reduced (d 256, d_inner 512, 16 SSD heads of 32, state 32, chunk
16, 8 attention heads of 32, vocab 512) in two layouts: the reduced
config's own (2 layers, ``attn_every`` 1: g = 2 insertions, no tail) and
``n_layers=5, attn_every=2`` (g = 2, a 1-layer tail), so that ``tail`` and
``ssm_tail`` are held too.  The JAX params are carried into the port.
``kernels`` True turns ``use_flash_attention`` and ``use_ssd_kernel`` on in
both packages: the port takes the kernels' plain versions on the CPU, the
JAX package its Pallas kernels in interpret mode.  Each layout and switch
computes its JAX outputs once, in a module fixture.  Tolerances: f32
rtol = atol = 1e-4, as ``test_torch_mamba.py`` holds the ssm family; bf16
3e-2, the kernel suite's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
from jax.sharding import Mesh                                # noqa: E402

import repro.distributed as jdist                            # noqa: E402
import repro.faults as jfaults                               # noqa: E402
from repro.configs import get_arch                           # noqa: E402
from repro.models import model as JM                         # noqa: E402
from repro_torch.api import ExperimentSpec, ServeJob, run    # noqa: E402
from repro_torch.configs import get_arch as t_get_arch       # noqa: E402
from repro_torch.distributed import (RetryPolicy,            # noqa: E402
                                     SlotConfig, SlotServer)
from repro_torch.faults import ServeFaults                   # noqa: E402
from repro_torch.kernels import flash_attention as FA        # noqa: E402
from repro_torch.kernels import ssd_chunk as SSD             # noqa: E402
from repro_torch.models import model as TM                   # noqa: E402
from repro_torch.tree import tree_leaves_with_path           # noqa: E402
from torch_parity import (assert_tree_close, f32,  # noqa: E402
                          jax_serve, port_init_as_jax, port_params,
                          tree_f32)

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
B, S, STEPS = 2, 32, 4
LAYOUTS = {"g2": {}, "tail": dict(n_layers=5, attn_every=2)}
KERNELS = (("use_flash_attention", True), ("use_ssd_kernel", True))


def _cfgs(layout, kernels=False, dtype="float32"):
    over = dict(remat="none", dtype=dtype, **LAYOUTS[layout])
    if kernels:
        over.update(KERNELS)
    return (get_arch("zamba2-7b").reduced().with_(**over),
            t_get_arch("zamba2-7b").reduced().with_(**over))


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.fixture(scope="module",
                params=[(lay, k) for lay in LAYOUTS for k in (False, True)],
                ids=lambda p: f"{p[0]}-{'kernels' if p[1] else 'plain'}")
def ref(request):
    """The JAX outputs of one layout and switch setting, on f32 params:
    forward logits, prefill logits and cache, STEPS lock-step decode steps
    (logits and the final cache) and 4 ragged decode steps."""
    layout, kernels = request.param
    jcfg, tcfg = _cfgs(layout, kernels)
    jp = tree_f32(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    steps = rng.integers(0, jcfg.vocab, (STEPS, B)).astype(np.int32)
    ctx = S + STEPS
    out = dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=port_params(jp),
               tokens=tokens, steps=steps, ctx=ctx)
    forward = jax.jit(lambda p, t: JM.forward_logits(jcfg, p, t)[0])
    out["forward"] = forward(jp, {"tokens": jnp.asarray(tokens)})
    lg, jc = jax.jit(lambda p, t: JM.prefill(jcfg, p, t, ctx_len=ctx))(
        jp, {"tokens": jnp.asarray(tokens)})
    out["prefill"] = (lg, jc)
    dec = []
    step = jax.jit(lambda p, c, t, pos, n: JM.decode_step(jcfg, p, c, t, pos,
                                                          n),
                   static_argnums=4)
    for i in range(STEPS):
        lg, jc = step(jp, jc, jnp.asarray(steps[i]), jnp.int32(S + i), ctx)
        dec.append(lg)
    out["decode"] = (dec, jc)
    rows, rctx = 3, 16
    jc = JM.init_cache(jcfg, rows, rctx, ragged=True)
    pos = np.array([0, 5, 9], np.int32)
    rtoks = rng.integers(0, jcfg.vocab, (4, rows)).astype(np.int32)
    rag = []
    for i in range(4):
        lg, jc = step(jp, jc, jnp.asarray(rtoks[i]), jnp.asarray(pos + i),
                      rctx)
        rag.append(lg)
    out["ragged"] = (rows, rctx, pos, rtoks, rag, jc)
    return out


def test_param_specs_and_counts_match_jax():
    for layout in LAYOUTS:
        jcfg, tcfg = _cfgs(layout)
        assert TM.n_params(tcfg) == JM.n_params(jcfg)
        assert TM.n_active_params(tcfg) == JM.n_active_params(jcfg)
        jspecs = jax.tree_util.tree_leaves_with_path(
            JM.param_specs(jcfg), is_leaf=lambda s: hasattr(s, "init"))
        tspecs = dict(tree_leaves_with_path(TM.param_specs(tcfg)))
        assert len(tspecs) == len(jspecs)
        for path, js in jspecs:
            ts = tspecs[jax.tree_util.keystr(path)]
            assert (ts.shape, ts.axes, ts.init, ts.dtype) == \
                (js.shape, js.axes, js.init, js.dtype), path
    full = t_get_arch("zamba2-7b")
    assert TM.n_params(full) == JM.n_params(get_arch("zamba2-7b"))
    assert TM._groups(full) == (13, 6, 3)
    assert "tail" in TM.param_specs(full)


def test_forward_matches_jax(ref):
    tl, aux = TM.forward_logits(ref["tcfg"], ref["tp"],
                                {"tokens": torch.from_numpy(ref["tokens"])})
    assert aux == 0.0
    np.testing.assert_allclose(f32(tl), f32(ref["forward"]), **F32_TOL)


def test_prefill_logits_and_cache_match_jax(ref):
    tl, tc = TM.prefill(ref["tcfg"], ref["tp"],
                        {"tokens": torch.from_numpy(ref["tokens"]).long()},
                        ctx_len=ref["ctx"])
    jl, jc = ref["prefill"]
    np.testing.assert_allclose(f32(tl), f32(jl), **F32_TOL)
    assert_tree_close(tc, jc, **F32_TOL)
    spec = TM.cache_specs(ref["tcfg"], B, ref["ctx"])
    assert list(tc) == list(spec)
    assert ("ssm_tail" in tc) == ("tail" in ref["tp"])
    for path, s in tree_leaves_with_path(spec):
        assert dict(tree_leaves_with_path(tc))[path].shape == s.shape, path


def test_lockstep_decode_matches_jax(ref):
    tcfg, tp, ctx = ref["tcfg"], ref["tp"], ref["ctx"]
    _, tc = TM.prefill(tcfg, tp,
                       {"tokens": torch.from_numpy(ref["tokens"]).long()},
                       ctx_len=ctx)
    want, jc = ref["decode"]
    for i in range(STEPS):
        tl, tc2 = TM.decode_step(tcfg, tp, tc,
                                 torch.from_numpy(ref["steps"][i]).long(),
                                 S + i, ctx)
        assert tc2 is tc                               # updated in place
        np.testing.assert_allclose(f32(tl), f32(want[i]),
                                   err_msg=f"step {i}", **F32_TOL)
    assert_tree_close(tc, jc, **F32_TOL)


def test_ragged_decode_matches_jax(ref):
    """Per-row positions against a ragged cache: each row writes its own
    ring slot of every insertion and its own SSM states."""
    tcfg, tp = ref["tcfg"], ref["tp"]
    rows, rctx, pos, rtoks, want, jc = ref["ragged"]
    tc = TM.init_cache(tcfg, rows, rctx, device="cpu", ragged=True)
    assert tc["positions"].shape == (rows, rctx)
    for i in range(4):
        tl, _ = TM.decode_step(tcfg, tp, tc, torch.from_numpy(rtoks[i]).long(),
                               torch.from_numpy(pos + i), rctx)
        np.testing.assert_allclose(f32(tl), f32(want[i]),
                                   err_msg=f"step {i}", **F32_TOL)
    assert_tree_close(tc, jc, **F32_TOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefill_then_decode_equals_forward_at_the_next_position(layout):
    """Inside the port, f32: a prefill of 16 tokens and one decode step at
    position 16 give the forward's logits at position 16.  The forward
    runs over 32 tokens (the SSD chunk, 16, must divide its length); being
    causal, its position 16 reads the first 17."""
    _, tcfg = _cfgs(layout)
    tp = _to_f32(TM.init_params(tcfg, 3, device="cpu"))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab, (B, 32)))
    _, cache = TM.prefill(tcfg, tp, {"tokens": tokens[:, :16]}, ctx_len=17)
    lg, _ = TM.decode_step(tcfg, tp, cache, tokens[:, 16], 16, 17)
    full, _ = TM.forward_logits(tcfg, tp, {"tokens": tokens})
    np.testing.assert_allclose(f32(lg), f32(full[:, 16]), **F32_TOL)


def _to_f32(tree):
    return {k: _to_f32(v) if isinstance(v, dict) else
            (v.float() if v.is_floating_point() else v)
            for k, v in tree.items()}


def _rel_err(got, want) -> float:
    a, b = f32(got), f32(want)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bf16_prefill_and_decode_match_jax():
    """The main path's dtype, with the tail and both kernel switches on:
    the cache's keys, shapes and dtypes equal JAX's, and the logits of the
    prefill and of one decode step agree to 3e-2, the kernel suite's bf16
    tolerance, as a relative L2 error over the logits.  Element by element
    they do not: the two frameworks round bf16 products at other places,
    and over 5 Mamba2 layers and 2 attention insertions that drifts to
    0.08 at |logit| 3.8 (2 % of the vector's norm)."""
    jcfg, tcfg = _cfgs("tail", kernels=True, dtype="bfloat16")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tp = port_params(jp)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab, (B, S)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(tokens)},
                        ctx_len=S + 2)
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(tokens).long()},
                        ctx_len=S + 2)
    assert tl.dtype == torch.bfloat16
    jleaves = dict(tree_leaves_with_path(jc))
    for path, leaf in tree_leaves_with_path(tc):
        want = jleaves[path]
        assert (tuple(leaf.shape), str(leaf.dtype)[6:]) == \
            (want.shape, str(want.dtype)), path
    assert _rel_err(tl, jl) < 3e-2
    nxt = np.argmax(f32(jl), axis=-1).astype(np.int32)
    jl, _ = JM.decode_step(jcfg, jp, jc, jnp.asarray(nxt), jnp.int32(S),
                           S + 2)
    tl, _ = TM.decode_step(tcfg, tp, tc, torch.from_numpy(nxt).long(), S,
                           S + 2)
    assert _rel_err(tl, jl) < 3e-2


def test_kernel_switches_take_the_plain_routes_on_the_cpu(monkeypatch):
    """With both switches on, a CPU prefill calls the flash kernel's plain
    version once per insertion and the SSD kernel's once per Mamba2 layer,
    and launches neither kernel."""
    _, tcfg = _cfgs("tail", kernels=True)
    tp = TM.init_params(tcfg, 0, device="cpu")
    calls = {"flash": 0, "ssd": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(FA, "flash_attention_plain",
                        counted("flash", FA.flash_attention_plain))
    monkeypatch.setattr(SSD, "ssd_chunk_plain",
                        counted("ssd", SSD.ssd_chunk_plain))
    launches = FA.launches, SSD.launches
    TM.prefill(tcfg, tp, {"tokens": torch.zeros((1, 16), dtype=torch.long)})
    assert calls == {"flash": 2, "ssd": 5}
    assert (FA.launches, SSD.launches) == launches


@pytest.mark.parametrize("kernels", [False, True])
def test_lockstep_serve_tokens_identical_to_jax(kernels):
    """``run(ServeJob(arch="zamba2-7b"))`` on the CPU, f32, with the tail,
    against the JAX lock-step lane on the same params and prompts."""
    T, seed = 8, 1
    over = (("dtype", "float32"), ("n_layers", 5), ("attn_every", 2))
    job = ServeJob(arch="zamba2-7b", batch=3, prompt_len=12,
                   arch_overrides=over + (KERNELS if kernels else ()))
    res = run(ExperimentSpec(objective=job, T=T, seed=seed), device="cpu")
    assert res.x.shape == (3, T) and res.x.dtype == np.int32
    assert res.extra["ssd_launches"] == 0 == res.extra["flash_launches"]
    assert res.extra["logits_finite"] and res.extra["arch"] == "zamba2-7b"
    prompts, want = jax_serve(job, T, seed, port_init_as_jax(job.make_arch(), seed))
    np.testing.assert_array_equal(res.extra["prompts"], prompts)
    np.testing.assert_array_equal(res.x, want)


def test_slot_serve_tokens_identical_to_jax():
    """``run(ServeJob(arch="zamba2-7b", n_slots=2))`` on the CPU, f32, with
    the tail, against the JAX ``SlotServer`` on the same params, prompts
    and arrivals: tokens, TTFT and occupancy equal."""
    T, seed = 6, 2
    over = (("dtype", "float32"), ("n_layers", 5), ("attn_every", 2))
    job = ServeJob(arch="zamba2-7b", batch=2, prompt_len=5, n_slots=2,
                   n_requests=5, arrival="poisson:gap=2", steps_per_launch=2,
                   arch_overrides=over)
    res = run(ExperimentSpec(objective=job, T=T, seed=seed), device="cpu")
    tcfg = job.make_arch()
    jsrv = jdist.SlotServer(tcfg, _mesh(), jdist.SlotConfig(
        n_slots=2, ctx_len=5 + T, seed=seed, steps_per_launch=2))
    want = jsrv.serve(port_init_as_jax(tcfg, seed), res.extra["prompts"], T,
                      arrivals=res.extra["arrivals"])
    np.testing.assert_array_equal(res.x, want.tokens)
    np.testing.assert_array_equal(res.extra["ttft_steps"], want.ttft_steps)
    assert res.extra["occupancy"] == want.occupancy
    assert res.extra["compile_counts"] == {"chunk": 0}


def test_prefix_replay_is_refused_by_both_packages():
    """The SSD chunk (16) must divide a retried request's replay, prompt 16
    + e emitted tokens, on the hybrid as on the ssm family: the JAX package
    refuses it with an assertion in ``ssd_chunked``, the port with a
    ``ValueError``.  Without retry the poison is a terminal eviction in
    both, with equal tokens."""
    jcfg, tcfg = _cfgs("tail")
    assert jcfg.ssm_chunk == tcfg.ssm_chunk == 16
    jp = tree_f32(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    slots = dict(n_slots=2, ctx_len=24, steps_per_launch=2)
    jsrv = jdist.SlotServer(jcfg, _mesh(), jdist.SlotConfig(**slots))
    tsrv = SlotServer(tcfg, SlotConfig(**slots), device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab, (2, 16)).astype(np.int32)
    faults = ServeFaults(poisons=((1, 2),))
    jfaults_ = jfaults.ServeFaults(poisons=faults.poisons,
                                   preempt_steps=faults.preempt_steps)
    want = jsrv.serve(jp, prompts, 6, faults=jfaults_)
    got = tsrv.serve(port_params(jp), prompts, 6, faults=faults)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.evictions == want.evictions == {1: 2}
    retry = RetryPolicy(max_attempts=2, backoff_base=2)
    with pytest.raises(AssertionError):
        jsrv.serve(jp, prompts, 6, faults=jfaults_,
                   retry=jdist.RetryPolicy(2, 2, retry.backoff_factor))
    with pytest.raises(ValueError, match="multiple of the chunk 16"):
        tsrv.serve(port_params(jp), prompts, 6, faults=faults, retry=retry)


def test_prefill_refuses_a_prompt_shorter_than_the_conv():
    _, tcfg = _cfgs("g2")
    tp = TM.init_params(tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="ssm_conv - 1"):
        TM.prefill(tcfg, tp, {"tokens": torch.zeros((1, 2), dtype=torch.long)})
