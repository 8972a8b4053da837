"""The port's MoE family (deepseek-moe-16b: the dense attention with a
capacity-dispatched top-k MoE of SwiGLU experts plus shared experts) and
``layers.moe_router`` / ``moe_ffn`` against the JAX package, and its two
serving lanes against the JAX ``Server`` and ``SlotServer``.

deepseek-moe-16b reduced: 2 layers, d 256, 8 heads of 32, 4 experts of
width 128, top-2, one shared expert, vocab 512.  The JAX params are carried
into the port.  ``flash`` True turns ``use_flash_attention`` on in both
packages (the port's plain version on the CPU, the JAX Pallas kernel in
interpret mode); each setting computes its JAX outputs once, in a module
fixture.  Tolerances: f32 rtol = atol = 1e-4, as the dense family is held
(``test_torch_model.py``); bf16 3e-2, the kernel suite's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
from jax.sharding import Mesh                                # noqa: E402

import repro.distributed as jdist                            # noqa: E402
from repro.configs import get_arch                           # noqa: E402
from repro.models import layers as JL                        # noqa: E402
from repro.models import model as JM                         # noqa: E402
from repro_torch.api import ExperimentSpec, ServeJob, run    # noqa: E402
from repro_torch.configs import get_arch as t_get_arch       # noqa: E402
from repro_torch.kernels import flash_attention as FA        # noqa: E402
from repro_torch.models import layers as TL                  # noqa: E402
from repro_torch.models import model as TM                   # noqa: E402
from repro_torch.tree import tree_leaves_with_path           # noqa: E402
from torch_parity import (assert_tree_close, f32,  # noqa: E402
                          jax_serve, pair, port_init_as_jax, port_params,
                          randn, tree_f32)

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
B, S, STEPS = 2, 16, 4


def _cfgs(flash=False, dtype="float32", **over):
    over = dict(remat="none", dtype=dtype, use_flash_attention=flash, **over)
    return (get_arch("deepseek-moe-16b").reduced().with_(**over),
            t_get_arch("deepseek-moe-16b").reduced().with_(**over))


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


# ---------------------------------------------------------------------------
# moe_router / moe_ffn alone
# ---------------------------------------------------------------------------
def _moe_inputs(rng, B_, S_, d, E, f, dtype, router_bias=None):
    x = randn(rng, B_, S_, d)
    w_router = randn(rng, d, E) / np.sqrt(d)
    if router_bias is not None:       # a constant feature carries a bias
        x[..., 0] = 1.0
        w_router[0] = router_bias
    ws = [randn(rng, E, d, f) / np.sqrt(d), randn(rng, E, d, f) / np.sqrt(d),
          randn(rng, E, f, d) / np.sqrt(f)]
    xs = pair(x, dtype)
    routers = pair(w_router.astype(np.float32), "float32")
    wts = [pair(w, dtype) for w in ws]
    return ((xs[0], routers[0], *(w[0] for w in wts)),
            (xs[1], routers[1], *(w[1] for w in wts)))


def _routed_and_kept(x, w_router, E, k, cf):
    """(routed (token, expert) pairs, pairs within their expert's
    capacity), from the port's router and dispatch rule."""
    T = x.shape[0] * x.shape[1]
    w, ids, _ = TL.moe_router(x.reshape(T, -1), w_router, k)
    C = min(int(np.ceil(T * k / E * cf)), T)
    w_full = torch.zeros((T, E)).scatter_(1, ids, w)
    _, picked = TL._top_k(w_full.t(), C)
    kept = sum(int((w_full[picked[e], e] > 0).sum()) for e in range(E))
    return T * k, kept


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "cf0.5-drops"])
def test_moe_ffn_matches_jax(dtype, cf):
    """y and the aux loss; at capacity factor 0.5 some routed tokens are
    dropped (the test asserts that they are)."""
    rng = np.random.default_rng(0)
    E, k = 4, 2
    jin, tin = _moe_inputs(rng, 2, 16, 64, E, 32, dtype)
    jy, jaux = JL.moe_ffn(*jin, k, cf)
    ty, taux = TL.moe_ffn(*tin, k, cf)
    assert ty.dtype == tin[0].dtype and ty.shape == tin[0].shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(f32(ty), f32(jy), **tol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    routed, kept = _routed_and_kept(tin[0].float(), tin[1], E, k, cf)
    assert (kept < routed) == (cf < 1)


def test_moe_router_matches_jax():
    rng = np.random.default_rng(1)
    x, w = randn(rng, 24, 64), randn(rng, 64, 8) / 8
    jw, jids, jaux = JL.moe_router(jnp.asarray(x), jnp.asarray(w), 3)
    tw, tids, taux = TL.moe_router(torch.from_numpy(x), torch.from_numpy(w), 3)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **F32_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_zero_weight_ties_change_nothing(monkeypatch):
    """Top-1 over 8 experts, 16 tokens, capacity 8: every token routes to
    expert 0 or 1, so the other experts fill their capacity with tokens of
    routing weight 0, all tied.  ``lax.top_k`` takes the lowest indices,
    as the port's stable sort does; ``torch.topk`` takes others (asserted).
    Those picks add exactly 0, so y is the same bits either way and equals
    JAX's."""
    rng = np.random.default_rng(2)
    E, k, cf = 8, 1, 4.0
    bias = np.array([40.0, 40.0] + [-40.0] * 6, np.float32)
    jin, tin = _moe_inputs(rng, 1, 16, 32, E, 16, "float32", bias)
    T = 16
    w, ids, _ = TL.moe_router(tin[0].reshape(T, -1), tin[1], k)
    assert set(ids.flatten().tolist()) <= {0, 1}
    w_full = torch.zeros((T, E)).scatter_(1, ids, w)
    C = min(int(np.ceil(T * k / E * cf)), T)
    stable = TL._top_k(w_full.t(), C)[1]
    other = torch.topk(w_full.t(), C)[1]
    jidx = np.asarray(jax.lax.top_k(jnp.asarray(w_full.t().numpy()), C)[1])
    np.testing.assert_array_equal(stable.numpy(), jidx)
    assert not torch.equal(stable[2:], other[2:])     # the ties differ

    y = TL.moe_ffn(*tin, k, cf)[0]
    jy = JL.moe_ffn(*jin, k, cf)[0]
    np.testing.assert_allclose(f32(y), f32(jy), **F32_TOL)
    monkeypatch.setattr(TL, "_top_k", lambda t, n: torch.topk(t, n))
    np.testing.assert_array_equal(TL.moe_ffn(*tin, k, cf)[0].numpy(),
                                  y.numpy())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[False, True],
                ids=["plain", "flash"])
def ref(request):
    """The JAX outputs of one switch setting on f32 params: forward logits
    and aux, the loss, prefill logits and cache, STEPS lock-step decode
    steps and 4 ragged decode steps."""
    jcfg, tcfg = _cfgs(flash=request.param)
    jp = tree_f32(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    steps = rng.integers(0, jcfg.vocab, (STEPS, B)).astype(np.int32)
    ctx = S + STEPS
    batch = {"tokens": jnp.asarray(tokens)}
    out = dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=port_params(jp),
               tokens=tokens, steps=steps, ctx=ctx)
    out["forward"] = jax.jit(lambda p, b: JM.forward_logits(jcfg, p, b))(
        jp, batch)
    out["loss"] = jax.jit(lambda p, b: JM.loss_fn(jcfg, p, b))(jp, batch)
    lg, jc = jax.jit(lambda p, b: JM.prefill(jcfg, p, b, ctx_len=ctx))(
        jp, batch)
    out["prefill"] = (lg, jc)
    step = jax.jit(lambda p, c, t, pos, n: JM.decode_step(jcfg, p, c, t, pos,
                                                          n),
                   static_argnums=4)
    dec = []
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
    for jcfg, tcfg in (_cfgs(), (get_arch("deepseek-moe-16b"),
                                 t_get_arch("deepseek-moe-16b"))):
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
    spec = TM.param_specs(t_get_arch("deepseek-moe-16b"))
    assert spec["blocks"]["moe"]["router"].dtype == "float32"
    assert "norm" not in spec["blocks"]["moe"]["shared"]


def test_forward_aux_and_loss_match_jax(ref):
    batch = {"tokens": torch.from_numpy(ref["tokens"])}
    tl, taux = TM.forward_logits(ref["tcfg"], ref["tp"], batch)
    jl, jaux = ref["forward"]
    np.testing.assert_allclose(f32(tl), f32(jl), **F32_TOL)
    assert taux.dtype == torch.float32 and float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    loss, parts = TM.loss_fn(ref["tcfg"], ref["tp"], batch)
    jloss, jparts = ref["loss"]
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(parts["aux"]), float(jparts["aux"]),
                               rtol=1e-5)


def test_prefill_logits_and_cache_match_jax(ref):
    tl, tc = TM.prefill(ref["tcfg"], ref["tp"],
                        {"tokens": torch.from_numpy(ref["tokens"]).long()},
                        ctx_len=ref["ctx"])
    jl, jc = ref["prefill"]
    np.testing.assert_allclose(f32(tl), f32(jl), **F32_TOL)
    assert_tree_close(tc, jc, **F32_TOL)
    assert list(tc) == list(TM.cache_specs(ref["tcfg"], B, ref["ctx"]))


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
        assert tc2 is tc
        np.testing.assert_allclose(f32(tl), f32(want[i]),
                                   err_msg=f"step {i}", **F32_TOL)
    assert_tree_close(tc, jc, **F32_TOL)


def test_ragged_decode_matches_jax(ref):
    """Per-row positions: the rows share one dispatch (capacity couples
    them), as in the JAX package."""
    tcfg, tp = ref["tcfg"], ref["tp"]
    rows, rctx, pos, rtoks, want, jc = ref["ragged"]
    tc = TM.init_cache(tcfg, rows, rctx, device="cpu", ragged=True)
    for i in range(4):
        tl, _ = TM.decode_step(tcfg, tp, tc, torch.from_numpy(rtoks[i]).long(),
                               torch.from_numpy(pos + i), rctx)
        np.testing.assert_allclose(f32(tl), f32(want[i]),
                                   err_msg=f"step {i}", **F32_TOL)
    assert_tree_close(tc, jc, **F32_TOL)


def test_prefill_then_decode_equals_forward_at_the_next_position():
    """Inside the port, f32, at a capacity factor of E / k (C = T: no token
    is dropped, so a decode step's one-token dispatch sees what the
    forward's dispatch does): a prefill of S tokens and one decode step at
    position S give the forward's logits at position S."""
    _, tcfg = _cfgs()
    tcfg = tcfg.with_(capacity_factor=tcfg.n_experts / tcfg.top_k)
    tp = port_params(tree_f32(JM.init_params(_cfgs()[0],
                                             jax.random.PRNGKey(3))))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab, (B, S + 1)))
    _, cache = TM.prefill(tcfg, tp, {"tokens": tokens[:, :S]}, ctx_len=S + 1)
    lg, _ = TM.decode_step(tcfg, tp, cache, tokens[:, S], S, S + 1)
    full, _ = TM.forward_logits(tcfg, tp, {"tokens": tokens})
    np.testing.assert_allclose(f32(lg), f32(full[:, S]), **F32_TOL)


def test_flash_switch_takes_the_plain_route_on_the_cpu(monkeypatch):
    _, tcfg = _cfgs(flash=True)
    tp = TM.init_params(tcfg, 0, device="cpu")
    calls = [0]
    plain = FA.flash_attention_plain

    def counted(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(FA, "flash_attention_plain", counted)
    launches = FA.launches
    TM.prefill(tcfg, tp, {"tokens": torch.zeros((1, 8), dtype=torch.long)})
    assert calls[0] == tcfg.n_layers and FA.launches == launches


@pytest.mark.parametrize("flash", [False, True])
def test_lockstep_serve_tokens_identical_to_jax(flash):
    T, seed = 8, 1
    job = ServeJob(arch="deepseek-moe-16b", batch=3, prompt_len=12,
                   arch_overrides=(("dtype", "float32"),
                                   ("use_flash_attention", flash)))
    res = run(ExperimentSpec(objective=job, T=T, seed=seed), device="cpu")
    assert res.x.shape == (3, T) and res.x.dtype == np.int32
    assert res.extra["flash_launches"] == 0 == res.extra["ssd_launches"]
    assert res.extra["logits_finite"]
    prompts, want = jax_serve(job, T, seed, port_init_as_jax(job.make_arch(), seed))
    np.testing.assert_array_equal(res.extra["prompts"], prompts)
    np.testing.assert_array_equal(res.x, want)


def test_slot_serve_tokens_identical_to_jax():
    """The slot lane against the JAX ``SlotServer`` (not against the
    lock-step lane: at decode the capacity couples a request to its
    neighbours, empty slots included, in both packages)."""
    T, seed = 6, 2
    job = ServeJob(arch="deepseek-moe-16b", batch=2, prompt_len=5, n_slots=3,
                   n_requests=6, arrival="poisson:gap=2", steps_per_launch=2,
                   admission="fedbuff:b=2",
                   arch_overrides=(("dtype", "float32"),))
    res = run(ExperimentSpec(objective=job, T=T, seed=seed), device="cpu")
    tcfg = job.make_arch()
    jsrv = jdist.SlotServer(tcfg, _mesh(), jdist.SlotConfig(
        n_slots=3, ctx_len=5 + T, seed=seed, steps_per_launch=2))
    want = jsrv.serve(port_init_as_jax(tcfg, seed), res.extra["prompts"], T,
                      admission="fedbuff:b=2",
                      arrivals=res.extra["arrivals"])
    np.testing.assert_array_equal(res.x, want.tokens)
    np.testing.assert_array_equal(res.extra["ttft_steps"], want.ttft_steps)
    assert res.extra["occupancy"] == want.occupancy
