"""`repro_torch.models` prefill / decode against the JAX model.

qwen2-0.5b reduced (2 layers, d 256) with ``dtype="float32"`` and the JAX
params cast to f32, carried into the port; compared at rtol = atol = 1e-4.
With ``use_flash_attention`` the JAX side runs the Pallas kernel in
interpret mode and the port its plain version."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                              # noqa: E402
import jax.numpy as jnp                                 # noqa: E402

from repro.configs import get_arch                      # noqa: E402
from repro.models import model as JM                    # noqa: E402
from repro_torch.configs import get_arch as t_get_arch  # noqa: E402
from repro_torch.models import model as TM              # noqa: E402
from torch_parity import f32, port_params, tree_f32     # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
B, S, STEPS = 2, 24, 4


def _cfgs(**over):
    over = dict(dtype="float32", **over)
    return (get_arch("qwen2-0.5b").reduced().with_(**over),
            t_get_arch("qwen2-0.5b").reduced().with_(**over))


def _params(jcfg):
    jp = tree_f32(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    return jp, port_params(jp)


def _assert_cache(tc, jc):
    np.testing.assert_array_equal(tc["positions"].numpy(),
                                  np.asarray(jc["positions"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(f32(tc["self"][name]),
                                   f32(jc["self"][name]), **TOL)


@pytest.mark.parametrize("flash,window", [(False, None), (True, None),
                                          (True, 16)])
def test_prefill_then_decode_matches_jax(flash, window):
    """window=16 < ctx: the ring wraps during prefill and decode."""
    jcfg, tcfg = _cfgs(use_flash_attention=flash, sliding_window=window)
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    steps = rng.integers(0, jcfg.vocab, (STEPS, B)).astype(np.int32)
    ctx = S + STEPS

    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(tokens)}, ctx_len=ctx)
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(tokens).long()},
                        ctx_len=ctx)
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    _assert_cache(tc, jc)

    for i in range(STEPS):
        pos = S + i
        jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(steps[i]),
                                jnp.int32(pos), ctx)
        tl, tc2 = TM.decode_step(tcfg, tp, tc, torch.from_numpy(steps[i]).long(),
                                 pos, ctx)
        assert tc2 is tc                      # updated in place
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
        _assert_cache(tc, jc)


def test_forward_logits_matches_jax():
    jcfg, tcfg = _cfgs(use_flash_attention=True)
    jp, tp = _params(jcfg)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (B, 16))
    jl, _ = JM.forward_logits(jcfg, jp, {"tokens": jnp.asarray(tokens)})
    tl, _ = TM.forward_logits(tcfg, tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)


def test_init_cache_and_specs_match_jax():
    jcfg, tcfg = _cfgs()
    jc = JM.init_cache(jcfg, B, 40)
    tc = TM.init_cache(tcfg, B, 40, device="cpu")
    assert tc["self"]["k"].shape == jc["self"]["k"].shape
    assert tc["self"]["k"].dtype == torch.float32
    _assert_cache(tc, jc)
    assert TM.n_params(tcfg) == JM.n_params(jcfg)


def test_other_families_raise():
    """dense and ssm are ported; moe and hybrid (as audio and vlm) raise."""
    for arch in ("deepseek-moe-16b", "zamba2-7b"):
        cfg = t_get_arch(arch).reduced()
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TM.param_specs(cfg)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TM.cache_specs(cfg, 1, 8)


@pytest.mark.parametrize("flash", [False, True])
def test_bf16_prefill_then_decode_matches_jax(flash):
    """The main path's dtype: bf16 params and activations.  Tolerance 3e-2,
    the kernel suite's bf16 tolerance: the two frameworks round bf16
    products at other places (torch upcasts operands where JAX asks for f32
    accumulation), so logits differ by a few bf16 ulps."""
    over = dict(use_flash_attention=flash)
    jcfg = get_arch("qwen2-0.5b").reduced().with_(**over)
    tcfg = t_get_arch("qwen2-0.5b").reduced().with_(**over)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = port_params(jp)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    steps = rng.integers(0, jcfg.vocab, (STEPS, B)).astype(np.int32)
    ctx = S + STEPS
    bf16 = dict(rtol=3e-2, atol=3e-2)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(tokens)}, ctx_len=ctx)
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(tokens).long()},
                        ctx_len=ctx)
    assert tl.dtype == tc["self"]["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(f32(tl), f32(jl), **bf16)
    for i in range(STEPS):
        jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(steps[i]),
                                jnp.int32(S + i), ctx)
        tl, tc = TM.decode_step(tcfg, tp, tc, torch.from_numpy(steps[i]).long(),
                                S + i, ctx)
        np.testing.assert_allclose(f32(tl), f32(jl), **bf16)


@pytest.mark.parametrize("dtype,window", [("float32", None), ("float32", 6),
                                          ("bfloat16", None)])
def test_ragged_decode_matches_jax(dtype, window):
    """Ragged decode (the slot server's): per-row positions against the
    (B, W) positions buffer, rows advancing at their own pace (row 2 holds
    still, as an inactive slot does), on the same cache, tokens and
    positions in both packages.  window=6 < ctx: each row's ring wraps at
    its own step.  Tolerances: f32 1e-5, bf16 3e-2."""
    over = dict(dtype=dtype, sliding_window=window)
    jcfg = get_arch("qwen2-0.5b").reduced().with_(**over)
    tcfg = t_get_arch("qwen2-0.5b").reduced().with_(**over)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    if dtype == "float32":
        jp = tree_f32(jp)
    tp = port_params(jp)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=3e-2, atol=3e-2))
    rows, ctx = 3, 16
    jc = JM.init_cache(jcfg, rows, ctx, ragged=True)
    tc = TM.init_cache(tcfg, rows, ctx, device="cpu", ragged=True)
    W = window or ctx
    assert tuple(tc["positions"].shape) == jc["positions"].shape == (rows, W)
    rng = np.random.default_rng(4)
    pos = np.array([0, 5, 9], np.int32)
    for i in range(8):
        toks = rng.integers(0, jcfg.vocab, rows).astype(np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(toks),
                                jnp.asarray(pos), ctx)
        tl, tc2 = TM.decode_step(tcfg, tp, tc, torch.from_numpy(toks).long(),
                                 torch.from_numpy(pos), ctx)
        assert tc2 is tc                      # updated in place
        np.testing.assert_allclose(f32(tl), f32(jl), err_msg=f"step {i}",
                                   **tol)
        np.testing.assert_array_equal(tc["positions"].numpy(),
                                      np.asarray(jc["positions"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(f32(tc["self"][name]),
                                       f32(jc["self"][name]), **tol)
        pos = pos + np.array([1, 1, 0], np.int32)


def test_ragged_decode_of_one_row_equals_lockstep():
    """A ragged batch whose rows share one position is the lock-step
    decode, bit for bit, in the port."""
    _, tcfg = _cfgs()
    tp = TM.init_params(tcfg, 0, device="cpu")
    lock = TM.init_cache(tcfg, 2, 8, device="cpu")
    rag = TM.init_cache(tcfg, 2, 8, device="cpu", ragged=True)
    toks = torch.tensor([3, 7])
    for pos in range(4):
        a, _ = TM.decode_step(tcfg, tp, lock, toks, pos, 8)
        b, _ = TM.decode_step(tcfg, tp, rag, toks,
                              torch.full((2,), pos, dtype=torch.int32), 8)
        assert torch.equal(a, b), pos
        toks = torch.argmax(a, dim=-1)
