"""The port's SSM family (Mamba2) against the JAX model, and its serving
lane against the JAX ``Server``.

mamba2-370m reduced (2 layers, d 256, d_inner 512, 16 SSD heads of dim 32,
state 32, chunk 16, vocab 512), the JAX params carried into the port.
``use_ssd_kernel`` True pairs the port's kernel branch (the SSD kernel's
plain version on the CPU) with the JAX kernel branch (the Pallas kernel in
interpret mode); False pairs the two einsum branches.  Tolerances: f32
(``dtype="float32"``, f32 params) rtol = atol = 1e-4, as
``test_torch_model.py`` holds the dense family; bf16 3e-2, the kernel
suite's bf16 tolerance (the frameworks round bf16 products at other
places); decode against prefill inside the port 5e-2, as the JAX suite
holds it (``tests/test_models_smoke.py:131-147``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from repro.configs import get_arch                           # noqa: E402
from repro.models import model as JM                         # noqa: E402
from repro_torch.api import ExperimentSpec, ServeJob, run    # noqa: E402
from repro_torch.configs import get_arch as t_get_arch       # noqa: E402
from repro_torch.models import model as TM                   # noqa: E402
from repro_torch.models import init_params, params_to_numpy  # noqa: E402
from torch_parity import (f32, jax_serve, port_params, to_jax,  # noqa: E402
                          tree_f32)

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
B, S, STEPS = 2, 32, 4


def _cfgs(dtype, **over):
    over = dict(remat="none", dtype=dtype, **over)
    return (get_arch("mamba2-370m").reduced().with_(**over),
            t_get_arch("mamba2-370m").reduced().with_(**over))


def _params(jcfg, dtype):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    if dtype == "float32":
        jp = tree_f32(jp)
    return jp, port_params(jp)


def _assert_cache(tc, jc, tol):
    assert set(tc) == set(jc) == {"ssm"}
    for name in ("conv", "ssd"):
        assert tc["ssm"][name].shape == jc["ssm"][name].shape, name
        np.testing.assert_allclose(f32(tc["ssm"][name]), f32(jc["ssm"][name]),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", [False, True])
def test_forward_prefill_decode_match_jax(dtype, kernel):
    jcfg, tcfg = _cfgs(dtype, use_ssd_kernel=kernel)
    jp, tp = _params(jcfg, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    steps = rng.integers(0, jcfg.vocab, (STEPS, B)).astype(np.int32)
    ctx = S + STEPS

    jl, _ = JM.forward_logits(jcfg, jp, {"tokens": jnp.asarray(tokens)})
    tl, aux = TM.forward_logits(tcfg, tp, {"tokens": torch.from_numpy(tokens)})
    assert aux == 0.0 and tl.dtype == tp["embed"].dtype
    np.testing.assert_allclose(f32(tl), f32(jl), **tol)

    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(tokens)}, ctx_len=ctx)
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(tokens).long()},
                        ctx_len=ctx)
    np.testing.assert_allclose(f32(tl), f32(jl), **tol)
    assert tc["ssm"]["conv"].dtype == tp["embed"].dtype
    assert tc["ssm"]["ssd"].dtype == torch.float32
    _assert_cache(tc, jc, tol)

    for i in range(STEPS):
        jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(steps[i]),
                                jnp.int32(S + i), ctx)
        tl, tc2 = TM.decode_step(tcfg, tp, tc,
                                 torch.from_numpy(steps[i]).long(), S + i, ctx)
        assert tc2 is tc                               # updated in place
        np.testing.assert_allclose(f32(tl), f32(jl), err_msg=f"step {i}",
                                   **tol)
    _assert_cache(tc, jc, tol)


def test_decode_matches_prefill_inside_the_port():
    """The SSD recurrence step by step from an empty cache against the
    chunked scan over the same tokens (bf16, the main path's dtype)."""
    _, tcfg = _cfgs("bfloat16")
    tp = TM.init_params(tcfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab, (1, 16)))
    full, _ = TM.forward_logits(tcfg, tp, {"tokens": tokens})
    cache = TM.init_cache(tcfg, 1, 16, device="cpu")
    assert "positions" not in cache
    outs = []
    for pos in range(16):
        lg, cache = TM.decode_step(tcfg, tp, cache, tokens[:, pos], pos, 16)
        outs.append(lg)
    np.testing.assert_allclose(f32(torch.stack(outs, dim=1)), f32(full),
                               rtol=5e-2, atol=5e-2)


def test_cache_and_param_specs_match_jax():
    jcfg, tcfg = _cfgs("bfloat16")
    jc = JM.init_cache(jcfg, 3, 40)
    tc = TM.init_cache(tcfg, 3, 40, device="cpu")
    _assert_cache(tc, jc, dict(rtol=0, atol=0))
    assert tc["ssm"]["conv"].dtype == torch.bfloat16
    assert TM.n_params(tcfg) == JM.n_params(jcfg)
    full = t_get_arch("mamba2-370m")
    assert TM.n_params(full) == JM.n_params(get_arch("mamba2-370m"))
    jspecs = jax.tree_util.tree_leaves_with_path(
        JM.param_specs(jcfg), is_leaf=lambda s: hasattr(s, "init"))
    tspecs = TM.param_specs(tcfg)
    for path, js in jspecs:
        node = tspecs
        for key in path:
            node = node[key.key]
        assert (node.shape, node.init, node.dtype) == \
            (js.shape, js.init, js.dtype), path


def test_prefill_refuses_a_prompt_shorter_than_the_conv():
    _, tcfg = _cfgs("float32")
    tp = TM.init_params(tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="ssm_conv - 1"):
        TM.prefill(tcfg, tp, {"tokens": torch.zeros((1, 2), dtype=torch.long)})


@pytest.mark.parametrize("kernel", [False, True])
def test_serve_greedy_tokens_identical_to_jax(kernel):
    """``run(ServeJob(arch="mamba2-370m"))`` on the CPU, f32, against the
    JAX lock-step lane on the same params and prompts: a prompt of 12
    tokens (one SSD chunk of 12) and 8 tokens."""
    T, seed = 8, 1
    job = ServeJob(arch="mamba2-370m", batch=3, prompt_len=12,
                   arch_overrides=(("dtype", "float32"),
                                   ("use_ssd_kernel", kernel)))
    res = run(ExperimentSpec(objective=job, T=T, seed=seed), device="cpu")
    assert res.x.shape == (3, T) and res.x.dtype == np.int32
    assert res.extra["ssd_launches"] == 0 == res.extra["flash_launches"]
    assert res.extra["logits_finite"] and res.extra["arch"] == "mamba2-370m"

    params = init_params(job.make_arch(), seed, device="cpu")
    prompts, want = jax_serve(job, T, seed, to_jax(params_to_numpy(params)))
    np.testing.assert_array_equal(res.extra["prompts"], prompts)
    np.testing.assert_array_equal(res.x, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_decode_matches_jax(dtype):
    """The slot server's ragged decode on the ssm family: a (B,) position
    vector (which the SSM path does not read) against a ragged cache, on
    the same states, tokens and positions in both packages.  Tolerances:
    f32 1e-5, bf16 3e-2."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, dtype)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else BF16_TOL)
    rows, ctx = 3, 16
    jc = JM.init_cache(jcfg, rows, ctx, ragged=True)
    tc = TM.init_cache(tcfg, rows, ctx, device="cpu", ragged=True)
    assert "positions" not in tc
    rng = np.random.default_rng(5)
    pos = np.array([0, 5, 9], np.int32)
    for i in range(4):
        toks = rng.integers(0, jcfg.vocab, rows).astype(np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(toks),
                                jnp.asarray(pos), ctx)
        tl, _ = TM.decode_step(tcfg, tp, tc, torch.from_numpy(toks).long(),
                               torch.from_numpy(pos), ctx)
        np.testing.assert_allclose(f32(tl), f32(jl), err_msg=f"step {i}",
                                   **tol)
        pos = pos + 1
    _assert_cache(tc, jc, tol)
