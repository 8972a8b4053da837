"""`repro_torch.optim` against `repro.optim`, step by step.

Each port impl is paired with its JAX twin on the same numpy trees
(odd flat sizes, a 2-D leaf and a scalar leaf, as in
``tests/test_optim_fused.py``): ``"reference"`` with ``"reference"`` and the
port's fused route (the plain versions of the update kernels on the CPU)
with JAX's ``"pallas_interpret"``.  Tolerances are those of
``tests/test_optim_fused.py:69-83``: f32 params rtol 1e-5 / atol 5e-7,
f32 moments rtol 1e-5 / atol 1e-8; bf16 params 3e-2, bf16-driven moments
rtol 5e-2 / atol 5e-5; step counts bitwise.  The global norm is a
reduction in another order than XLA's, so it is held to rtol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402

from repro import optim as JO                                  # noqa: E402
from repro_torch import optim as TO                            # noqa: E402
from torch_parity import f32, pair                             # noqa: E402

DTYPES = ["float32", "bfloat16"]
PAIR_IMPL = {"reference": "reference", "pallas": "pallas_interpret"}


def _tree(dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (33, 7), "b": (5,), "scalar": (), "big": (1000,)}
    out = {k: pair(np.asarray(rng.standard_normal(s), np.float32), dtype)
           for k, s in shapes.items()}
    return ({k: v[0] for k, v in out.items()},
            {k: v[1] for k, v in out.items()})


def _assert_params(tp, jp, dtype):
    tol = dict(rtol=1e-5, atol=5e-7) if dtype == "float32" else \
        dict(rtol=3e-2, atol=3e-2)
    for k in jp:
        np.testing.assert_allclose(f32(tp[k]), f32(jp[k]), err_msg=k, **tol)


def _assert_opt(ts, js, dtype):
    np.testing.assert_array_equal(ts["count"].numpy(), np.asarray(js["count"]))
    tol = dict(rtol=1e-5, atol=1e-8) if dtype == "float32" else \
        dict(rtol=5e-2, atol=5e-5)
    for key in ("m", "v"):
        for k in js[key]:
            np.testing.assert_allclose(f32(ts[key][k]), f32(js[key][k]),
                                       err_msg=f"{key}/{k}", **tol)


def _cfgs(name, impl, **kw):
    return (TO.OptConfig(name=name, lr=1e-2, update_impl=impl, **kw),
            JO.OptConfig(name=name, lr=1e-2, update_impl=PAIR_IMPL[impl],
                         **kw))


@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("name", ["adam", "sgd"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_update_matches_jax_multistep(impl, name, dtype):
    tcfg, jcfg = _cfgs(name, impl, clip_norm=1.0, weight_decay=0.01)
    t_init, t_upd = TO.make_optimizer(tcfg)
    j_init, j_upd = JO.make_optimizer(jcfg)
    j_upd = jax.jit(j_upd, static_argnums=3)
    jp, tp = _tree(dtype)
    js, ts = j_init(jp), t_init(tp)
    for step in range(4):
        jg, tg = _tree(dtype, seed=10 + step)
        scale = 0.5 if step % 2 else 1.0
        jp, js, jn = j_upd(jg, js, jp, jcfg, lr_scale=scale)
        tp, ts, tn = t_upd(tg, ts, tp, tcfg,
                           lr_scale=torch.tensor(scale) if step == 3 else scale)
        np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    _assert_params(tp, jp, dtype)
    _assert_opt(ts, js, dtype)


@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sgd_momentum_update_matches_jax_multistep(impl, dtype):
    """Heavy-ball SGD, clipped, over 4 steps with lr scales: the fused
    route runs ``sgd_momentum_step`` (its plain version here) against JAX's
    ``sgd_momentum_step_pallas`` in interpret mode."""
    tcfg, jcfg = _cfgs("sgd", impl, momentum=0.9, clip_norm=1.0)
    t_init, t_upd = TO.make_optimizer(tcfg)
    j_init, j_upd = JO.make_optimizer(jcfg)
    j_upd = jax.jit(j_upd, static_argnums=3)
    jp, tp = _tree(dtype)
    js, ts = j_init(jp), t_init(tp)
    for step in range(4):
        jg, tg = _tree(dtype, seed=40 + step)
        scale = 0.5 if step % 2 else 1.0
        jp, js, jn = j_upd(jg, js, jp, jcfg, lr_scale=scale)
        tp, ts, tn = t_upd(tg, ts, tp, tcfg, lr_scale=scale)
        np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    _assert_params(tp, jp, dtype)
    _assert_opt(ts, js, dtype)


@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sgd_momentum_delayed_apply_matches_jax(impl, dtype):
    """The delayed apply with heavy ball: gated first round, then delay
    scales 1, 1/2, 1; the buffer swap bitwise."""
    tcfg, jcfg = _cfgs("sgd", impl, momentum=0.9, clip_norm=1.0)
    t_apply = TO.make_delayed_apply(tcfg)
    j_apply = jax.jit(JO.make_delayed_apply(jcfg), static_argnums=4)
    jp, tp = _tree(dtype)
    js, ts = JO.adam_init(jp), TO.adam_init(tp)
    jb = jax.tree_util.tree_map(jnp.zeros_like, jp)
    tb = {k: torch.zeros_like(v) for k, v in tp.items()}
    for step, scale in enumerate((0.0, 1.0, 0.5, 1.0)):
        jg, tg = _tree(dtype, seed=50 + step)
        jp, jb, js, jn = j_apply(jg, jb, js, jp, jcfg, lr_scale=scale)
        tp, tb, ts, tn = t_apply(tg, tb, ts, tp, tcfg, lr_scale=scale)
        np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
        for k in jb:
            np.testing.assert_array_equal(f32(tb[k]), f32(jb[k]))
    _assert_params(tp, jp, dtype)
    _assert_opt(ts, js, dtype)


def test_fused_momentum_tracks_reference_route():
    """Inside the port, as ``tests/test_optim_fused.py:136-175`` holds the
    JAX package: the fused heavy-ball route against the reference route on
    the same f32 trees, sync and delayed, m buffers included."""
    for delayed in (False, True):
        fcfg, _ = _cfgs("sgd", "pallas", momentum=0.9, clip_norm=1.0)
        rcfg, _ = _cfgs("sgd", "reference", momentum=0.9, clip_norm=1.0)
        _, pr = _tree("float32")
        _, pf = _tree("float32")
        sr, sf = TO.adam_init(pr), TO.adam_init(pf)
        br = {k: torch.zeros_like(v) for k, v in pr.items()}
        bf = {k: torch.zeros_like(v) for k, v in pf.items()}
        for step in range(4):
            _, g = _tree("float32", seed=60 + step)
            if delayed:
                pr, br, sr, nr = TO.make_delayed_apply(rcfg)(
                    g, br, sr, pr, rcfg, lr_scale=0.25)
                pf, bf, sf, nf = TO.make_delayed_apply(fcfg)(
                    {k: v.clone() for k, v in g.items()}, bf, sf, pf, fcfg,
                    lr_scale=0.25)
                for k in g:
                    assert torch.equal(bf[k], g[k])
            else:
                pr, sr, nr = TO.make_optimizer(rcfg)[1](g, sr, pr, rcfg,
                                                        lr_scale=0.5)
                pf, sf, nf = TO.make_optimizer(fcfg)[1](g, sf, pf, fcfg,
                                                        lr_scale=0.5)
            assert torch.equal(nr, nf)
        for k in pr:
            np.testing.assert_allclose(f32(pf[k]), f32(pr[k]), rtol=1e-5,
                                       atol=5e-7)
            np.testing.assert_allclose(f32(sf["m"][k]), f32(sr["m"][k]),
                                       rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("name", ["adam", "sgd"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_delayed_apply_matches_jax(impl, name, dtype):
    """Gated first round (lr_scale 0), then delay scales 1 and 1/2: the
    stale buffer drives the step, the fresh grads land in the buffer."""
    tcfg, jcfg = _cfgs(name, impl, clip_norm=1.0)
    t_apply = TO.make_delayed_apply(tcfg)
    j_apply = jax.jit(JO.make_delayed_apply(jcfg), static_argnums=4)
    jp, tp = _tree(dtype)
    js, ts = JO.adam_init(jp), TO.adam_init(tp)
    jb = jax.tree_util.tree_map(jnp.zeros_like, jp)
    tb = {k: torch.zeros_like(v) for k, v in tp.items()}
    for step, scale in enumerate((0.0, 1.0, 0.5, 1.0)):
        jg, tg = _tree(dtype, seed=20 + step)
        jp, jb, js, jn = j_apply(jg, jb, js, jp, jcfg, lr_scale=scale)
        tp, tb, ts, tn = t_apply(tg, tb, ts, tp, tcfg, lr_scale=scale)
        np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
        for k in jb:
            np.testing.assert_array_equal(f32(tb[k]), f32(jb[k]))
    _assert_params(tp, jp, dtype)
    _assert_opt(ts, js, dtype)


def test_fused_route_updates_in_place():
    tcfg, _ = _cfgs("adam", "pallas")
    _, tp = _tree("bfloat16")
    ts = TO.adam_init(tp)
    tb = {k: torch.zeros_like(v) for k, v in tp.items()}
    _, tg = _tree("bfloat16", seed=1)
    ptrs = [t.data_ptr() for t in (*tp.values(), *tb.values(),
                                   *ts["m"].values(), ts["count"])]
    p2, b2, s2, _ = TO.fused_delayed_apply(tg, tb, ts, tp, tcfg, lr_scale=1.0)
    assert p2 is tp and b2 is tb and s2 is ts
    assert ptrs == [t.data_ptr() for t in (*p2.values(), *b2.values(),
                                           *s2["m"].values(), s2["count"])]
    assert int(s2["count"]) == 1


def test_sgd_momentum_reference_matches_jax():
    tcfg, jcfg = _cfgs("sgd", "reference", momentum=0.9, clip_norm=None)
    jp, tp = _tree("float32")
    js, ts = JO.adam_init(jp), TO.adam_init(tp)
    for step in range(3):
        jg, tg = _tree("float32", seed=30 + step)
        jp, js, _ = JO.sgd_update(jg, js, jp, jcfg)
        tp, ts, _ = TO.sgd_update(tg, ts, tp, tcfg)
    _assert_params(tp, jp, "float32")
    _assert_opt(ts, js, "float32")


def test_clip_scale_epsilon_matches_jax():
    for norm in (0.0, 1e-13, 0.5, 3.0):
        got = TO.clip_scale_from_norm(torch.tensor(norm), 1.0)
        want = JO.clip_scale_from_norm(jnp.float32(norm), 1.0)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-7)
    assert TO.clip_scale_from_norm(torch.tensor(5.0), None).item() == 1.0


def test_update_impl_resolution():
    assert TO.resolve_update_impl("pallas") == "pallas"
    assert TO.resolve_update_impl("pallas_interpret") == "pallas_interpret"
    with pytest.raises(ValueError, match="update_impl"):
        TO.resolve_update_impl("cuda")
    for impl in ("pallas_pooled", "pallas_pooled_interpret"):
        # the pooled impls run through optim.pool; the tree factories
        # refuse them with the JAX package's words
        assert TO.resolve_update_impl(impl) == impl
        with pytest.raises(ValueError, match="pools the state into "
                           "per-dtype buffers and cannot serve the "
                           "tree-based optimizer contract"):
            TO.make_optimizer(TO.OptConfig(update_impl=impl))
        with pytest.raises(ValueError, match="operates on pooled state"):
            TO.make_delayed_apply(TO.OptConfig(update_impl=impl))
    # heavy-ball SGD on a fused impl runs its kernels
    cfg = TO.OptConfig(name="sgd", momentum=0.9, update_impl="pallas")
    assert TO.make_optimizer(cfg)[1] is TO.fused_sgd_update
    assert TO.make_delayed_apply(cfg) is TO.fused_delayed_apply
