"""`repro_torch.optim.pool` and the pooled trainer against the JAX package.

The JAX pool functions run as ``tests/test_optim_pool.py`` runs them (its
Pallas kernels in interpret mode on the CPU); the port's run the kernels'
plain versions.  Both take the same numpy inputs, drawn from a seed.
Tolerances are ``tests/test_optim_pool.py``'s: layouts, pools, the
buffer swap and counts bitwise; global norms to rtol 1e-6 (another
reduction order); params and moments keyed off the param dtype, bf16 to
3e-2 and f32 to rtol 1e-5 / atol 5e-7; the trainer's loss curve to rtol
5e-3 (its bf16 curve tolerance).  A JAX pooled checkpoint restores into
the port bit for bit, and the port's back into JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402
from jax.sharding import Mesh                                  # noqa: E402

from repro import checkpoint as jckpt                          # noqa: E402
from repro.configs import get_arch                             # noqa: E402
from repro.distributed import AsyncConfig as JAsyncConfig      # noqa: E402
from repro.distributed import AsyncTrainer as JTrainer         # noqa: E402
from repro.optim import OptConfig as JOptConfig                # noqa: E402
from repro.optim import pool as JP                             # noqa: E402
from repro_torch import checkpoint as tckpt                    # noqa: E402
from repro_torch.configs import get_arch as t_get_arch         # noqa: E402
from repro_torch.distributed import AsyncConfig, AsyncTrainer  # noqa: E402
from repro_torch.faults import GuardConfig                     # noqa: E402
from repro_torch.models import model as TM                     # noqa: E402
from repro_torch.optim import OptConfig                        # noqa: E402
from repro_torch.optim import pool as TP                       # noqa: E402
from repro_torch.tree import tree_leaves                       # noqa: E402
from torch_parity import f32                                   # noqa: E402

_BF16 = {"w", "big"}


def _tree_np(seed=0):
    """The JAX suite's mixed-dtype tree (two pool groups) with its
    padding edges: odd sizes, 2-D, a scalar, sizes no shard count
    divides.  numpy f32; the bf16 leaves are rounded below."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((33, 7)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "scalar": np.asarray(0.37, np.float32),
            "big": rng.standard_normal(1000).astype(np.float32),
            "f32w": rng.standard_normal((17, 3)).astype(np.float32)}


def _pair(tree_np):
    """(JAX tree, port tree) holding the same values and dtypes."""
    jt = {k: jnp.asarray(v).astype(jnp.bfloat16 if k in _BF16
                                   else jnp.float32)
          for k, v in tree_np.items()}
    tt = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.bfloat16 if k in _BF16 else torch.float32)
        for k, v in jt.items()}
    return jt, tt


def _grads(step):
    g = _tree_np(100 + step)
    g["scalar"] = np.asarray(0.1 * (step + 1), np.float32)
    return _pair(g)


def _state_pools(pools, key):
    return {dk: b[key] for dk, b in pools.items()}


def _assert_close(jax_tree, port_tree):
    """The JAX suite's bound, keyed off the param dtype."""
    for k in jax_tree:
        a, b = f32(jax_tree[k]), f32(port_tree[k])
        if k in _BF16:
            np.testing.assert_allclose(b, a, rtol=3e-2, atol=3e-2,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=5e-7,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_layout_and_pools_equal_jax_and_roundtrip(n_shards):
    jt, tt = _pair(_tree_np())
    jl, tl = JP.build_layout(jt, n_shards), TP.build_layout(tt, n_shards)
    assert tl.n_pools == jl.n_pools == 2
    assert tl.n_leaves == jl.n_leaves == 5 and tl.cols == jl.cols
    for dk, slots in jl.groups.items():
        assert [dataclasses_tuple(s) for s in tl.groups[dk]] == \
            [dataclasses_tuple(s) for s in slots]
    jpools, tpools = JP.pool_tree(jl, jt), TP.pool_tree(tl, tt)
    for dk, jp in jpools.items():
        assert tuple(tpools[dk].shape) == (n_shards, tl.cols[dk])
        assert str(tpools[dk].dtype) == f"torch.{dk}"
        np.testing.assert_array_equal(f32(tpools[dk]), f32(jp))
    back = TP.unpool_tree(tl, tpools)
    for k in tt:
        assert torch.equal(back[k], tt[k]) and back[k].dtype == tt[k].dtype
    if n_shards == 1:
        # one shard: each leaf is a view into its pool
        for s in tl.groups["bfloat16"]:
            leaf = back[s.path[2:-2]]
            assert leaf.untyped_storage().data_ptr() == \
                tpools["bfloat16"].untyped_storage().data_ptr()


def dataclasses_tuple(slot):
    return (slot.index, slot.path, tuple(slot.shape), slot.dtype, slot.col,
            slot.width, slot.size)


def test_f32_override_groups_by_param_dtype_as_jax():
    jt, tt = _pair(_tree_np())
    jl, tl = JP.build_layout(jt, 4), TP.build_layout(tt, 4)
    jpools = JP.pool_tree(jl, jt, dtype=jnp.float32)
    tpools = TP.pool_tree(tl, tt, dtype=torch.float32)
    assert set(tpools) == set(tl.groups)
    for dk, jp in jpools.items():
        assert tpools[dk].dtype == torch.float32
        np.testing.assert_array_equal(tpools[dk].numpy(), np.asarray(jp))
    zeros = TP.pool_zeros(tl, "float32", device="cpu")
    assert {dk: tuple(z.shape) for dk, z in zeros.items()} == \
        {dk: (4, tl.cols[dk]) for dk in tl.groups}


def test_pooled_global_norm_matches_jax():
    jt, tt = _pair(_tree_np())
    for n in (1, 4):
        jl, tl = JP.build_layout(jt, n), TP.build_layout(tt, n)
        want = float(JP.pooled_global_norm(JP.pool_tree(jl, jt)))
        got = TP.pooled_global_norm(TP.pool_tree(tl, tt))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def test_pool_tree_wrong_tree_raises():
    lay = TP.build_layout(_pair(_tree_np())[1], 2)
    with pytest.raises(ValueError, match="leaves"):
        TP.pool_tree(lay, {"just_one": torch.zeros(3)})
    with pytest.raises(ValueError, match="n_shards"):
        TP.build_layout({"a": torch.zeros(3)}, 0)


# ---------------------------------------------------------------------------
# the pooled updates against JAX's, over several steps
# ---------------------------------------------------------------------------
_OPTS = [("adam", 0.0), ("sgd", 0.0), ("sgd", 0.9)]


def _run_both(name, momentum, n_shards, steps, delayed, scale):
    jcfg = JOptConfig(name=name, lr=1e-2, momentum=momentum, clip_norm=1.0)
    tcfg = OptConfig(name=name, lr=1e-2, momentum=momentum, clip_norm=1.0)
    jt, tt = _pair(_tree_np())
    jl, tl = JP.build_layout(jt, n_shards), TP.build_layout(tt, n_shards)
    jpools = JP.init_pools(jl, jt, delayed=delayed)
    tpools = TP.init_pools(tl, tt, delayed=delayed)
    jcount = jnp.zeros((), jnp.int32)
    tcount = torch.zeros((), dtype=torch.int32)
    japply = JP.pooled_delayed_apply if delayed else JP.pooled_update
    tapply = TP.pooled_delayed_apply if delayed else TP.pooled_update
    for step in range(steps):
        jg, tg = _grads(step)
        jpools, jcount, jn = japply(JP.pool_tree(jl, jg), jpools, jcount,
                                    jcfg, lr_scale=scale, interpret=True)
        tpools, tcount, tn = tapply(TP.pool_tree(tl, tg), tpools, tcount,
                                    tcfg, lr_scale=scale)
        np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
        if delayed:      # the fresh-grads swap is a copy: bitwise
            got = TP.unpool_tree(tl, _state_pools(tpools, "gbuf"))
            for k in tg:
                assert torch.equal(got[k], tg[k]), k
    assert int(tcount) == int(jcount) == steps
    keys = ("p", "m") + (("v",) if name == "adam" else ())
    for key in keys:
        _assert_close(JP.unpool_tree(jl, _state_pools(jpools, key)),
                      TP.unpool_tree(tl, _state_pools(tpools, key)))


@pytest.mark.parametrize("name,momentum", _OPTS)
def test_pooled_delayed_apply_matches_jax_multistep(name, momentum):
    _run_both(name, momentum, n_shards=4, steps=4, delayed=True,
              scale=1.0 / (1.0 + 3.0))


@pytest.mark.parametrize("name,momentum", _OPTS)
def test_pooled_update_matches_jax_sync(name, momentum):
    _run_both(name, momentum, n_shards=3, steps=3, delayed=False, scale=0.5)


def test_pooled_first_round_gate_matches_jax():
    """A zero buffer and lr_scale 0 leave the params pool bitwise and
    buffer the fresh grads (the trainer's round 0), in both packages."""
    cfg = OptConfig(name="adam", lr=1e-2, clip_norm=1.0)
    jt, tt = _pair(_tree_np())
    jl, tl = JP.build_layout(jt, 2), TP.build_layout(tt, 2)
    jg, tg = _grads(0)
    jpools = JP.init_pools(jl, jt)
    jnew, jcount, _ = JP.pooled_delayed_apply(
        JP.pool_tree(jl, jg), jpools, jnp.zeros((), jnp.int32),
        JOptConfig(name="adam", lr=1e-2, clip_norm=1.0), lr_scale=0.0,
        interpret=True)
    tpools = TP.init_pools(tl, tt)
    p0 = {dk: b["p"].clone() for dk, b in tpools.items()}
    tnew, tcount, _ = TP.pooled_delayed_apply(
        TP.pool_tree(tl, tg), tpools, torch.zeros((), dtype=torch.int32),
        cfg, lr_scale=0.0)
    for dk in tpools:
        assert torch.equal(tnew[dk]["p"], p0[dk])
        np.testing.assert_array_equal(f32(tnew[dk]["p"]),
                                      f32(jnew[dk]["p"]))
        np.testing.assert_array_equal(f32(tnew[dk]["gbuf"]),
                                      f32(jnew[dk]["gbuf"]))
    assert int(tcount) == int(jcount) == 1


def test_run_flag_zero_keeps_every_pool_and_the_count():
    """The guard rails' skip through the pools: at run 0 with NaN grads
    every pool and the count keep their bits (JAX skips the apply with a
    ``lax.cond``; the port's kernels write nothing)."""
    _, tt = _pair(_tree_np())
    lay = TP.build_layout(tt, 1)
    for name, momentum in _OPTS:
        cfg = OptConfig(name=name, lr=1e-2, momentum=momentum)
        pools = TP.init_pools(lay, tt)
        pools, count, _ = TP.pooled_delayed_apply(
            TP.pool_tree(lay, _grads(0)[1]), pools,
            torch.zeros((), dtype=torch.int32), cfg)
        kept = {dk: {k: t.clone() for k, t in b.items()}
                for dk, b in pools.items()}
        g = TP.pool_tree(lay, _grads(1)[1])
        for p in g.values():
            p[:, ::3] = float("nan")
        TP.pooled_delayed_apply(g, pools, count, cfg, run=torch.tensor(0.0))
        assert int(count) == 1
        for dk, b in pools.items():
            for k, t in b.items():
                assert torch.equal(t, kept[dk][k]), (name, dk, k)


# ---------------------------------------------------------------------------
# the pooled trainer
# ---------------------------------------------------------------------------
def _cfgs():
    over = dict(remat="none", n_layers=1)
    return (get_arch("qwen2-0.5b").reduced().with_(**over),
            t_get_arch("qwen2-0.5b").reduced().with_(**over))


def test_trainer_pooled_state_structure_matches_jax():
    jcfg, tcfg = _cfgs()
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jt = JTrainer(jcfg, mesh, opt=JOptConfig(update_impl="pallas_pooled"))
    tr = AsyncTrainer(tcfg, opt=OptConfig(update_impl="pallas_pooled"),
                      device="cpu")
    assert tr.pooled and tr.update_impl == "pallas_pooled"
    assert tr.pool_layout.n_shards == 1
    assert tr.pool_layout.cols == jt.pool_layout.cols
    state = tr.init_state(0)
    assert set(state) == {"pools", "opt", "step"} and \
        set(state["opt"]) == {"count"}
    jspecs, tspecs = jt.state_specs(), tr.state_specs()
    flat = lambda t: [(p, tuple(s.shape), s.dtype) for p, s in
                      jax.tree_util.tree_leaves_with_path(
                          t, is_leaf=lambda x: hasattr(x, "axes"))]
    assert [(jax.tree_util.keystr(p), sh, dt) for p, sh, dt in flat(jspecs)]\
        == [(jax.tree_util.keystr(p), sh, dt) for p, sh, dt in flat(tspecs)]
    for dk, grp in state["pools"].items():
        assert set(grp) == {"p", "m", "v", "gbuf"}
        assert tuple(grp["p"].shape) == (1, tr.pool_layout.cols[dk])
        assert grp["m"].dtype == torch.float32
    # params_of: views of the p pools, equal to the init tree
    want = TM.init_params(tcfg, 0, "cpu")
    got = tr.params_of(state)
    ptr = state["pools"]["bfloat16"]["p"].untyped_storage().data_ptr()
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        assert torch.equal(a, b)
        assert b.untyped_storage().data_ptr() == ptr
    # delay 0: no gbuf pool; guards add the health vector
    sync = AsyncTrainer(tcfg, opt=OptConfig(update_impl="pallas_pooled"),
                        async_cfg=AsyncConfig(delay_rounds=0,
                                              guards=GuardConfig()),
                        device="cpu")
    s0 = sync.init_state(0)
    assert all("gbuf" not in g for g in s0["pools"].values())
    assert s0["guard"]["health"].tolist() == [1.0]


def test_pooled_trainer_matches_jax_and_crosses_checkpoints(tmp_path):
    """The JAX pooled trainer (interpret kernels) and the port's, from one
    JAX pooled state carried through a JAX checkpoint: the loss curves
    agree to rtol 5e-3 over 5 rounds with per-round delay scales, with
    each other and with the port's reference route from the same params,
    and the port's final state restores into JAX bit for bit."""
    jcfg, tcfg = _cfgs()
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jt = JTrainer(jcfg, mesh, opt=JOptConfig(
        lr=1e-2, clip_norm=1.0, update_impl="pallas_pooled_interpret"),
        async_cfg=JAsyncConfig(delay_rounds=1))
    tr = AsyncTrainer(tcfg, opt=OptConfig(
        lr=1e-2, clip_norm=1.0, update_impl="pallas_pooled_interpret"),
        device="cpu")
    jstate = jt.init_state(jax.random.PRNGKey(0))
    jckpt.save(str(tmp_path / "jax"), jstate, step=0)
    tstate = tckpt.restore(str(tmp_path / "jax"), tr.init_state(0))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jstate),
                            tree_leaves(tstate)):
        np.testing.assert_array_equal(f32(b), f32(a),
                                      err_msg=jax.tree_util.keystr(path))
    ref = AsyncTrainer(tcfg, opt=OptConfig(lr=1e-2, clip_norm=1.0),
                       device="cpu")
    rstate = ref.init_state(params=tr.params_of(
        {"pools": {dk: {k: t.clone() for k, t in b.items()}
                   for dk, b in tstate["pools"].items()}}))
    tok = np.random.default_rng(3).integers(0, jcfg.vocab, (4, 16)).astype(
        np.int32)
    batch = {"tokens": torch.from_numpy(tok).long()}
    jstep = jax.jit(jt.train_step_fn())
    tstep, rstep = tr.train_step_fn(), ref.train_step_fn()
    jl, tl, rl = [], [], []
    for i in range(5):
        scale = 1.0 if i % 2 == 0 else 0.5
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tok)},
                           jnp.ones((1,)), jnp.float32(scale))
        tstate, tm = tstep(tstate, batch, torch.ones(1), delay_scale=scale)
        rstate, rm = rstep(rstate, batch, torch.ones(1), delay_scale=scale)
        jl.append(float(jm["loss"]))
        tl.append(tm["loss"].item())
        rl.append(rm["loss"].item())
    np.testing.assert_allclose(tl, jl, rtol=5e-3)
    np.testing.assert_allclose(tl, rl, rtol=5e-3)     # the reference route
    tckpt.save(str(tmp_path / "port"), tstate, step=5)
    back = jckpt.restore(str(tmp_path / "port"), jstate)
    for a, b in zip(jax.tree_util.tree_leaves(back), tree_leaves(tstate)):
        np.testing.assert_array_equal(f32(a), f32(b))
