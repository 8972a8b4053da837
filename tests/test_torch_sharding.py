"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's, leaf for leaf.

Every arch's param, cache, batch and trainer-state Specs go through both
packages' ``tree_pspecs`` / ``bytes_per_device`` on the TPU meshes of the
JAX suite (16 × 16, 2 × 16 × 16) and the production H100 meshes (32 × 8,
2 × 32 × 8), under DEFAULT and SEQ_PARALLEL rules, ZeRO on and off: each
partition spec must be equal element for element (a ``PartitionSpec``
compared as a tuple) and the byte counts exact.  The rules are pure
arithmetic, so no tolerance applies.  A hypothesis property test holds the
two packages to each other on random dims, names and meshes, as
``test_sharding_property.py`` holds the JAX rules to legality.
"""
import dataclasses

import jax
import pytest
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as P

import repro.distributed.sharding as JS
from repro.configs import ARCHS as JARCHS, SHAPES as JSHAPES, \
    get_arch as jget_arch
from repro.distributed import AsyncConfig as JAsyncConfig
from repro.distributed import AsyncTrainer as JAsyncTrainer
from repro.models import model as JM
from repro.models.specs import Spec as JSpec

import repro_torch.distributed.sharding as TS
from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.distributed import AsyncTrainer
from repro_torch.launch.mesh import (HBM_BYTES, Mesh, make_production_mesh,
                                     mesh_devices)
from repro_torch.models import model as TM
from repro_torch.tree import tree_leaves_with_path

MESHES = {
    "tpu16x16": Mesh({"data": 16, "model": 16}),
    "tpu2x16x16": Mesh({"pod": 2, "data": 16, "model": 16}),
    "h100x256": make_production_mesh(),
    "h100x512": make_production_mesh(multi_pod=True),
}
RULES = {"default": (JS.DEFAULT_RULES, TS.DEFAULT_RULES),
         "seq": (JS.SEQ_PARALLEL_RULES, TS.SEQ_PARALLEL_RULES)}


def _jax_state_specs(cfg):
    tr = JAsyncTrainer.__new__(JAsyncTrainer)   # only state_specs is needed
    tr.cfg, tr.async_cfg, tr.pooled = cfg, JAsyncConfig(delay_rounds=1), False
    return tr.state_specs()


def _trees(arch):
    """(name, JAX Spec tree, port Spec tree) for the arch's params, the
    decode_32k cache, the train_4k batch and the trainer state."""
    jc, tc = jget_arch(arch), get_arch(arch)
    sh = SHAPES["decode_32k"]
    tb = SHAPES["train_4k"]
    return [
        ("params", JM.param_specs(jc), TM.param_specs(tc)),
        ("cache", JM.cache_specs(jc, sh.global_batch, sh.seq_len),
         TM.cache_specs(tc, sh.global_batch, sh.seq_len)),
        ("batch", JM.batch_specs(jc, tb.global_batch, tb.seq_len),
         TM.batch_specs(tc, tb.global_batch, tb.seq_len)),
        ("state", _jax_state_specs(jc),
         AsyncTrainer(tc, device="meta").state_specs()),
    ]


def _jax_by_path(tree, leaf_type):
    return {jax.tree_util.keystr(p): l for p, l in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, leaf_type))}


def test_registries_match():
    assert sorted(ARCHS) == sorted(JARCHS) and len(ARCHS) == 10
    assert SHAPES == {k: type(SHAPES[k])(**dataclasses.asdict(v))
                      for k, v in JSHAPES.items()}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_rules_match_jax_on_every_leaf(arch, mesh_name):
    """tree_pspecs (DEFAULT / SEQ_PARALLEL × ZeRO off / on) and
    bytes_per_device equal JAX's on every leaf of every tree."""
    mesh = MESHES[mesh_name]
    n_leaves = 0
    for name, jtree, ttree in _trees(arch):
        # the two packages declare the same Specs
        jspecs = _jax_by_path(jtree, JSpec)
        tspecs = dict(tree_leaves_with_path(ttree))
        assert sorted(jspecs) == sorted(tspecs), name
        for path, s in tspecs.items():
            assert (tuple(s.shape), tuple(s.axes), s.dtype) == (
                tuple(jspecs[path].shape), tuple(jspecs[path].axes),
                jspecs[path].dtype), (name, path)
        for rname, (jr, tr) in RULES.items():
            for zero in (False, True):
                want = _jax_by_path(JS.tree_pspecs(jtree, mesh, jr, zero), P)
                got = dict(tree_leaves_with_path(
                    TS.tree_pspecs(ttree, mesh, tr, zero)))
                assert {k: tuple(v) for k, v in want.items()} == \
                    {k: tuple(v) for k, v in got.items()}, \
                    (name, rname, zero)
                assert all(isinstance(v, TS.PSpec) for v in got.values())
                assert TS.bytes_per_device(ttree, mesh, tr, zero) == \
                    JS.bytes_per_device(jtree, mesh, jr, zero), \
                    (name, rname, zero)
                n_leaves += len(got)
    assert n_leaves > 0


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_auto_rules_match_jax(arch):
    for size in (8, 16):
        j = JS.auto_rules(jget_arch(arch), size)
        t = TS.auto_rules(get_arch(arch), size)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (t is TS.SEQ_PARALLEL_RULES) == (j is JS.SEQ_PARALLEL_RULES)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_pool_rules_match_jax(mesh_name):
    mesh = MESHES[mesh_name]
    for jr, tr in RULES.values():
        assert TS.pool_axes(mesh, tr) == JS.pool_axes(mesh, jr)
        assert TS.pool_shard_count(mesh, tr) == JS.pool_shard_count(mesh, jr)
        assert tuple(TS.pooled_pspec(mesh, tr)) == \
            tuple(JS.pooled_pspec(mesh, jr))
    one = Mesh({"model": 8})
    assert TS.pool_shard_count(one) == JS.pool_shard_count(one) == 1
    assert tuple(TS.pooled_pspec(one)) == tuple(JS.pooled_pspec(one))


def test_production_meshes():
    assert make_production_mesh().shape == {"data": 32, "model": 8}
    assert make_production_mesh(multi_pod=True).axis_names == (
        "pod", "data", "model")
    assert mesh_devices(make_production_mesh()) == 256
    assert mesh_devices(make_production_mesh(multi_pod=True)) == 512
    assert TS.data_shard_count() == 1


def test_grok_train_state_fits_an_h100_under_zero():
    """grok-1-314b's train state (bf16 params and delayed buffer, f32
    moments, ZeRO over the data axis) lands under 80 GB per GPU on the
    32 × 8 H100 mesh; unsharded it is ~3.8 TB."""
    sp = AsyncTrainer(get_arch("grok-1-314b"), device="meta").state_specs()
    mesh = make_production_mesh()
    parts = (sp["params"], sp["opt"]["m"], sp["opt"]["v"], sp["gbuf"])
    total = sum(TS.bytes_per_device(t, mesh, zero=True) for t in parts)
    assert total < HBM_BYTES, f"{total / 1e9:.1f} GB/GPU"
    flat = sum(TS.bytes_per_device(t, Mesh({"data": 1}), zero=True)
               for t in parts)
    assert flat > 40 * total


def test_pspec_is_a_tuple_of_entries():
    p = TS.logical_pspec(("batch", "seq"), (256, 4096),
                         MESHES["h100x512"])
    assert p == TS.PSpec(("pod", "data"), None) == (("pod", "data"), None)
    assert tuple(P(("pod", "data"), None)) == tuple(p)
    assert TS.logical_pspec(None, (3,), MESHES["h100x256"]) == TS.PSpec()


_NAMES = [None, "batch", "seq", "embed", "heads", "kv_heads", "ff", "vocab",
          "experts", "layers", "ctx", "d_inner", "ssm_heads", "capacity",
          "act_embed", "head", "state", "conv"]


@settings(max_examples=150, deadline=None)
@given(
    dims=st.lists(st.integers(1, 4096), min_size=1, max_size=5),
    names=st.lists(st.sampled_from(_NAMES), min_size=1, max_size=5),
    data=st.sampled_from([1, 2, 4, 16, 32]),
    model=st.sampled_from([1, 2, 8, 16]),
    pod=st.sampled_from([0, 2]),
    zero=st.booleans(),
    seq_rules=st.booleans(),
)
def test_property_rules_match_jax(dims, names, data, model, pod, zero,
                                  seq_rules):
    n = min(len(dims), len(names))
    dims, names = tuple(dims[:n]), tuple(names[:n])
    shape = {"data": data, "model": model}
    if pod:
        shape = {"pod": pod, **shape}
    mesh = Mesh(shape)
    jr, tr = RULES["seq" if seq_rules else "default"]
    want = JS.logical_pspec(names, dims, mesh, jr)
    got = TS.logical_pspec(names, dims, mesh, tr)
    assert tuple(got) == tuple(want)
    if zero:
        want = JS.zero_pspec(names, dims, mesh, want, jr)
        got = TS.zero_pspec(names, dims, mesh, got, tr)
        assert tuple(got) == tuple(want)
    leaf = ("float32", "bfloat16")[len(dims) % 2]
    assert TS.bytes_per_device(TM.Spec(dims, names, "zeros", leaf), mesh, tr,
                               zero) == \
        JS.bytes_per_device(JSpec(dims, names, "zeros", leaf), mesh, jr, zero)
