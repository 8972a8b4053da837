"""The process half of ``repro_torch.distributed.sharding`` on the host.

For every arch's param specs (ZeRO and not), its moments (ZeRO) and its
batch specs, on the meshes ``data 2``, ``data 4`` and ``pod 2 × data 2``:
each rank's ``local`` block (every rank's coordinates, no process group
needed) has ``shard_shape``, and the blocks put back where the spec
places them rebuild the full tensor exactly.  ``gather`` over real ranks
is held in ``tests/test_torch_dp_ranks.py``.  Also: the activation
context's counts, ``shard_activation`` the identity over a model axis and
a family that does not run tensor-parallel refused there, and the mesh's
rank
layout (row-major, the last axis fastest, as ``jax.make_mesh``).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch                       # noqa: E402
from repro_torch.configs.registry import ARCHS                 # noqa: E402
from repro_torch.distributed import sharding as TS             # noqa: E402
from repro_torch.launch.mesh import Mesh                       # noqa: E402
from repro_torch.models import model as M                      # noqa: E402
from repro_torch.models.specs import meta_tree                 # noqa: E402
from repro_torch.tree import tree_leaves                       # noqa: E402

MESHES = {"data2": {"data": 2, "model": 1},
          "data4": {"data": 4, "model": 1},
          "pod2_data2": {"pod": 2, "data": 2, "model": 1}}


def _rebuild(sh, full, world):
    out = torch.full_like(full, float("nan"))
    for r in range(world):
        block = sh.local(full, rank=r)
        assert tuple(block.shape) == sh.shard_shape(full.shape)
        sh.local(out, rank=r).copy_(block)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_local_blocks_rebuild_every_leaf(arch, mesh_name):
    mesh = Mesh(MESHES[mesh_name])
    world = math.prod(mesh.shape.values())
    cfg = get_arch(arch).reduced()
    trees = ((M.param_specs(cfg), True), (M.param_specs(cfg), False),
             (M.batch_specs(cfg, 8, 16), False))
    split = 0
    for specs, zero in trees:
        shs = tree_leaves(TS.tree_shardings(specs, mesh, zero=zero))
        for sh, leaf in zip(shs, tree_leaves(meta_tree(specs))):
            full = torch.arange(leaf.numel(), dtype=torch.float64
                                ).reshape(leaf.shape)
            assert torch.equal(_rebuild(sh, full, world), full), sh
            split += any(e is not None for e in sh.spec)
    assert split > 0          # the batch at least is split over the ranks


def test_rank_layout_is_row_major():
    mesh = Mesh({"pod": 2, "data": 2, "model": 1})
    assert [mesh.coords_of(r) for r in range(4)] == [
        {"pod": p, "data": d, "model": 0} for p in (0, 1) for d in (0, 1)]
    assert [mesh.index(("pod", "data"), mesh.coords_of(r))
            for r in range(4)] == [0, 1, 2, 3]
    sh = TS.NamedSharding(mesh, TS.PSpec(("pod", "data"), None))
    x = np.arange(8).reshape(4, 2)
    assert [sh.local(x, rank=r).tolist() for r in range(4)] == [
        [[0, 1]], [[2, 3]], [[4, 5]], [[6, 7]]]


def test_activation_context_counts_and_refuses_a_model_axis():
    assert TS.data_shard_count() == 1 and TS.data_context() is None
    x = torch.ones(2, 3, 4)
    with TS.activation_sharding(Mesh({"pod": 2, "data": 4, "model": 1})):
        assert TS.data_shard_count() == 8
        assert TS.shard_activation(x, ("batch", "seq", None)) is x
    with TS.activation_sharding(Mesh({"data": 2, "model": 2})):
        # the identity over a model axis too; every family runs
        # tensor-parallel there
        assert TS.shard_activation(x, ("batch", "seq", None)) is x
        assert TS.model_axis_size() == 2
    # and so does the ragged decode (the slot lane): rank 0 of a traced
    # (2, 2) mesh, its collectives stand-ins, on its blocks of the params
    # and of the ragged cache (its two of four rows)
    from repro_torch.launch.mesh import TracedMesh

    cfg = get_arch("mamba2-370m").reduced()
    mesh = TracedMesh({"data": 2, "model": 2})
    params = M.init_params(cfg, 0, "cpu", shardings=TS.tree_shardings(
        M.param_specs(cfg), mesh))
    cache = M.init_cache(cfg, 4, 8, "cpu", ragged=True,
                         shardings=TS.tree_shardings(M.cache_specs(
                             cfg, 4, 8, ragged=True), mesh))
    with TS.activation_sharding(mesh), torch.no_grad():
        assert TS.model_axis_size() == 2 and TS.data_shard_count() == 2
        logits, _ = M.decode_step(cfg, params, cache,
                                  torch.zeros(2, dtype=torch.long),
                                  torch.tensor([3, 5], dtype=torch.int32), 8)
    assert logits.shape == (2, cfg.vocab) and torch.isfinite(logits).all()
    assert TS.data_shard_count() == 1 and TS.model_axis_size() == 1


def test_jax_pooled_state_carries_to_each_rank_row():
    """``convert.state_from_numpy`` with shardings: a JAX pooled state at
    n_shards 2 (its ``(2, cols)`` pools) becomes rank r's row of m, v and
    gbuf and the whole p, bit for bit."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as j_get_arch
    from repro.models import model as JM
    from repro.optim.pool import build_layout as j_layout, init_pools
    from repro_torch.models.convert import state_from_numpy

    params = jax.jit(JM.init_params, static_argnums=0)(
        j_get_arch("qwen2-0.5b").reduced(), jax.random.PRNGKey(0))
    lay = j_layout(params, 2)
    pools = init_pools(lay, params, delayed=True)
    for b in pools.values():
        b["m"] = b["m"] + jnp.arange(b["m"].shape[1], dtype=jnp.float32)
        b["gbuf"] = b["p"] * 2
    jstate = {"pools": pools, "opt": {"count": jnp.int32(3)},
              "step": jnp.int32(3)}
    np_state = jax.tree_util.tree_map(np.asarray, jstate)
    mesh = Mesh({"data": 2, "model": 1})
    rows = TS.NamedSharding(mesh, TS.pooled_pspec(mesh))
    whole = TS.NamedSharding(mesh, TS.PSpec(None, None))
    scalar = TS.NamedSharding(mesh, TS.PSpec())
    sh = {"pools": {dk: {"p": whole, "m": rows, "v": rows, "gbuf": rows}
                    for dk in pools},
          "opt": {"count": scalar}, "step": scalar}
    for r in (0, 1):
        mesh.coords = mesh.coords_of(r)
        got = state_from_numpy(np_state, "cpu", shardings=sh)
        for dk, b in np_state["pools"].items():
            for k, a in b.items():
                want = a if k == "p" else a[r:r + 1]
                t = got["pools"][dk][k]
                bits = (t.view(torch.int16).numpy().view(np.uint16)
                        if t.dtype == torch.bfloat16 else t.numpy())
                np.testing.assert_array_equal(
                    bits, want.view(np.uint16) if want.dtype.name ==
                    "bfloat16" else want, err_msg=f"{dk} {k} rank {r}")
        assert int(got["step"]) == 3
