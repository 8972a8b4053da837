"""The JAX side of the tensor-parallel tests (``tests/test_torch_tp_jax.py``).

``python tests/torch_tp.py OUT.npz PARAMS.npz CASE@DxM ... [SERVE@DxM]``
runs on four forced host devices: it draws the cases' params first
(``torch_dp.jax_params``, into ``PARAMS.npz``, where the port's ranks
wait for them), then runs each case of ``torch_dp.ALL_CASES`` on the JAX
trainer's own compiled step on the mesh (data D, model M) (the losses,
the round-0 delayed buffer, the initial state), and each served case of
:data:`SERVES` the JAX ``Server`` on that mesh: the case's reduced config
in f32 on its params, the prompts prefilled, then greedy decode.  Like
``torch_dp``, this module imports neither JAX nor the JAX package at its
top.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

import torch_dp as D

#: the served cases: name → (the trainer case whose config and params it
#: takes, batch, prompt length, decode steps, ctx length, the prompts'
#: round in ``torch_dp.tokens``); reduced qwen2-0.5b, mamba2-370m and
#: zamba2-7b with a tail (an SSM prompt: a multiple of the SSD chunk);
#: the sequence-parallel cases prefill under their rules on the mesh
SERVES = {"serve": ("dense_reference", 4, 12, 6, 24, 7),
          "serve_ssm": ("ssm_reference", 4, 16, 6, 24, 7),
          "serve_hybrid": ("hybrid_reference", 4, 16, 6, 24, 7),
          "serve_seq": ("dense_seq", 4, 12, 6, 24, 7),
          "serve_seq_h6": ("dense_seq_h6", 4, 12, 6, 24, 7)}


def parse(entry: str) -> tuple:
    """``"dense_pooled@2x2"`` → ``("dense_pooled", 2, 2)``."""
    name, mesh = entry.split("@")
    d, m = (int(n) for n in mesh.split("x"))
    return name, d, m


def start_jax(out_path: str, params_path: str, entries) -> subprocess.Popen:
    """:func:`jax_main` in a subprocess with four host devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=4"
                        " --xla_backend_optimization_level=0").strip()
    env["JAX_PLATFORMS"] = "cpu"
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(here), "src"), here]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             out_path, params_path, *entries], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _mesh(d, m):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                ("data", "model"))


def _serve(name, d, m, out):
    """The JAX ``Server`` on (d, m): greedy tokens from prefilled prompts
    of served case ``name``; a sequence-parallel case prefills on the
    mesh under its rules."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.distributed import sharding as JS
    from repro.distributed.serve import Server, ServeConfig
    from repro.models import model as JM

    case, B, S, T, ctx, q = SERVES[name]
    cfg = D.case_cfg(case, get_arch)
    rules = D.case_rules(case, JS)
    params = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32),
        jax.jit(JM.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0)))
    tokens = jnp.asarray(D.tokens(cfg.vocab, B, S, q))
    server = Server(cfg, _mesh(d, m), ServeConfig(batch=B, ctx_len=ctx),
                    rules=rules)
    if case in D.SEQ_CASES:
        run = JS.sharded_trace(lambda p, b: JM.prefill(cfg, p, b, ctx),
                               server.mesh, rules)
        last, cache = jax.jit(run)(
            jax.device_put(params, server.param_shardings()),
            {"tokens": tokens})
    else:
        last, cache = jax.jit(JM.prefill, static_argnums=(0, 3))(
            cfg, params, {"tokens": tokens}, ctx)
    first = np.asarray(jnp.argmax(last, -1)).astype(np.int32)
    params = jax.device_put(params, server.param_shardings())
    cache = jax.device_put(cache, server.cache_shardings())
    toks = server.generate(params, first, T, start_pos=S, cache=cache)
    out[f"{name}@{d}x{m}/tokens"] = np.concatenate([first[:, None], toks],
                                                   1)


def jax_state(tr, params):
    """The JAX trainer's initial state of ``params`` (numpy), as
    :func:`jax_main` builds it: the tree with zero moments and buffer, or
    the pools at the data ranks' shards."""
    import torch

    from repro_torch.models.convert import params_from_numpy, state_to_numpy
    from repro_torch.optim.pool import init_pools

    zero = np.zeros((), np.int32)
    if tr.pooled:
        pools = init_pools(tr.pool_layout, params_from_numpy(params, "cpu"))
        return {"pools": state_to_numpy({"pools": pools, "opt": {
            "count": torch.zeros((), dtype=torch.int32)},
            "step": torch.zeros((), dtype=torch.int32)})["pools"],
            "opt": {"count": zero}, "step": zero}

    def zeros(t, dt=None):
        return {k: zeros(v, dt) if isinstance(v, dict)
                else np.zeros(v.shape, dt or v.dtype) for k, v in t.items()}
    return {"params": params, "opt": {"m": zeros(params, np.float32),
                                      "v": zeros(params, np.float32),
                                      "count": zero},
            "step": zero, "gbuf": zeros(params)}


def bitwise(a: dict, b: dict) -> bool:
    """The same leaf paths, dtypes and bits."""
    from repro_torch.tree import tree_leaves_with_path

    la, lb = dict(tree_leaves_with_path(a)), dict(tree_leaves_with_path(b))
    return sorted(la) == sorted(lb) and all(
        np.asarray(la[k]).dtype == np.asarray(lb[k]).dtype
        and np.array_equal(la[k], lb[k]) for k in la)


def trainer_ranks(meshes, names, params_paths) -> dict:
    """This rank's side of the trainer cases ``names`` on each (data,
    model) of ``meshes``, from the JAX params: ``{"NAME@DxM": {"case":
    torch_dp.port_case's result, "jax_state": the JAX trainer's initial
    state, "round_trip": that state made the rank's blocks or rows and
    gathered back equals it bit for bit}}``."""
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.models.convert import (params_from_numpy,
                                            params_to_numpy,
                                            state_from_numpy)

    res = D.wait_params(params_paths)
    out = {}
    for d, m in meshes:
        mesh = ProcessMesh({"data": d, "model": m})
        for name in names:
            params = D.unflatten(res[name]["params"])
            tr = D.port_trainer(name, mesh)
            np_state = jax_state(tr, params)
            state = state_from_numpy(np_state, "cpu",
                                     shardings=tr.state_shardings())
            back = params_to_numpy(D.gathered(tr, state))
            out[f"{name}@{d}x{m}"] = {
                "case": D.port_case(name, mesh,
                                    params_from_numpy(params, "cpu")),
                "jax_state": np_state, "round_trip": bitwise(back, np_state)}
    return out


def port_serve(name: str, mesh, params_paths) -> dict:
    """The port's side of served case ``name`` on ``mesh`` (a bound mesh,
    one rank of it): the JAX params as this rank's blocks
    (``params_blocks``), the prompts prefilled under the mesh's context,
    then ``Server.generate``: ``{"tokens", "round_trip": the blocks
    gathered equal the JAX params bit for bit, "block_shape": the
    embedding's block}``."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed import Server, ServeConfig
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import sharded_trace
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_blocks, params_to_numpy
    from repro_torch.tree import tree_leaves_with_path, tree_map

    case, B, S, T, ctx, q = SERVES[name]
    cfg = D.case_cfg(case, get_arch)
    rules = D.case_rules(case, sharding)
    np_params = D.unflatten(D.wait_params(params_paths)[case]["params"])
    server = Server(cfg, ServeConfig(batch=B, ctx_len=ctx), device="cpu",
                    mesh=mesh, rules=rules)
    sh = server.param_shardings()
    blocks = params_blocks(np_params, sh, "cpu")
    whole = dict(tree_leaves_with_path(params_to_numpy(
        tree_map(lambda t, s: s.gather(t), blocks, sh))))
    want = dict(tree_leaves_with_path(np_params))
    tokens = torch.from_numpy(D.tokens(cfg.vocab, B, S, q)).long()
    with torch.no_grad():
        last, cache = sharded_trace(M.prefill, mesh, rules)(
            cfg, blocks, {"tokens": tokens}, ctx_len=ctx)
        first = last.argmax(-1)
        toks = server.generate(blocks, first.numpy(), T, start_pos=S,
                               cache=cache)
    return {"tokens": np.concatenate([first.numpy()[:, None], toks], 1),
            "round_trip": sorted(whole) == sorted(want) and all(
                whole[k].dtype == want[k].dtype
                and np.array_equal(whole[k], want[k]) for k in want),
            "block_shape": tuple(blocks["embed"].shape)}


# ---------------------------------------------------------------------------
# the other four families against the JAX package on its meshes
# (tests/test_torch_tp_families_jax.py, tests/test_torch_tp_modal_jax.py)
# ---------------------------------------------------------------------------
#: the trainer meshes (data, model)
MESHES = ((2, 2), (1, 4))
#: the served meshes' model axis (data 1)
SERVE_MODELS = (2, 4)


def family_entries(families) -> tuple:
    """(trainer entries, served entries, one JAX subprocess's entries per
    family) of ``families`` (``torch_dp.FAMILY_CASES``' prefixes)."""
    names = [n for f in families for n in D.FAMILY_CASES
             if n.startswith(f + "_")]
    entries = [f"{n}@{d}x{m}" for d, m in MESHES for n in names]
    served = [f"serve_{f}@1x{m}" for f in families if f"serve_{f}" in SERVES
              for m in SERVE_MODELS]
    groups = [[e for e in entries + served
               if e.split("@")[0].replace("serve_", "").startswith(f + "_")
               or e.split("@")[0] == f"serve_{f}"] for f in families]
    return entries, served, groups


def _ckpt_ranks(mesh, name, params_paths, jax_ckpt, out_dir) -> dict:
    """A ranked checkpoint of case ``name`` on ``mesh``, both ways: the
    JAX checkpoint ``jax_ckpt`` (the JAX trainer's initial state, written
    by the JAX package's checkpointer) restored into this rank's blocks;
    this rank's state after two rounds saved with the trainer's
    shardings → {"path", "whole": that state gathered (numpy),
    "restored_blocks_equal": the restore equals ``NamedSharding.local``
    of the JAX state bit for bit}."""
    import time

    import torch

    from repro_torch import checkpoint
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_numpy, params_to_numpy
    from repro_torch.tree import tree_leaves_with_path, tree_map

    arch, impl, mb, dtype, B, S, groups, T = D.ALL_CASES[name]
    params = D.unflatten(D.wait_params(params_paths)[name]["params"])
    tr = D.port_trainer(name, mesh)
    sh = tr.state_shardings()
    while not os.path.exists(os.path.join(jax_ckpt, "meta.json")):
        time.sleep(0.2)
    np_state = jax_state(tr, params)
    like = tr.init_state(params=params_from_numpy(params, "cpu"))
    back = checkpoint.restore(jax_ckpt, like, shardings=sh)
    want = dict(tree_leaves_with_path(tree_map(
        lambda a, s: torch.from_numpy(np.array(s.local(np.asarray(a)))),
        np_state, sh)))
    got = dict(tree_leaves_with_path(back))
    same = sorted(got) == sorted(want) and all(
        torch.equal(got[k], want[k]) for k in want)
    step = tr.train_step_fn()
    specs = M.batch_specs(tr.cfg, B, S)
    state = back
    for q in range(2):
        b = {k: torch.from_numpy(v) for k, v in
             D.batch(tr.cfg, specs, q).items()}
        b["tokens"] = b["tokens"].long()
        state, _ = step(state, b, torch.from_numpy(D.mask(groups, q)))
    path = os.path.join(out_dir, f"ckpt_{name}")
    checkpoint.save(path, state, step=2, shardings=sh)
    return {"path": path, "whole": params_to_numpy(D.gathered(tr, state)),
            "restored_blocks_equal": same}


def family_ranks(rank, world, out_dir, params_paths, names, served,
                 ckpts):
    """A world's side of :func:`family_entries`: at four ranks the
    trainer cases on both meshes and each checkpoint case of ``ckpts``
    (``{name: JAX checkpoint dir}``) on (data 1, model 4); the served
    entries whose mesh has ``world`` ranks.  Rank 0 pickles the results
    into ``out_dir/port.pkl``."""
    import pickle

    from repro_torch.launch.mesh import ProcessMesh

    out = {}
    if world == 4:
        out.update(trainer_ranks(MESHES, names, params_paths))
        for name, jax_ckpt in ckpts.items():
            out[f"ckpt:{name}"] = _ckpt_ranks(
                ProcessMesh({"data": 1, "model": 4}), name, params_paths,
                jax_ckpt, out_dir)
    for e in served:
        n, d, m = parse(e)
        if d * m == world:
            out[e] = port_serve(n, ProcessMesh({"data": d, "model": m}),
                                params_paths)
    if rank == 0:
        with open(os.path.join(out_dir, "port.pkl"), "wb") as f:
            pickle.dump(out, f)


def write_jax_checkpoint(name: str, path: str, params_paths) -> None:
    """The JAX trainer's initial state of case ``name`` (one process),
    written by the JAX package's checkpointer to ``path``, once the JAX
    params are drawn."""
    import jax
    import jax.numpy as jnp

    import repro.checkpoint as jckpt

    params = D.unflatten(D.wait_params(params_paths)[name]["params"])
    np_state = jax_state(D.port_trainer(name, None), params)
    jckpt.save(path, jax.tree_util.tree_map(
        lambda a: jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.uint16
                              else a), np_state), step=0)


def run_families(tmp, families, ckpts=()) -> tuple:
    """The JAX subprocesses of :func:`family_entries` (one per family)
    and the port's worlds beside them (four ranks; two when a served
    entry is at model 2), the JAX checkpoints of ``ckpts`` written
    meanwhile → (the JAX results, the port's)."""
    import pickle

    entries, served, groups = family_entries(families)
    paths = [(str(tmp / f"jax{i}.npz"), str(tmp / f"params{i}.npz"))
             for i in range(len(groups))]
    procs = [start_jax(out, params, g) for (out, params), g in
             zip(paths, groups)]
    alive = lambda: all(p.poll() in (None, 0) for p in procs)
    params = [p for _, p in paths]
    names = sorted({parse(e)[0] for e in entries})
    dirs = {n: str(tmp / f"jax_ckpt_{n}") for n in ckpts}
    worlds = sorted({4} | {parse(e)[2] for e in served}, reverse=True)
    try:
        started = [D.start(family_ranks, w, tmp / f"w{w}", params, names,
                           served, dirs if w == 4 else {}) for w in worlds]
        for n, path in dirs.items():
            write_jax_checkpoint(n, path, params)
        outs = [D.join(s, alive=alive) for s in started]
    finally:
        D.wait_jax(procs)
    port = {}
    for out in outs:
        with open(os.path.join(out, "port.pkl"), "rb") as f:
            port.update(pickle.load(f))
    jres = {}
    for jax_path, _ in paths:
        jres.update(results(jax_path))
    return jres, port


#: the per-leaf cases whose ``state_shardings()`` a ``specs@DxM`` entry
#: dumps, one of each family
SPEC_CASES = ("dense_reference", "moe_reference", "ssm_reference",
              "hybrid_reference", "audio_reference", "vlm_reference")


def spec_str(spec, ndim: int) -> str:
    """A partition spec (either package's) as one string: its entries,
    a tuple of axes as a tuple, padded with None to ``ndim``."""
    ents = [tuple(e) if isinstance(e, (tuple, list)) else e for e in spec]
    return repr(tuple(ents + [None] * (ndim - len(ents))))


def _state_specs(d, m, out):
    """The JAX trainer's ``state_shardings()`` (its default
    ``fsdp_params=True``) of each of :data:`SPEC_CASES` on (d, m), as
    :func:`spec_str` strings by leaf path."""
    import jax

    from repro.configs import get_arch
    from repro.distributed import AsyncConfig, AsyncTrainer
    from repro.models.specs import Spec
    from repro.optim import OptConfig

    for name in SPEC_CASES:
        tr = AsyncTrainer(D.case_cfg(name, get_arch), _mesh(d, m),
                          opt=OptConfig(update_impl="reference"),
                          async_cfg=AsyncConfig(delay_rounds=1))
        specs = dict(jax.tree_util.tree_leaves_with_path(
            tr.state_specs(), is_leaf=lambda x: isinstance(x, Spec)))
        for path, sh in jax.tree_util.tree_leaves_with_path(
                tr.state_shardings()):
            out[f"specs@{d}x{m}/{name}{jax.tree_util.keystr(path)}"] = \
                np.asarray(spec_str(sh.spec, len(specs[path].shape)))


def jax_main(out_path: str, params_path: str, entries) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.distributed import AsyncConfig, AsyncTrainer
    from repro.distributed import sharding as JS
    from repro.optim import OptConfig, adam_init
    from repro.optim.pool import init_pools, unpool_tree

    assert jax.device_count() >= 4, jax.devices()
    specs = [parse(e) for e in entries if e.startswith("specs@")]
    entries = [e for e in entries if not e.startswith("specs@")]
    cases = [parse(e) for e in entries if e.split("@")[0] not in SERVES]
    served = [parse(e) for e in entries if e.split("@")[0] in SERVES]
    D.jax_params(params_path, sorted({n for n, _, _ in cases}
                                     | {SERVES[n][0] for n, _, _ in served}))
    given = D.jax_results(params_path)
    out: dict = {}
    for _, d, m in specs:
        _state_specs(d, m, out)
    for name, d, m in served:
        _serve(name, d, m, out)
    for name, d, m in cases:
        key = f"{name}@{d}x{m}"
        arch, impl, mb, dtype, B, S, groups, T = D.ALL_CASES[name]
        cfg = D.case_cfg(name, get_arch)
        jimpl = impl + "_interpret" if impl.startswith("pallas") else impl
        tr = AsyncTrainer(cfg, _mesh(d, m), opt=OptConfig(
            lr=D.LR, clip_norm=1.0, update_impl=jimpl),
            async_cfg=AsyncConfig(delay_rounds=1, microbatches=mb),
            rules=D.case_rules(name, JS))
        tr.n_groups = groups
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.uint16
                                  else a), D.unflatten(given[name]["params"]))
        if tr.pooled:
            pools = init_pools(tr.pool_layout, params, delayed=True)
            for b in pools.values():
                b["gbuf"] = jnp.zeros(b["p"].shape, b["p"].dtype)
            state = {"pools": pools,
                     "opt": {"count": jnp.zeros((), jnp.int32)},
                     "step": jnp.zeros((), jnp.int32)}
        else:
            state = {"params": params, "opt": adam_init(params),
                     "step": jnp.zeros((), jnp.int32),
                     "gbuf": jax.tree_util.tree_map(jnp.zeros_like, params)}
        D._np_tree(state, f"{key}/first", out)
        state = jax.device_put(state, tr.state_shardings())
        step = tr.jit_train_step((B, S), donate=False)
        losses = []
        for q in range(T):
            state, met = step(state, D._jax_batch(cfg, B, S, q),
                              jnp.asarray(D.mask(groups, q)))
            losses.append(float(met["loss"]))
            if q == 0:
                g = (unpool_tree(tr.pool_layout, {
                    dk: b["gbuf"] for dk, b in state["pools"].items()})
                    if tr.pooled else state["gbuf"])
                D._np_tree(g, f"{key}/grads", out)
        out[f"{key}/losses"] = np.asarray(losses)
    np.savez(out_path, **out)


def results(path: str) -> dict:
    """{entry: {"first" | "grads" | "params": {path: array}, "losses" |
    "tokens": array}} from :func:`jax_main`'s file."""
    data = np.load(path)
    res: dict = {}
    for key in data.files:
        entry, rest = key.split("/", 1)
        kind, _, leaf = rest.partition("[")
        if not leaf:
            res.setdefault(entry, {})[kind] = data[key]
        else:
            res.setdefault(entry, {}).setdefault(kind, {})["[" + leaf] = \
                data[key]
    return res


# ---------------------------------------------------------------------------
# the dry-run on a rank of the production meshes
# (tests/test_torch_tp_dryrun*.py)
# ---------------------------------------------------------------------------
def dryrun_both_meshes(arch: str, shape: str, out) -> dict:
    """``python -m repro_torch.launch.dryrun --arch ARCH --shape SHAPE
    --both-meshes --out OUT`` → its records by mesh name."""
    import json

    from repro_torch.launch import dryrun

    dryrun.main(["--arch", arch, "--shape", shape, "--both-meshes",
                 "--out", str(out)])
    recs = {}
    for mesh in dryrun.RANK_MESHES:
        with open(os.path.join(str(out), f"{arch}_{shape}_{mesh}.json")) as f:
            recs[mesh] = json.load(f)
    return recs


def check_rank_records(recs: dict, arch: str, shape: str) -> None:
    """Each production mesh's record of a traced rank: OK, the JAX keys
    (``mesh`` "32x8" / "2x32x8", ``n_devices`` 256 / 512), collectives
    counted, and less state than one card's."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun

    sh = dryrun.SHAPES[shape]
    one = dryrun.state_bytes(dryrun.arch_for_shape(get_arch(arch), sh), sh,
                             dryrun.HOST)
    for mesh, n in (("32x8", 256), ("2x32x8", 512)):
        rec = recs[mesh]
        assert rec["ok"], rec.get("error")
        assert (rec["mesh"], rec["n_devices"], rec["arch"], rec["shape"]) \
            == (mesh, n, arch, shape)
        assert rec["op_cost"]["collective_bytes"] > 0
        assert rec["op_cost"]["collective_breakdown"]
        assert 0 < rec["analytic_state_bytes"] < one


if __name__ == "__main__":
    jax_main(sys.argv[1], sys.argv[2], sys.argv[3:])
