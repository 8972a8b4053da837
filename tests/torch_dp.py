"""Helpers of the data-parallel tests (``tests/test_torch_dp_*.py``).

* :func:`spawn` runs ``fn(rank, world, out_dir, *args)`` in ``world``
  processes started with ``torch.multiprocessing`` (spawn), over gloo,
  rendezvousing through a ``file://`` store under the caller's temporary
  directory (no TCP port, so parallel test workers cannot collide);
* :data:`CASES` are the runs both packages make on a ``(data 2, model 1)``
  mesh, and :func:`jax_main` is the JAX side, run on forced host devices
  as one subprocess per group of :data:`JAX_GROUPS`, side by side
  (``python tests/torch_dp.py OUT.npz PARAMS.npz CASE...``);
* :func:`port_case` is the port's side of a case, on a bound mesh or
  none.

Inputs come from numpy seeds: the params from the JAX initialiser (the
JAX side saves them, the port loads them), each round's tokens from
``default_rng(100 + q)``, the audio frames and vlm patches from
``default_rng(200 + q)`` (:func:`batch`) and the masks from
:data:`MASKS`.  This module
imports neither JAX nor the JAX package at its top: the spawned ranks
import it, and they run the port only.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys

import numpy as np

#: one round's participation per worker group, cycled
MASKS = np.asarray([[1, 1, 0, 1], [1, 0, 1, 1], [0, 1, 1, 1], [1, 1, 1, 0]],
                   np.float32)
LR = 1e-2

#: name → (arch, update impl, microbatches, params dtype, batch, seq,
#: worker groups, rounds)
CASES = {
    "dense_reference": ("qwen2-0.5b", "reference", 1, "float32", 8, 16, 4, 4),
    "dense_pooled": ("qwen2-0.5b", "pallas_pooled", 1, "float32", 8, 16, 4,
                     4),
    "dense_pooled_mb2": ("qwen2-0.5b", "pallas_pooled", 2, "float32", 8, 16,
                         4, 4),
    "moe_reference": ("deepseek-moe-16b", "reference", 1, "float32", 8, 16,
                      4, 4),
    "moe_pooled": ("deepseek-moe-16b", "pallas_pooled", 1, "float32", 8, 16,
                   4, 4),
    # 1 row of 3 tokens a rank: fewer than the 4 experts, so JAX takes one
    # dispatch group over the whole batch
    "moe_fallback": ("deepseek-moe-16b", "pallas_pooled", 1, "float32", 2,
                     3, 2, 3),
    "dense_bf16": ("qwen2-0.5b", "pallas_pooled", 1, "bfloat16", 8, 16, 4,
                   4),
}
#: the tensor-parallel cases of the other four families (f32, T 4); the
#: hybrid's reduced config (two layers, a shared block before each) has
#: no tail, so its case takes three layers with the shared block every
#: two: one group of two, a one-layer tail
FAMILY_CASES = {
    f"{fam}_{impl.split('_')[-1]}": (arch, impl, 1, "float32", 8, 16, 4, 4)
    for fam, arch in (("ssm", "mamba2-370m"), ("hybrid", "zamba2-7b"),
                      ("audio", "seamless-m4t-large-v2"),
                      ("vlm", "pixtral-12b"))
    for impl in ("reference", "pallas_pooled")}
#: the fused per-leaf route (per-leaf ZeRO's cases: the update kernels
#: on each rank's blocks; their plain versions on the CPU), and two
#: microbatches on the reference route
LEAF_CASES = {
    "dense_pallas": ("qwen2-0.5b", "pallas", 1, "float32", 8, 16, 4, 4),
    "moe_pallas": ("deepseek-moe-16b", "pallas", 1, "float32", 8, 16, 4, 4),
    "dense_reference_mb2": ("qwen2-0.5b", "reference", 2, "float32", 8, 16,
                            4, 4)}
#: sequence parallelism (the cases trained under ``SEQ_PARALLEL_RULES``):
#: reduced qwen2-0.5b on the pooled route, its 4 heads on the rank's heads
#: at model 4; and on the per-leaf route with 6 heads, which model 4 does
#: not divide (the gathered attention ``auto_rules`` picks the rules for)
SEQ_CASES = {
    "dense_seq": ("qwen2-0.5b", "pallas_pooled", 1, "float32", 8, 16, 4, 4),
    "dense_seq_h6": ("qwen2-0.5b", "reference", 1, "float32", 8, 16, 4, 4)}
#: every case by name
ALL_CASES = {**CASES, **FAMILY_CASES, **LEAF_CASES, **SEQ_CASES}
#: arch overrides of a case's reduced config
OVERRIDES = {"hybrid_reference": (("n_layers", 3), ("attn_every", 2)),
             "hybrid_pooled": (("n_layers", 3), ("attn_every", 2)),
             "dense_seq_h6": (("n_heads", 6),)}


def case_rules(name, sharding):
    """Case ``name``'s sharding rules from ``sharding`` (either package's
    ``distributed.sharding``)."""
    return sharding.SEQ_PARALLEL_RULES if name in SEQ_CASES \
        else sharding.DEFAULT_RULES


def case_cfg(name, get_arch):
    """Case ``name``'s config from ``get_arch`` (either package's):
    reduced, no remat, the case's dtype and overrides."""
    arch, _, _, dtype, *_rest = ALL_CASES[name]
    return get_arch(arch).reduced().with_(remat="none", dtype=dtype,
                                          **dict(OVERRIDES.get(name, ())))
#: the cases of each JAX subprocess (each draws the params of its own)
JAX_GROUPS = (("dense_reference", "dense_pooled", "dense_pooled_mb2",
               "dense_bf16"), ("moe_reference", "moe_pooled", "moe_fallback"))


def unflatten(flat: dict) -> dict:
    """{"['a']['b']": array} → {"a": {"b": array}}."""
    tree: dict = {}
    for path, a in flat.items():
        keys = re.findall(r"\['([^']*)'\]", path)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = a
    return tree


def tokens(vocab: int, B: int, S: int, q: int) -> np.ndarray:
    return np.random.default_rng(100 + q).integers(
        0, vocab, (B, S)).astype(np.int32)


def mask(groups: int, q: int) -> np.ndarray:
    return MASKS[q % len(MASKS), :groups]


def batch(cfg, specs, q: int) -> dict:
    """Round ``q``'s inputs as numpy arrays of ``specs``' shapes (either
    package's ``batch_specs(cfg, B, S)``): the tokens of :func:`tokens`,
    the audio frames or vlm patches standard normal (f32)."""
    out = {}
    for k, sp in specs.items():
        if k == "tokens":
            out[k] = tokens(cfg.vocab, *sp.shape, q)
        else:
            out[k] = np.random.default_rng(200 + q).standard_normal(
                sp.shape).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# spawned ranks
# ---------------------------------------------------------------------------

def _entry(rank, world, store, out_dir, fn, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        fn(rank, world, out_dir, *args)
    finally:
        dist.destroy_process_group()


def start(fn, world: int, tmp_path, *args):
    """Start ``fn(rank, world, out_dir, *args)`` on ``world`` gloo ranks;
    returns ``(context, out_dir)`` for :func:`join`.  ``out_dir`` (under
    ``tmp_path``) is where the ranks leave their results."""
    import torch.multiprocessing as mp

    out_dir = os.path.join(str(tmp_path), f"ranks{world}")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    ctx = mp.start_processes(_entry, args=(world, store, out_dir, fn, args),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, out_dir


def join(started, timeout: float = 240.0, alive=None) -> str:
    """Wait for :func:`start`'s ranks (raising if one failed; killing them
    all past ``timeout`` seconds, or as soon as ``alive()``, when given,
    is false); returns their ``out_dir``."""
    import time

    ctx, out_dir = started
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        late = time.monotonic() > deadline
        if late or (alive is not None and not alive()):
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks did not finish in {timeout} s" if late
                               else "ranks stopped: what they wait on failed")
    return out_dir


def spawn(fn, world: int, tmp_path, *args, timeout: float = 240.0) -> str:
    """:func:`start` then :func:`join`."""
    return join(start(fn, world, tmp_path, *args), timeout)


# ---------------------------------------------------------------------------
# the port's side of a case
# ---------------------------------------------------------------------------

def port_trainer(name, mesh, device="cpu", opt="adam", lr=LR):
    from repro_torch.configs import get_arch
    from repro_torch.distributed import AsyncConfig, AsyncTrainer
    from repro_torch.distributed import sharding
    from repro_torch.optim import OptConfig

    arch, impl, mb, dtype, B, S, groups, T = ALL_CASES[name]
    cfg = case_cfg(name, get_arch)
    tr = AsyncTrainer(cfg, OptConfig(name=opt, lr=lr, clip_norm=1.0,
                                     update_impl=impl),
                      AsyncConfig(delay_rounds=1, microbatches=mb),
                      device=device, mesh=mesh,
                      rules=case_rules(name, sharding))
    tr.n_groups = groups
    return tr


def gathered(tr, state):
    """The state as one process holds it: a ranked state's leaves
    gathered (a pooled state's m, v and gbuf rows)."""
    from repro_torch.tree import tree_map

    if not tr.ranked:
        return state
    return tree_map(lambda t, sh: sh.gather(t), state, tr.state_shardings())


def port_case(name, mesh, params, device="cpu", opt="adam", rounds=None,
              lr=LR):
    """(losses, round-0 grads, final state, initial state) of case
    ``name`` on ``mesh`` (or none), the trees as numpy (bf16 as uint16
    bits); ``opt``, ``rounds`` and ``lr`` in place of the case's Adam, its
    rounds and :data:`LR`."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.models.convert import params_to_numpy
    from repro_torch.optim.pool import unpool_tree
    from repro_torch.tree import tree_map

    arch, impl, mb, dtype, B, S, groups, T = ALL_CASES[name]
    T = rounds or T
    tr = port_trainer(name, mesh, device, opt, lr)
    state = tr.init_state(params=params)
    first = params_to_numpy(tree_map(torch.clone, gathered(tr, state)))
    step = tr.train_step_fn()
    specs = M.batch_specs(tr.cfg, B, S)
    losses, grads = [], None
    for q in range(T):
        b = {k: torch.from_numpy(v).to(device)
             for k, v in batch(tr.cfg, specs, q).items()}
        b["tokens"] = b["tokens"].long()
        state, m = step(state, b, torch.from_numpy(mask(groups, q)).to(
            device))
        losses.append(float(m["loss"]))
        if q == 0:
            # copies: one process's gbuf is updated in place by the
            # rounds that follow
            full = gathered(tr, state)
            grads = params_to_numpy(tree_map(torch.clone, unpool_tree(
                tr.pool_layout, {dk: b["gbuf"] for dk, b in
                                 full["pools"].items()})
                if tr.pooled else full["gbuf"]))
    return (np.asarray(losses), grads, params_to_numpy(gathered(tr, state)),
            first)


# ---------------------------------------------------------------------------
# the JAX side (a subprocess on forced host devices)
# ---------------------------------------------------------------------------

def start_jax(out_path: str, params_path: str, names) -> subprocess.Popen:
    """Start :func:`jax_main` on the cases ``names`` in a subprocess with
    four host devices; :func:`wait_jax` collects it."""
    env = dict(os.environ)
    # the backend's optimisation level 0 halves the compile time of the
    # trainer steps; the f32 results move by < 1e-5 relative
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=4"
                        " --xla_backend_optimization_level=0").strip()
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             out_path, params_path, *names], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def wait_jax(procs, timeout: float = 600.0) -> None:
    """Wait for every one of :func:`start_jax`'s ``procs``; raises with
    the output of those that failed."""
    failed = []
    for proc in procs:
        out, err = proc.communicate(timeout=timeout)
        if proc.returncode != 0:
            failed.append(f"{out}\n{err}")
    if failed:
        raise RuntimeError("the JAX reference failed:\n" + "\n".join(failed))


def wait_params(params_paths, timeout: float = 240.0) -> dict:
    """The params each :func:`jax_main` writes first, once they are
    there, as one :func:`jax_results` dict."""
    import time

    deadline = time.monotonic() + timeout
    res: dict = {}
    for path in params_paths:
        while not os.path.exists(path):
            if time.monotonic() > deadline:
                raise TimeoutError(f"no {path} in {timeout} s")
            time.sleep(0.2)
        res.update(jax_results(path))
    return res


def jax_params(out_path: str, names) -> None:
    """The initial params of the cases ``names`` from the JAX initialiser
    (one compiled draw per arch and dtype), flattened by path into
    ``out_path``; the file appears whole (written aside, then renamed)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.models import model as JM

    out, drawn = {}, {}
    for name in names:
        cfg = case_cfg(name, get_arch)
        if cfg not in drawn:
            params = jax.jit(JM.init_params, static_argnums=0)(
                cfg, jax.random.PRNGKey(0))
            if cfg.dtype == "float32":
                params = jax.tree_util.tree_map(
                    lambda a: a.astype(jnp.float32), params)
            drawn[cfg] = params
        _np_tree(drawn[cfg], f"{name}/params", out)
    aside = out_path + ".part.npz"
    np.savez(aside, **out)
    os.replace(aside, out_path)


def _jax_batch(cfg, B, S, q) -> dict:
    """Round ``q``'s :func:`batch` as JAX arrays."""
    import jax.numpy as jnp

    from repro.models import model as JM

    return {k: jnp.asarray(v) for k, v in
            batch(cfg, JM.batch_specs(cfg, B, S), q).items()}


def _np_tree(tree, prefix, out):
    import jax

    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        out[prefix + jax.tree_util.keystr(path)] = a


def jax_main(out_path: str, params_path: str, names) -> None:
    """The params first (:func:`jax_params`, into ``params_path``, where the
    port's ranks wait for them); then the cases ``names`` on the JAX
    trainer's own
    compiled step (``jit_train_step``, the state on its shardings), mesh
    (data 2, model 1): the losses, the round-0 delayed buffer (the round's
    gradient) as a tree, and the initial and final states."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_arch
    from repro.distributed import AsyncConfig, AsyncTrainer
    from repro.optim import OptConfig, adam_init
    from repro.optim.pool import init_pools, unpool_tree

    assert jax.device_count() >= 2, jax.devices()
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
    jax_params(params_path, names)
    out = {}
    given = jax_results(params_path)
    for name in names:
        arch, impl, mb, dtype, B, S, groups, T = ALL_CASES[name]
        cfg = case_cfg(name, get_arch)
        jimpl = impl + "_interpret" if impl.startswith("pallas") else impl
        tr = AsyncTrainer(cfg, mesh, opt=OptConfig(
            lr=LR, clip_norm=1.0, update_impl=jimpl),
            async_cfg=AsyncConfig(delay_rounds=1, microbatches=mb))
        tr.n_groups = groups
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.uint16
                                  else a), unflatten(given[name]["params"]))
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
        _np_tree(state, f"{name}/first", out)
        state = jax.device_put(state, tr.state_shardings())
        step = tr.jit_train_step((B, S), donate=False)
        losses = []
        for q in range(T):
            state, m = step(state, _jax_batch(cfg, B, S, q),
                            jnp.asarray(mask(groups, q)))
            losses.append(float(m["loss"]))
            if q == 0:
                g = (unpool_tree(tr.pool_layout, {
                    dk: b["gbuf"] for dk, b in state["pools"].items()})
                    if tr.pooled else state["gbuf"])
                _np_tree(g, f"{name}/grads", out)
        out[f"{name}/losses"] = np.asarray(losses)
        _np_tree(state, f"{name}/final", out)
    np.savez(out_path, **out)


def jax_results(path: str) -> dict:
    """{case: {"params", "first", "grads", "final": {path: array},
    "losses": array}} from :func:`jax_main`'s file."""
    data = np.load(path)
    res: dict = {}
    for key in data.files:
        name, rest = key.split("/", 1)
        kind, _, leaf = rest.partition("[")
        if kind == "losses":
            res.setdefault(name, {})["losses"] = data[key]
        else:
            res.setdefault(name, {}).setdefault(kind, {})["[" + leaf] = \
                data[key]
    return res


if __name__ == "__main__":
    jax_main(sys.argv[1], sys.argv[2], sys.argv[3:])
