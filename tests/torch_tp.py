"""The JAX side of the tensor-parallel tests (``tests/test_torch_tp_jax.py``).

``python tests/torch_tp.py OUT.npz PARAMS.npz CASE@DxM ... [serve@DxM]``
runs on four forced host devices: it draws the cases' params first
(``torch_dp.jax_params``, into ``PARAMS.npz``, where the port's ranks
wait for them), then runs each case of ``torch_dp.CASES`` on the JAX
trainer's own compiled step on the mesh (data D, model M) (the losses,
the round-0 delayed buffer, the initial state), and ``serve@DxM`` the JAX
``Server`` on that mesh: reduced qwen2-0.5b in f32, the prompts prefilled,
then greedy decode (:data:`SERVE`).  Like ``torch_dp``, this module
imports neither JAX nor the JAX package at its top.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

import torch_dp as D

#: the served case: (arch, batch, prompt length, decode steps, ctx length,
#: the prompts' round in ``torch_dp.tokens``)
SERVE = ("qwen2-0.5b", 4, 12, 6, 24, 7)


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


def _serve(d, m, out):
    """The JAX ``Server`` on (d, m): greedy tokens from prefilled prompts."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.distributed.serve import Server, ServeConfig
    from repro.models import model as JM

    arch, B, S, T, ctx, q = SERVE
    cfg = get_arch(arch).reduced().with_(dtype="float32", remat="none")
    params = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32),
        jax.jit(JM.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0)))
    tokens = jnp.asarray(D.tokens(cfg.vocab, B, S, q))
    last, cache = jax.jit(JM.prefill, static_argnums=(0, 3))(
        cfg, params, {"tokens": tokens}, ctx)
    first = np.asarray(jnp.argmax(last, -1)).astype(np.int32)
    server = Server(cfg, _mesh(d, m), ServeConfig(batch=B, ctx_len=ctx))
    params = jax.device_put(params, server.param_shardings())
    cache = jax.device_put(cache, server.cache_shardings())
    toks = server.generate(params, first, T, start_pos=S, cache=cache)
    out[f"serve@{d}x{m}/tokens"] = np.concatenate([first[:, None], toks], 1)


def jax_main(out_path: str, params_path: str, entries) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.distributed import AsyncConfig, AsyncTrainer
    from repro.optim import OptConfig, adam_init
    from repro.optim.pool import init_pools, unpool_tree

    assert jax.device_count() >= 4, jax.devices()
    cases = [parse(e) for e in entries if not e.startswith("serve@")]
    D.jax_params(params_path, sorted({n for n, _, _ in cases}))
    given = D.jax_results(params_path)
    out: dict = {}
    for e in entries:
        if e.startswith("serve@"):
            _, d, m = parse(e)
            _serve(d, m, out)
    for name, d, m in cases:
        key = f"{name}@{d}x{m}"
        arch, impl, mb, dtype, B, S, groups, T = D.CASES[name]
        cfg = get_arch(arch).reduced().with_(remat="none", dtype=dtype)
        jimpl = impl + "_interpret" if impl.startswith("pallas") else impl
        tr = AsyncTrainer(cfg, _mesh(d, m), opt=OptConfig(
            lr=D.LR, clip_norm=1.0, update_impl=jimpl),
            async_cfg=AsyncConfig(delay_rounds=1, microbatches=mb))
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
            state, met = step(state, {"tokens": jnp.asarray(
                D.tokens(cfg.vocab, B, S, q))}, jnp.asarray(D.mask(groups, q)))
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


if __name__ == "__main__":
    jax_main(sys.argv[1], sys.argv[2], sys.argv[3:])
