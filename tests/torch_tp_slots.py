"""Helpers of the slot lane's mesh tests (``tests/test_torch_tp_slots_*.py``).

* :data:`FAMILIES` are the four families the slot lane serves, reduced, in
  f32: qwen2-0.5b, mamba2-370m, zamba2-7b (three layers, the shared block
  every two: one group of two and a one-layer tail) and deepseek-moe-16b;
  :func:`serve_kw` is one serve of each (requests through ``n_slots``
  lanes, staggered arrivals, ``fedbuff:b=2`` admission);
* :func:`port_serve` is the port's ``SlotServer`` on a bound mesh (or on
  one process), :func:`start_ranks` / :func:`join_ranks` run the entries
  ``FAMILY@DxM`` on gloo ranks spawned beside the test (``torch_dp``'s
  ``file://`` store), each rank pickling its results;
* :func:`resilient_serve` is a dense serve with retries, a poisoned cell,
  a drain and a preemption resumed from the ranked snapshot;
* :func:`jax_main` (``python tests/torch_tp_slots.py OUT.npz PARAMS.npz
  ENTRY...``) is the JAX ``SlotServer`` on four forced host devices: it
  draws each family's params first (the port's ranks wait for them), then
  serves each entry on its mesh.

Like ``torch_dp`` and ``torch_tp``, this module imports neither JAX nor
the JAX package at its top: the spawned ranks import it.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np

import torch_dp as D

#: family → (arch, overrides of its reduced config)
FAMILIES = {"dense": ("qwen2-0.5b", ()),
            "ssm": ("mamba2-370m", ()),
            "hybrid": ("zamba2-7b", (("n_layers", 3), ("attn_every", 2))),
            "moe": ("deepseek-moe-16b", ())}
#: slots per family: the MoE's 8 give each of two data ranks 4 rows, as
#: many as its experts, so JAX dispatches a decode step in two groups
SLOTS = {"moe": 8}
PLEN, MAX_NEW, CTX, K = 8, 6, 16, 2
ADMISSION = "fedbuff:b=2"


def cfg_of(family: str, get_arch):
    """The family's reduced f32 config from ``get_arch`` (either
    package's)."""
    arch, over = FAMILIES[family]
    return get_arch(arch).reduced().with_(remat="none", dtype="float32",
                                          **dict(over))


def serve_kw(family: str, vocab: int) -> dict:
    """One serve's geometry and inputs: ``slots`` (SlotConfig keywords),
    ``prompts``, ``max_new``, ``arrivals`` and ``admission``."""
    S = SLOTS.get(family, 4)
    n = 2 * S - 2
    return {"slots": dict(n_slots=S, ctx_len=CTX, steps_per_launch=K),
            "prompts": np.random.default_rng(5).integers(
                0, vocab, (n, PLEN)).astype(np.int32),
            "max_new": MAX_NEW,
            "arrivals": np.arange(n, dtype=np.int64) * 3 // 2,
            "admission": ADMISSION}


def parse(entry: str) -> tuple:
    """``"dense@2x2"`` → ``("dense", 2, 2)``."""
    fam, mesh = entry.split("@")
    d, m = (int(n) for n in mesh.split("x"))
    return fam, d, m


def result(res) -> dict:
    """A ``ServeResult`` as plain data (its ledger and its schedule)."""
    sch = res.schedule
    return {"tokens": res.tokens, "ttft_steps": res.ttft_steps,
            "occupancy": res.occupancy, "decode_steps": res.decode_steps,
            "chunks": res.chunks, "tap_rows": res.tap_rows,
            "evictions": res.evictions, "timeouts": res.timeouts,
            "shed": res.shed, "drained": res.drained,
            "attempts": res.attempts, "resumed_from": res.resumed_from,
            "schedule": {f: np.asarray(getattr(sch, f)) for f in (
                "workers", "assign_iters", "finish_times", "active_jobs",
                "unfinished_assign_iters")}}


def same(a: dict, b: dict) -> bool:
    """Two :func:`result` dicts are equal, field for field."""
    def eq(x, y):
        if isinstance(x, dict):
            return sorted(x) == sorted(y) and all(eq(x[k], y[k]) for k in x)
        if isinstance(x, np.ndarray):
            return x.shape == np.shape(y) and np.array_equal(x, y)
        return x == y
    return sorted(a) == sorted(b) and all(eq(a[k], b[k]) for k in a)


def server(family: str, mesh, kw: dict):
    from repro_torch.configs import get_arch
    from repro_torch.distributed import SlotConfig, SlotServer

    return SlotServer(cfg_of(family, get_arch), SlotConfig(**kw["slots"]),
                      device="cpu", mesh=mesh)


def whole_params(family: str, params_paths=None) -> dict:
    """The family's whole f32 params as torch tensors: the JAX draw from
    :func:`jax_main`'s file, or the port's initialiser (seed 0)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.tree import tree_map

    if params_paths:
        return params_from_numpy(D.unflatten(
            D.wait_params(params_paths)[family]["params"]), "cpu")
    cfg = cfg_of(family, get_arch)
    return tree_map(lambda t: t.to(torch.float32),
                    init_params(cfg, 0, "cpu"))


def rank_params(srv, params):
    """This rank's blocks of the whole ``params`` (``params`` itself
    without a mesh)."""
    from repro_torch.tree import tree_map

    sh = srv.param_shardings()
    if sh is None:
        return params
    return tree_map(lambda t, s: s.local(t).clone(), params, sh)


def port_serve(family: str, mesh, params_paths=None) -> dict:
    """:func:`result` of the port's ``SlotServer`` on ``mesh`` (a bound
    mesh or None) serving :func:`serve_kw`, greedy."""
    import torch

    from repro_torch.configs import get_arch

    kw = serve_kw(family, cfg_of(family, get_arch).vocab)
    srv = server(family, mesh, kw)
    params = rank_params(srv, whole_params(family, params_paths))
    with torch.no_grad():
        res = srv.serve(params, kw["prompts"], kw["max_new"],
                        admission=kw["admission"], arrivals=kw["arrivals"])
    return result(res)


def resilient_serve(mesh, snapdir: str) -> dict:
    """A dense serve with retries (two attempts), a poisoned cell, a drain
    and a preemption at step 6, resumed from the snapshot it left under
    ``snapdir`` (on a mesh: the ranked snapshot) → {"resumed": its
    :func:`result`, "preempted_at": the step the first call stopped at,
    "snapshot": the directory it resumed from}."""
    import torch

    from repro_torch.checkpoint import AsyncSnapshotter
    from repro_torch.configs import get_arch
    from repro_torch.distributed import RetryPolicy, ServePreempted
    from repro_torch.faults import ServeFaults

    kw = serve_kw("dense", cfg_of("dense", get_arch).vocab)
    srv = server("dense", mesh, kw)
    params = rank_params(srv, whole_params("dense"))
    args = dict(admission=kw["admission"], arrivals=kw["arrivals"],
                retry=RetryPolicy(2, backoff_base=2), drain_after=7,
                faults=ServeFaults(poisons=((1, 3),), preempt_steps=(6,)))
    with torch.no_grad():
        try:
            srv.serve(params, kw["prompts"], kw["max_new"],
                      snapshot=AsyncSnapshotter(snapdir, 2, keep=3), **args)
            raise AssertionError("the serve was not preempted")
        except ServePreempted as e:
            at = e.step
        _, latest = AsyncSnapshotter.latest(snapdir)
        res = srv.serve(params, kw["prompts"], kw["max_new"],
                        resume_from=latest, **args)
    return {"resumed": result(res), "preempted_at": at, "snapshot": latest}


def _ranks(rank, world, out_dir, entries, params_paths, resilient):
    from repro_torch.launch.mesh import ProcessMesh

    out = {}
    for e in entries:
        fam, d, m = parse(e)
        if d * m == world:
            out[e] = port_serve(fam, ProcessMesh({"data": d, "model": m}),
                                params_paths)
    if resilient and world == 4:
        out["resilient"] = resilient_serve(
            ProcessMesh({"data": 2, "model": 2}),
            os.path.join(out_dir, "snap"))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def start_ranks(tmp, entries, params_paths=None, resilient=False) -> list:
    """The gloo worlds of ``entries`` (one per rank count), started."""
    worlds = sorted({d * m for _, d, m in map(parse, entries)}
                    | ({4} if resilient else set()), reverse=True)
    return [(w, D.start(_ranks, w, tmp / f"w{w}", entries, params_paths,
                        resilient)) for w in worlds]


def join_ranks(started, alive=None) -> dict:
    """{entry: [each rank's result]} of :func:`start_ranks`' worlds."""
    out: dict = {}
    for w, s in started:
        d = D.join(s, alive=alive)
        for r in range(w):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                for k, v in pickle.load(f).items():
                    out.setdefault(k, []).append(v)
    return out


# ---------------------------------------------------------------------------
# the JAX side (a subprocess on four forced host devices)
# ---------------------------------------------------------------------------

def start_jax(out_path: str, params_path: str, entries) -> subprocess.Popen:
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


def jax_main(out_path: str, params_path: str, entries) -> None:
    """The families' params from the JAX initialiser (f32) into
    ``params_path`` first, then each entry's greedy tokens from the JAX
    ``SlotServer`` on its (data, model) mesh into ``out_path``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_arch
    from repro.distributed import SlotConfig, SlotServer
    from repro.models import model as JM

    assert jax.device_count() >= 4, jax.devices()
    fams = sorted({parse(e)[0] for e in entries})
    params, flat = {}, {}
    for fam in fams:
        cfg = cfg_of(fam, get_arch)
        params[fam] = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32),
            jax.jit(JM.init_params, static_argnums=0)(
                cfg, jax.random.PRNGKey(0)))
        D._np_tree(params[fam], f"{fam}/params", flat)
    aside = params_path + ".part.npz"
    np.savez(aside, **flat)
    os.replace(aside, params_path)
    out = {}
    for e in entries:
        fam, d, m = parse(e)
        cfg = cfg_of(fam, get_arch)
        kw = serve_kw(fam, cfg.vocab)
        mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                    ("data", "model"))
        srv = SlotServer(cfg, mesh, SlotConfig(**kw["slots"]))
        res = srv.serve(jax.device_put(params[fam], srv.param_shardings()),
                        kw["prompts"], kw["max_new"],
                        admission=kw["admission"], arrivals=kw["arrivals"])
        out[f"{e}/tokens"] = np.asarray(res.tokens)
        out[f"{e}/ttft_steps"] = np.asarray(res.ttft_steps)
    np.savez(out_path, **out)


if __name__ == "__main__":
    jax_main(sys.argv[1], sys.argv[2], sys.argv[3:])
