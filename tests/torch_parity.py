"""Helpers shared by the tests that hold `repro_torch` to the JAX package.

Arrays cross between the packages as numpy; bf16 crosses as its bits
(``repro_torch.models.convert``).  Inputs are drawn with numpy from a seed
and handed to both.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro_torch.models import init_params, params_to_numpy
from repro_torch.models.convert import params_from_numpy
from repro_torch.tree import tree_leaves_with_path

# The suite runs its files in parallel worker processes (pytest-xdist).
# torch's intra-op pool, a thread per core in every worker, oversubscribes
# the cores several times over, and the port's CPU tests are mostly small
# ops: four of their files took 197 s on 4 workers so and 65 s with one
# thread per worker.  Every port test file that compares with JAX imports
# this module, so each worker runs torch on one thread.
torch.set_num_threads(1)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def pair(x: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a CPU torch tensor of ``dtype``."""
    return (jnp.asarray(x).astype(_JNP[dtype]),
            torch.from_numpy(np.array(x)).to(_TORCH[dtype]))


def f32(x) -> np.ndarray:
    """A JAX array or torch tensor as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def port_params(jax_tree, device="cpu"):
    """A JAX param/cache tree carried into the port."""
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_tree),
                             device=device)


def to_jax(tree):
    """A numpy tree from the port (bf16 as uint16 bits) as JAX arrays."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.uint16
                              else a), tree)


def jax_serve(job, T, seed, params):
    """The JAX ServeBackend's lock-step lane on given params: the same
    ``default_rng(seed)`` prompts, prefill, first token by argmax, then
    ``T − 1`` decode steps.  Returns (prompts, (batch, T) tokens)."""
    from repro.distributed import Server, ServeConfig
    from repro.launch.mesh import make_host_mesh
    from repro.models import prefill

    cfg = job.make_arch()
    ctx = job.prompt_len + T
    server = Server(cfg, make_host_mesh(),
                    ServeConfig(batch=job.batch, ctx_len=ctx, seed=seed))
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab, (job.batch, job.prompt_len)).astype(np.int32)
    last, cache = prefill(cfg, params, {"tokens": jnp.asarray(prompts)},
                          ctx_len=ctx)
    toks = np.asarray(jnp.argmax(last, axis=-1).astype(jnp.int32))
    gen = server.generate(params, toks, T - 1, start_pos=job.prompt_len,
                          cache=cache)
    return prompts, np.concatenate([toks[:, None], gen], axis=1)


def tree_f32(jax_tree):
    """Cast every floating leaf of a JAX tree to float32."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, jax_tree)


def port_init_as_jax(cfg, seed):
    """The port's ``init_params(cfg, seed)`` on the CPU, as a JAX tree."""
    return to_jax(params_to_numpy(init_params(cfg, seed, device="cpu")))


def assert_tree_close(port_tree, jax_tree, **tol):
    """The same leaf paths, shapes and (within ``tol``) values."""
    want = dict(tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jax_tree)))
    got = dict(tree_leaves_with_path(port_tree))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        np.testing.assert_allclose(f32(got[path]), np.asarray(w, np.float32),
                                   err_msg=path, **tol)


def jax_run_inputs(jspec, adaptive=False):
    """The JAX ``TrainerBackend`` run's initial params and its per-round
    batches (each a dict of numpy arrays: tokens, and frames or patches for
    the audio and vlm families), for the port's ``params_fn`` /
    ``batch_fn`` hooks."""
    from repro.api import TrainerBackend as JBackend
    from repro.models import model as JM
    from repro.runtime import compile_plan, make_batch_fn

    job = jspec.objective
    cfg = job.make_arch()
    params = JM.init_params(cfg, jax.random.PRNGKey(jspec.seed))
    masks, schedule = JBackend.masks_for(jspec, jspec.n_workers)
    plan = compile_plan(schedule, job, rounds=min(jspec.T, masks.shape[0]),
                        n_groups=jspec.n_workers, seed=jspec.seed,
                        adaptive=adaptive)
    batch_of = jax.jit(make_batch_fn(plan, cfg))
    batches = [{k: np.asarray(v) for k, v in batch_of(jnp.asarray(key)).items()}
               for key in plan.data_keys]
    return params, batches


def torch_batch(batch: dict) -> dict:
    """A numpy batch as CPU tensors: int64 tokens, f32 modality inputs."""
    return {k: torch.from_numpy(np.array(v)).long() if v.dtype.kind == "i"
            else torch.from_numpy(np.array(v, np.float32))
            for k, v in batch.items()}


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
