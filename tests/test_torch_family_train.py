"""Training the ssm, hybrid and MoE families: the port against the JAX
package.

mamba2-370m, zamba2-7b and deepseek-moe-16b, reduced.  zamba2-7b runs in
two layouts: the reduced one (2 layers, the shared block before each, no
tail) and one with a tail (3 layers, ``attn_every=2``: one insertion, a
group of 2 and a 1-layer tail).  Params come from the JAX init and cross
with ``models.convert``; tokens are drawn with numpy from a seed.

* Loss and every leaf's gradient against ``jax.grad`` in f32, with the
  port at ``remat="none"`` and ``"full"`` (both against JAX's plain
  backward: recomputation replays the same operations).  The loss is held
  at the f32 tolerance of ``tests/test_torch_trainer.py`` (rtol 1e-4,
  atol 1e-5) and each gradient leaf to a 1e-3 relative L2 error: the two
  frameworks sum in other orders, and through the SSD scan's exponentials
  and the MoE's gates that leaves a few leaves at 1–2e-4 relative L2
  (1.7e-4 the worst measured), with single small entries further out than
  an elementwise rtol of 1e-4 allows.
* Rounds of the ``AsyncTrainer`` (Adam, delay 1, participation masks) on
  the fused per-leaf route against JAX's reference update, in f32: every
  round's metrics at rtol 1e-4 / atol 1e-5, the final params to a 1e-3
  relative L2 per leaf.  That is looser than the 1e-4 of
  ``tests/test_torch_trainer.py`` because Adam's normalised step m/√v
  turns the frameworks' ulp-level differences in a near-zero gradient
  into an lr-sized step: on the hybrid with a tail, 2 of 131,072 embed
  entries whose gradients are ~1e-9 (and change sign between the two)
  move 2.4e-4 and 3.4e-3 apart, 4.5e-4 relative L2 over the leaf, while
  every loss and gradient norm agrees to 1e-4.
* The ``TrainerBackend`` curve on the JAX run's params and batches,
  against the JAX ``TrainerBackend`` at the trainer-curve tolerance
  (rtol 5e-3).  The MoE and the hybrid run with f32 activations (bf16
  params): in bf16 the two frameworks' rounding moves the MoE's tokens
  across routing boundaries (loss 6.5424 against 6.5277 at init), and
  the hybrid's logits drift by bf16 ulps per layer
  (``tests/test_torch_hybrid.py``), which Adam's first step turns into a
  0.7 % loss difference at round 2; no tolerance on the curve would
  separate either from a fault.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402
from jax.sharding import Mesh                                  # noqa: E402

from repro.api import ExperimentSpec as JSpec                  # noqa: E402
from repro.api import TrainerBackend as JBackend               # noqa: E402
from repro.api import TrainJob as JTrainJob                    # noqa: E402
from repro.configs import get_arch                             # noqa: E402
from repro.distributed import AsyncConfig as JAsyncConfig      # noqa: E402
from repro.distributed import AsyncTrainer as JTrainer         # noqa: E402
from repro.models import model as JM                           # noqa: E402
from repro.optim import OptConfig as JOptConfig                # noqa: E402
from repro_torch.api import ExperimentSpec, TrainerBackend, TrainJob  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch         # noqa: E402
from repro_torch.distributed import AsyncConfig, AsyncTrainer  # noqa: E402
from repro_torch.models import model as TM                     # noqa: E402
from repro_torch.optim import OptConfig                        # noqa: E402
from repro_torch.tree import tree_leaves_with_path             # noqa: E402
from torch_parity import (f32, jax_run_inputs, port_params,    # noqa: E402
                          rel_l2, torch_batch, tree_f32)

F32_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_REL_L2 = 1e-3
#: label → (arch, overrides of the reduced config)
CASES = {
    "mamba2-370m": ("mamba2-370m", ()),
    "zamba2-7b": ("zamba2-7b", ()),
    "zamba2-7b-tail": ("zamba2-7b", (("n_layers", 3), ("attn_every", 2))),
    "deepseek-moe-16b": ("deepseek-moe-16b", ()),
}
B, S, GROUPS = 4, 32, 2
MASKS = np.asarray([[1, 1], [1, 0], [0, 2]], np.float32)


def _cfgs(label, **over):
    arch, extra = CASES[label]
    over = dict(extra, dtype="float32", **over)
    return (get_arch(arch).reduced().with_(**over),
            t_get_arch(arch).reduced().with_(**over))


def _tokens(vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@functools.cache
def _jax_grads(label):
    """JAX's f32 params, tokens, weights, loss, aux and grads (one jit per
    layout, shared by both remat cases)."""
    jcfg, _ = _cfgs(label, remat="none")
    jp = tree_f32(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tok = _tokens(jcfg.vocab, 1)
    w = np.asarray([1.0, 1.0, 0.0, 2.0], np.float32)

    def loss(p):
        out, parts = JM.loss_fn(jcfg, p, {"tokens": jnp.asarray(tok)},
                                example_weights=jnp.asarray(w))
        return out, parts["aux"]

    (jl, jaux), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
    return jp, tok, w, float(jl), float(jaux), jg


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("label", list(CASES))
def test_loss_and_grads_match_jax(label, remat):
    jp, tok, w, jl, jaux, jg = _jax_grads(label)
    _, tcfg = _cfgs(label, remat=remat)
    tp = jax.tree_util.tree_map(lambda t: t.requires_grad_(True),
                                port_params(jp))
    loss, parts = TM.loss_fn(tcfg, tp, {"tokens": torch.from_numpy(tok)},
                             example_weights=torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(loss.item(), jl, **F32_TOL)
    np.testing.assert_allclose(parts["aux"].item(), jaux, **F32_TOL)
    if tcfg.family == "moe":
        assert jaux > 0
    want = dict(tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jg)))
    got = dict(tree_leaves_with_path(tp))
    assert sorted(got) == sorted(want)
    if "tail" in label:
        assert "tail" in tp
    for path, g in want.items():
        assert got[path].grad is not None, path
        assert rel_l2(f32(got[path].grad), g) < GRAD_REL_L2, path


@pytest.mark.parametrize("label", ["mamba2-370m", "zamba2-7b-tail",
                                   "deepseek-moe-16b"])
def test_train_rounds_match_jax_f32(label):
    """Three rounds of Adam with delay 1 under participation masks: the
    JAX trainer's reference update against the port's fused per-leaf route
    (the update kernels' plain versions on f32 leaves)."""
    jcfg, tcfg = _cfgs(label, remat="none")
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jt = JTrainer(jcfg, mesh, opt=JOptConfig(name="adam", lr=1e-2,
                                             update_impl="reference"),
                  async_cfg=JAsyncConfig(delay_rounds=1))
    jt.n_groups = GROUPS
    js = jt.init_state(jax.random.PRNGKey(0))
    js = dict(js, params=tree_f32(js["params"]), gbuf=tree_f32(js["gbuf"]))
    tt = AsyncTrainer(tcfg, opt=OptConfig(name="adam", lr=1e-2,
                                          update_impl="pallas"),
                      async_cfg=AsyncConfig(delay_rounds=1), device="cpu")
    tt.n_groups = GROUPS
    ts = tt.init_state(0, params=port_params(js["params"]))
    jstep, tstep = jax.jit(jt.train_step_fn()), tt.train_step_fn()
    for q, mask in enumerate(MASKS):
        tok = _tokens(jcfg.vocab, 10 + q)
        js, jm = jstep(js, {"tokens": jnp.asarray(tok)}, jnp.asarray(mask))
        ts, tm = tstep(ts, {"tokens": torch.from_numpy(tok)},
                       torch.from_numpy(mask))
        for k in ("loss", "ce", "aux", "grad_norm", "participation"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                       err_msg=f"round {q} {k}", **F32_TOL)
    assert int(ts["step"]) == int(js["step"]) == len(MASKS)
    want = dict(tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, js["params"])))
    got = dict(tree_leaves_with_path(ts["params"]))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert rel_l2(f32(got[path]), w) < 1e-3, path


@pytest.mark.parametrize("label", ["mamba2-370m", "zamba2-7b-tail",
                                   "deepseek-moe-16b"])
def test_backend_curve_matches_jax(label):
    """``run(TrainJob(arch=...))`` end to end: the port's scan runtime with
    the pooled update (one bf16 and one f32 pool holding every leaf), on
    the JAX run's params and batches, against the JAX backend's eager
    reference run (bf16 params; the MoE and the hybrid with f32
    activations, see the module docstring)."""
    arch, over = CASES[label]
    if arch != "mamba2-370m":
        over = over + (("dtype", "float32"),)
    job = dict(arch=arch, arch_overrides=over, global_batch=4, seq_len=16)
    spec = dict(scheduler="pure", timing="fixed:slow=4", n_workers=2, T=4,
                seed=1, stepsize=1e-2)
    jspec = JSpec(objective=JTrainJob(**job), **spec)
    want = JBackend(runtime="eager").run(jspec)
    params, batches = jax_run_inputs(jspec)
    got = TrainerBackend(
        "cpu", params_fn=lambda cfg, dev: port_params(params),
        batch_fn=lambda q: torch_batch(batches[q])).run(ExperimentSpec(
            objective=TrainJob(update_impl="pallas_pooled", **job), **spec))
    np.testing.assert_allclose(got.losses, want.losses, rtol=5e-3)
    np.testing.assert_allclose(got.grad_norms, want.grad_norms, rtol=5e-3,
                               atol=1e-6)
    np.testing.assert_array_equal(got.extra["masks"], want.extra["masks"])
    assert got.extra["arch"] == want.extra["arch"] == arch
    assert got.extra["update_launches"]["fused_adam_delayed"] == 0  # CPU
    cfg = TrainJob(**job).make_arch()
    assert sum(p["p"].numel() for p in got.x["pools"].values()) == \
        TM.n_params(cfg)
