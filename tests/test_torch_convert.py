"""Weights across the packages, and the port's copies of the configs."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                 # noqa: E402

from repro.configs import ARCHS                            # noqa: E402
from repro.models import model as JM                       # noqa: E402
from repro_torch.configs import ARCHS as T_ARCHS           # noqa: E402
from repro_torch.models import (init_params, param_specs,  # noqa: E402
                                params_from_numpy, params_to_numpy)
from torch_parity import port_params, tree_f32             # noqa: E402


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_round_trip_is_bitwise(dtype):
    cfg = T_ARCHS["qwen2-0.5b"].reduced()
    params = init_params(cfg, 7, device="cpu")
    if dtype == "float32":
        params = {k: v for k, v in params.items()}
        params["embed"] = params["embed"].float()
    tree = params_to_numpy(params)
    if dtype == "bfloat16":
        assert tree["embed"].dtype == np.uint16
    back = params_from_numpy(tree, device="cpu")
    for (path, a), (_, b) in zip(_flat(params), _flat(back)):
        assert a.dtype == b.dtype, path
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b), path


def test_jax_bf16_params_cross_bitwise():
    jcfg = ARCHS["qwen2-0.5b"].reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = port_params(jp)
    for (path, a), (_, b) in zip(_flat(jax.tree_util.tree_map(np.asarray, jp)),
                                 _flat(params_to_numpy(tp))):
        assert np.array_equal(a.view(np.uint16) if a.dtype.name == "bfloat16"
                              else a, b), path
    t32 = port_params(tree_f32(jp))
    assert t32["embed"].dtype == torch.float32


@pytest.mark.parametrize("reduced", [True, False])
def test_param_tree_paths_and_shapes_match_jax(reduced):
    jcfg, tcfg = ARCHS["qwen2-0.5b"], T_ARCHS["qwen2-0.5b"]
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    want = {p: (s.shape, s.dtype) for p, s in _flat(JM.param_specs(jcfg))}
    got = {p: (s.shape, s.dtype) for p, s in _flat(param_specs(tcfg))}
    assert got == want
    if reduced:
        params = init_params(tcfg, 0, device="cpu")
        assert {p: tuple(t.shape) for p, t in _flat(params)} == \
            {p: s for p, (s, _) in want.items()}
        assert params["blocks"]["attn"]["wq"].dtype == torch.bfloat16


def test_init_is_seeded_and_per_leaf():
    cfg = T_ARCHS["qwen2-0.5b"].reduced()
    a, b = (init_params(cfg, 1, device="cpu") for _ in range(2))
    c = init_params(cfg, 2, device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    # the JAX law's fan-in of a stacked (L, d, H, Dh) leaf is L·d
    want = (cfg.n_layers * cfg.d_model) ** -0.5
    wq = a["blocks"]["attn"]["wq"].float()
    assert abs(wq.std().item() - want) < 0.05 * want


def test_config_copies_equal_jax_archs():
    assert sorted(T_ARCHS) == sorted(ARCHS)
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(T_ARCHS[name]) == dataclasses.asdict(cfg)
        assert dataclasses.asdict(T_ARCHS[name].reduced()) == \
            dataclasses.asdict(cfg.reduced())


def test_mamba_params_and_cache_cross_bitwise():
    """The SSM family's f32 leaves (A_log, D, dt_bias) and f32 SSD cache
    cross as f32, its bf16 leaves and conv cache as uint16 bits; both ways
    bitwise."""
    jcfg = ARCHS["mamba2-370m"].reduced().with_(remat="none")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 16))
    _, jc = JM.prefill(jcfg, jp, {"tokens": jax.numpy.asarray(tokens)})
    for jtree in (jp, jc):
        ttree = port_params(jtree)
        back = params_to_numpy(ttree)
        for (path, a), (_, b) in zip(
                _flat(jax.tree_util.tree_map(np.asarray, jtree)), _flat(back)):
            bf16 = a.dtype.name == "bfloat16"
            assert b.dtype == (np.uint16 if bf16 else a.dtype), path
            assert np.array_equal(a.view(np.uint16) if bf16 else a, b), path
    tp = port_params(jp)
    for leaf in ("A_log", "D", "dt_bias"):
        assert tp["blocks"]["mamba"][leaf].dtype == torch.float32
    assert tp["blocks"]["mamba"]["in_x"].dtype == torch.bfloat16
    tc = port_params(jc)
    assert tc["ssm"]["ssd"].dtype == torch.float32
    assert tc["ssm"]["conv"].dtype == torch.bfloat16
