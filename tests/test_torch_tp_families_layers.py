"""Tensor parallelism of the ssm, hybrid, audio and vlm families in one
process, with no process group.

Each rank's part runs through the product path's own ``TP`` layers, the
ranks as threads (``models.tp.ThreadRanks``, whose operators combine the
ranks' tensors as the collectives would), on reduced mamba2-370m,
zamba2-7b (five layers, the shared block every two: two groups and a
one-layer tail), seamless-m4t-large-v2 and pixtral-12b in f32, params
from the port's initialiser cast to f32, inputs from numpy seeds.  At a
model axis of 2 and 4: ``forward_logits`` and ``loss_fn`` equal the
unsharded model's within 1e-5, and so do ``prefill`` and three
``decode_step`` calls at every step, with equal greedy tokens.

The two places where the rules' split is not a Megatron one are held
here: the gated norm spans the whole ``d_inner`` (a case whose ranks'
halves differ in scale by 10³, where a per-rank norm is off by far more
than the tolerance), and the conv state's split does not line up with
the heads: after ``prefill`` and after each of three decode steps, every
rank's conv state is ``NamedSharding.local`` of the unsharded model's,
bit for bit.  That is checked on one Mamba2 layer, where the ranks'
arithmetic is the unsharded model's (deeper, the summed row-parallel
outputs round differently: the forward tests hold the values).

The slot lane's three entry points over a model axis run: the ragged
decode under a model-axis context (rank 0 of a traced mesh, on its
blocks), ``ServeBackend``'s slot lane on gloo ranks at (data 1, model 2)
with the token matrix of one process, and ``profile_serve.py --slots
--mesh``, which hands the slot lane the bound mesh.  The plans at
production widths:
zamba2-7b's 112 SSM heads as 14 a rank at model 8, pixtral's 8 kv heads
as 1 a rank, seamless's 256206 words split at model 2 and not at 4 or 8
(its unembedding is gathered there).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch                       # noqa: E402
from repro_torch.distributed import sharding as TS             # noqa: E402
from repro_torch.distributed.sharding import tree_shardings    # noqa: E402
from repro_torch.launch.mesh import Mesh                       # noqa: E402
from repro_torch.models import layers as L                     # noqa: E402
from repro_torch.models import model as M                      # noqa: E402
from repro_torch.models import tp as TPM                       # noqa: E402
from repro_torch.tree import tree_map                          # noqa: E402

ARCHS = {"mamba2-370m": {}, "zamba2-7b": dict(n_layers=5, attn_every=2),
         "seamless-m4t-large-v2": {}, "pixtral-12b": {}}
CASES = [(a, m) for a in ARCHS for m in (2, 4)]
TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 16


def _cfg(arch, **kw):
    return get_arch(arch).reduced().with_(dtype="float32", remat="none",
                                          **{**ARCHS.get(arch, {}), **kw})


def _params(cfg):
    return tree_map(lambda p: p.float(), M.init_params(cfg, 0, "cpu"))


def _blocks(cfg, m, params):
    sh = tree_shardings(M.param_specs(cfg), Mesh({"model": m}))
    return [tree_map(lambda t, s, r=r: s.local(t, rank=r), params, sh)
            for r in range(m)]


def _batch(cfg, seed=7):
    """Tokens, and the frames (audio) or patches (vlm) of
    ``batch_specs``' shapes."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, sp in M.batch_specs(cfg, B, S).items():
        out[k] = torch.from_numpy(
            rng.integers(0, cfg.vocab, sp.shape) if k == "tokens"
            else rng.standard_normal(sp.shape).astype(np.float32))
    return out


def test_the_plans_reach_the_new_splits():
    """Reduced and production widths: the Mamba2 mixer on the SSM heads,
    its conv and ``in_B`` / ``in_C`` on other dims (gathered on use), the
    caches' splits, the attention and the vocabulary where they fall
    through."""
    ssm = TPM.plan(_cfg("mamba2-370m"), 2)["mamba"]
    assert all(ssm[n] == d for n, d in TPM.MAMBA_MEGATRON.items())
    assert (ssm["conv_w"], ssm["conv_b"], ssm["in_B"], ssm["norm"]) == \
        (1, 0, 0, 0)
    assert TPM.cache_split(_cfg("mamba2-370m"), 4, 4, 32) == \
        {"conv": 2, "ssd": 1}
    hyb = _cfg("zamba2-7b")
    assert TPM.plan(hyb, 2)["attn"]["wq"] == 1
    assert TPM.plan(hyb, 4)["attn"]["wq"] == 0          # 2 heads: gathered
    assert set(TPM.cache_split(hyb, 2, 4, 32)) == \
        {"ring", "positions", "conv", "ssd"}
    assert TPM.cache_split(_cfg("seamless-m4t-large-v2"), 2, 4, 32)[
        "cross"] == 2
    assert TPM.plan(_cfg("pixtral-12b"), 2)["projector"] == 1
    z8 = TPM.plan(get_arch("zamba2-7b"), 8)
    assert z8["mamba"]["in_dt"] == 1 and z8["attn"]["wq"] == 1
    assert TPM.cache_split(get_arch("zamba2-7b"), 8, 128, 4096)["ssd"] == 1
    p8 = TPM.plan(get_arch("pixtral-12b"), 8)["attn"]
    assert (p8["wq"], p8["wk"]) == (1, 1)               # 4 q on 1 kv head
    s = get_arch("seamless-m4t-large-v2")
    assert TPM.plan(s, 2)["lm_head"] == 1
    assert TPM.plan(s, 4)["lm_head"] == 0 and TPM.plan(s, 8)["embed"] == 1


@pytest.mark.parametrize("m", (2, 4))
def test_gated_norm_over_split_columns_with_unequal_halves(m):
    """``layers.gated_rms_norm`` on each rank's columns, its Σy² summed
    over the ranks, equals the norm over the whole width when the ranks'
    columns differ in scale by 10³; a norm over each rank's columns alone
    is far off."""
    rng = np.random.default_rng(3)
    w = 64
    y = torch.from_numpy(rng.standard_normal((2, 5, w)).astype(np.float32))
    y[..., w // m:] *= 1e3
    z = torch.from_numpy(rng.standard_normal((2, 5, w)).astype(np.float32))
    g = torch.from_numpy(rng.uniform(0.5, 1.5, w).astype(np.float32))
    want = L.gated_rms_norm(y, z, g, 1e-5)
    n = w // m
    cols = [slice(r * n, (r + 1) * n) for r in range(m)]
    sq = [torch.sum((y[..., c] * torch.nn.functional.silu(z[..., c])) ** 2,
                    dim=-1, keepdim=True) for c in cols]
    total = sum(sq[1:], sq[0])
    got = torch.cat([L.gated_rms_norm(y[..., c], z[..., c], g[c], 1e-5,
                                      lambda t: total, w) for c in cols], -1)
    torch.testing.assert_close(got, want, **TOL)
    alone = torch.cat([L.gated_rms_norm(y[..., c], z[..., c], g[c], 1e-5)
                       for c in cols], -1)
    assert (alone - want).abs().max() > 1e-1


@pytest.mark.parametrize("m", (2, 4))
def test_mamba_block_with_unequal_rank_halves_equals_the_block(m):
    """The Mamba2 block through ``TP.mamba`` on each rank's heads, with the
    x projection's columns of the last rank scaled by 10³ (so its part of
    the gated norm's input dwarfs the others), equals the unsharded block
    (the whole output and the final SSD state of the rank's heads)."""
    cfg = _cfg("mamba2-370m")
    params = _params(cfg)
    di = cfg.d_inner
    params["blocks"]["mamba"]["in_x"][..., di - di // m:] *= 1e3
    blocks = _blocks(cfg, m, params)
    h = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    p = M._layer(params["blocks"], 0)["mamba"]
    with torch.no_grad():
        want, (_, want_ssd) = M._apply_mamba(cfg, p, h, return_state=True)
    outs = TPM.ThreadRanks(cfg, m).run(lambda tp: M._apply_mamba(
        cfg, M._layer(blocks[tp.rank]["blocks"], 0)["mamba"], h,
        return_state=True, tp=tp))
    hs = cfg.ssm_heads // m
    for r, (got, (_, ssd)) in enumerate(outs):
        torch.testing.assert_close(got, want, **TOL)
        torch.testing.assert_close(ssd, want_ssd[:, r * hs:(r + 1) * hs],
                                   **TOL)


@pytest.mark.parametrize("arch,m", CASES)
def test_thread_ranks_forward_and_loss_equal_the_model(arch, m):
    cfg = _cfg(arch)
    params = _params(cfg)
    blocks = _blocks(cfg, m, params)
    batch = _batch(cfg)
    with torch.no_grad():
        want = M.forward_logits(cfg, params, batch)[0]
        want_loss, _ = M.loss_fn(cfg, params, batch)
    outs = TPM.ThreadRanks(cfg, m).run(lambda tp: (
        M.forward_logits(cfg, blocks[tp.rank], batch, tp=tp)[0],
        M.loss_fn(cfg, blocks[tp.rank], batch, tp=tp)[0]))
    for got, loss in outs:
        torch.testing.assert_close(got, want, **TOL)
        torch.testing.assert_close(loss, want_loss, **TOL)


def _greedy(run_prefill, run_decode, batch, steps=3, ctx=24):
    """The logits of prefill and ``steps`` decode steps, and the cache
    after each."""
    last, cache = run_prefill(batch, ctx)
    lgs, caches = [last], [tree_map(torch.clone, cache)]
    tok = last.argmax(-1)
    for i in range(steps):
        lg, cache = run_decode(cache, tok, S + i, ctx)
        lgs.append(lg)
        caches.append(tree_map(torch.clone, cache))
        tok = lg.argmax(-1)
    return lgs, caches


@pytest.mark.parametrize("arch,m", CASES)
def test_thread_ranks_prefill_and_decode_equal_the_model(arch, m):
    cfg = _cfg(arch)
    params = _params(cfg)
    blocks = _blocks(cfg, m, params)
    batch = _batch(cfg, seed=8)
    with torch.no_grad():
        want, _ = _greedy(lambda b, c: M.prefill(cfg, params, b, c),
                          lambda k, t, p, c: M.decode_step(cfg, params, k, t,
                                                           p, c), batch)
    outs = TPM.ThreadRanks(cfg, m).run(lambda tp: _greedy(
        lambda b, c: M.prefill(cfg, blocks[tp.rank], b, c, tp=tp),
        lambda k, t, p, c: M.decode_step(cfg, blocks[tp.rank], k, t, p, c,
                                         tp=tp), batch)[0])
    for got in outs:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)
            assert torch.equal(g.argmax(-1), w.argmax(-1))


@pytest.mark.parametrize("m", (2, 4))
def test_conv_state_is_the_rules_block_bitwise(m):
    cfg = _cfg("mamba2-370m", n_layers=1)
    params = _params(cfg)
    blocks = _blocks(cfg, m, params)
    batch = {"tokens": _batch(cfg, seed=9)["tokens"]}
    ctx = 24
    sh = tree_shardings(M.cache_specs(cfg, B, ctx), Mesh({"model": m}))
    with torch.no_grad():
        _, want = _greedy(lambda b, c: M.prefill(cfg, params, b, c),
                          lambda k, t, p, c: M.decode_step(cfg, params, k, t,
                                                           p, c), batch)
    outs = TPM.ThreadRanks(cfg, m).run(lambda tp: _greedy(
        lambda b, c: M.prefill(cfg, blocks[tp.rank], b, c, tp=tp),
        lambda k, t, p, c: M.decode_step(cfg, blocks[tp.rank], k, t, p, c,
                                         tp=tp), batch)[1])
    for r, caches in enumerate(outs):
        for step, (got, whole) in enumerate(zip(caches, want)):
            conv = sh["ssm"]["conv"].local(whole["ssm"]["conv"], rank=r)
            assert tuple(got["ssm"]["conv"].shape) == tuple(conv.shape)
            assert torch.equal(got["ssm"]["conv"], conv), (r, step)
            torch.testing.assert_close(
                got["ssm"]["ssd"],
                sh["ssm"]["ssd"].local(whole["ssm"]["ssd"], rank=r), **TOL)


def test_ragged_decode_on_a_model_axis_is_refused():
    """No longer refused: the ragged decode runs under a model-axis
    context, on rank 0's blocks of a traced (data 1, model 2) mesh (its
    collectives stand-ins), and returns whole-vocabulary logits."""
    from repro_torch.launch.mesh import TracedMesh

    cfg = _cfg("zamba2-7b")
    mesh = TracedMesh({"data": 1, "model": 2})
    params = tree_map(lambda p: p.float(), M.init_params(
        cfg, 0, "cpu", shardings=tree_shardings(M.param_specs(cfg), mesh)))
    cache = M.init_cache(cfg, 2, 8, "cpu", ragged=True,
                         shardings=tree_shardings(M.cache_specs(
                             cfg, 2, 8, ragged=True), mesh))
    with TS.activation_sharding(mesh), torch.no_grad():
        logits, _ = M.decode_step(cfg, params, cache,
                                  torch.zeros(2, dtype=torch.long),
                                  torch.tensor([3, 5], dtype=torch.int32), 8)
    assert logits.shape == (2, cfg.vocab)
    assert torch.isfinite(logits).all()
    assert cache["positions"].shape == (2, 4)


def _slot_backend(rank, world, out_dir, spec):
    import pickle

    from repro_torch.api import ServeBackend
    from repro_torch.launch.mesh import ProcessMesh

    mesh = ProcessMesh({"data": 1, "model": world})
    res = ServeBackend("cpu", mesh=mesh).run(spec)
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump({"x": res.x, "mesh": res.extra["mesh"],
                     "collectives": res.extra["collectives"]}, f)


def test_serve_backend_slot_lane_over_a_mesh_is_refused(tmp_path):
    """No longer refused: ``ServeBackend(mesh=)`` with ``n_slots`` serves
    on two gloo ranks at (data 1, model 2), each rank returning the token
    matrix of one process's slot lane, with the mesh and its
    collectives."""
    import pickle

    import torch_dp as D
    from repro_torch.api import ExperimentSpec, ServeBackend, ServeJob

    spec = ExperimentSpec(objective=ServeJob(
        arch="mamba2-370m", n_slots=2, n_requests=3,
        arch_overrides=(("dtype", "float32"),)), T=4)
    out = D.spawn(_slot_backend, 2, tmp_path, spec)
    want = ServeBackend("cpu").run(spec).x
    assert want.shape == (3, 4) and (want >= 0).all()
    for r in range(2):
        with open(f"{out}/rank{r}.pkl", "rb") as f:
            got = pickle.load(f)
        np.testing.assert_array_equal(got["x"], want)
        assert got["mesh"] == {"data": 1, "model": 2}
        assert got["collectives"]["all_reduce"][0] > 0


def test_profile_serve_slots_over_a_mesh_is_refused(monkeypatch):
    """No longer refused: ``profile_serve.main`` takes ``--slots`` with
    ``--mesh`` and hands the slot lane's run the bound mesh (the card's
    part, from ``init_process_group("cuda")`` on, stands in as a gloo
    world of one and a recorder of the parsed run)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as LM
    from repro_torch.launch import profile_serve

    seen = {}
    real = LM.init_process_group
    monkeypatch.setattr(LM, "init_process_group",
                        lambda device: (seen.setdefault("device", device),
                                        real("cpu")))
    monkeypatch.setattr(profile_serve, "_serve", lambda args, ap, mesh:
                        seen.update(args=args, mesh=mesh))
    profile_serve.main(["--arch", "mamba2-370m", "--slots", "8",
                        "--mesh", "data=1,model=1"])
    assert seen["device"] == "cuda"
    assert seen["args"].slots == 8
    assert isinstance(seen["mesh"], LM.ProcessMesh)
    assert seen["mesh"].shape == {"data": 1, "model": 1}
    assert not dist.is_initialized()
