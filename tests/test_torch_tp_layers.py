"""Tensor parallelism's rank-local parts in one process, with no process group.

For a model axis of M in {2, 4}, every rank's part of a layer (the
rank-local functions of ``models/tp.py`` and the layers' functions on the
rank's blocks) runs in turn, and the parts are combined as the
collectives would combine them: a sum where the layer all-reduces, a max
where it takes one, a concatenation where it gathers.  The result equals
the unsharded layer in f32 within 1e-5 for attention, the MLP, the MoE
(its aux too), the embedding, the vocab-parallel cross entropy and the
decode attention over a cache split on ``ctx``.  Every leaf's block has
the shape that ``logical_pspec`` gives, and a rank's params drawn with
shardings are the blocks of the whole draw, bit for bit.

Sizes: reduced qwen2-0.5b (4 heads, 2 kv heads, ff 512, vocab 512: at
M 4 ``wk`` / ``wv`` fall to ``embed`` and the cache to ``ctx``) and
deepseek-moe-16b (4 experts, top 2, one shared expert, 2 MHA heads: at
M 4 its attention falls to ``embed``), params from the port's
initialiser cast to f32 (the JAX initialiser's params meet the port in
``tests/test_torch_tp_jax.py``), inputs from numpy seeds.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch                       # noqa: E402
from repro_torch.distributed.sharding import (                 # noqa: E402
    NamedSharding, logical_pspec, tree_shardings)
from repro_torch.launch.mesh import Mesh                       # noqa: E402
from repro_torch.models import layers as L                     # noqa: E402
from repro_torch.models import model as M                      # noqa: E402
from repro_torch.models import tp as TPM                       # noqa: E402
from repro_torch.tree import (tree_leaves_with_path,           # noqa: E402
                              tree_map)

ARCHS = ("qwen2-0.5b", "deepseek-moe-16b")
SIZES = (2, 4)
CASES = [(a, m) for a in ARCHS for m in SIZES]
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(arch):
    return get_arch(arch).reduced().with_(dtype="float32", remat="none")


def _params(cfg):
    return tree_map(lambda p: p.float(), M.init_params(cfg, 0, "cpu"))


def _shardings(cfg, m):
    return tree_shardings(M.param_specs(cfg), Mesh({"model": m}))


def _block(t, sh, r):
    return sh.local(t, rank=r)


def _x(cfg, seed=0, B=2, S=8):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))


def combine(fn, m: int, passes: int = 4):
    """``fn(rank, amax, total)`` for every rank in turn, where ``amax`` and
    ``total`` stand for the all-reduces (max and sum): each call returns
    the combination over the ranks of that call's inputs.  A call's
    inputs can depend on earlier calls' results, so the ranks run again
    until every call has seen its final value."""
    combined: dict = {}
    for _ in range(passes):
        seen = [[] for _ in range(m)]
        outs = []
        for r in range(m):
            count = itertools.count()

            def coll(kind, r=r, count=count):
                def f(t):
                    i = next(count)
                    seen[r].append((kind, t))
                    return combined.get(i, t)
                return f
            outs.append(fn(r, coll("max"), coll("sum")))
        for i, (kind, _) in enumerate(seen[0]):
            ts = torch.stack([seen[r][i][1] for r in range(m)])
            combined[i] = ts.amax(0) if kind == "max" else ts.sum(0)
    return outs


@pytest.mark.parametrize("arch,m", CASES)
def test_blocks_have_the_rules_shapes_and_the_whole_draws_values(arch, m):
    cfg = _cfg(arch)
    full = M.init_params(cfg, 0, "cpu")
    mesh = Mesh({"model": m})
    sh = tree_shardings(M.param_specs(cfg), mesh)
    specs = dict(tree_leaves_with_path(M.param_specs(cfg)))
    for r in range(m):
        mesh.coords = mesh.coords_of(r)
        blocks = dict(tree_leaves_with_path(M.init_params(
            cfg, 0, "cpu", shardings=sh)))
        for path, t in tree_leaves_with_path(full):
            s = specs[path]
            want = NamedSharding(mesh, logical_pspec(s.axes, s.shape, mesh))
            assert tuple(blocks[path].shape) == want.shard_shape(s.shape)
            assert torch.equal(blocks[path], want.local(t, rank=r)), path
            assert blocks[path].is_contiguous()


def test_the_plans_reach_every_kind_of_split():
    """What the reduced configs exercise: Megatron splits at M 2; at M 4
    qwen2's k/v projections fall to ``embed`` and its cache to ``ctx``,
    and the MoE's attention falls to ``embed``."""
    q2, q4 = TPM.plan(_cfg("qwen2-0.5b"), 2), TPM.plan(_cfg("qwen2-0.5b"), 4)
    assert (q2["attn"]["wq"], q2["attn"]["wk"], q2["attn"]["wo"]) == (1, 1, 0)
    assert (q4["attn"]["wq"], q4["attn"]["wk"], q4["attn"]["bk"]) == \
        (1, 0, None)
    assert q2["mlp"]["w_gate"] == 1 and q2["mlp"]["norm"] == 0
    assert q2["embed"] == 0 and q2["final_norm"] == 0
    assert TPM.cache_split(_cfg("qwen2-0.5b"), 2, 4, 32)["ring"] == 2
    assert TPM.cache_split(_cfg("qwen2-0.5b"), 4, 4, 32) == \
        {"ring": 1, "positions": 0}
    m4 = TPM.plan(_cfg("deepseek-moe-16b"), 4)
    assert m4["moe"]["w_gate"] == 0 and m4["moe"]["router"] == 1
    assert m4["attn"]["wq"] == 0 and m4["moe"]["shared"]["w_gate"] == 1
    assert m4["lm_head"] == 1


def _attn_leaves(cfg, m, p, sh, r):
    pl = TPM.plan(cfg, m)["attn"]
    heads = pl["wq"] == TPM.ATTN_MEGATRON["wq"]
    return {n: _block(t, sh[n], r) if heads and pl[n] is not None
            and pl[n] == TPM.ATTN_MEGATRON.get(n) else t
            for n, t in p.items() if n != "norm"}, heads


@pytest.mark.parametrize("arch,m", CASES)
def test_attention_parts_sum_to_the_layer(arch, m):
    cfg = _cfg(arch)
    params = _params(cfg)
    p = M._layer(params["blocks"], 0)["attn"]
    psh = _shardings(cfg, m)["blocks"]["attn"]
    psh = {n: NamedSharding(s.mesh, type(s.spec)(*s.spec[1:]))
           for n, s in psh.items()}                     # the layer's dims
    h = _x(cfg)
    pos = torch.arange(h.shape[1])
    want, (wk, _) = M._apply_attn(cfg, p, h, positions=pos, return_kv=True)
    x = L.rms_norm(h, p["norm"], cfg.norm_eps)
    outs, ks = [], []
    for r in range(m):
        lp, heads = _attn_leaves(cfg, m, p, psh, r)
        o, k, _ = TPM.attn_local(cfg, lp, x, r, positions=pos)
        outs.append(o)
        ks.append(k)
    got = h + (sum(outs[1:], outs[0]) if heads else outs[0])
    torch.testing.assert_close(got, want, **TOL)
    k_all = torch.cat(ks, 2) if ks[0].shape[2] < wk.shape[2] else ks[0]
    torch.testing.assert_close(k_all, wk, **TOL)


def test_kv_heads_for_query_heads_that_straddle_groups():
    """Query heads per rank that neither divide nor are divided by the GQA
    group (6 heads on 2 kv heads over 3 ranks): one kv head per query head."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 5, 6, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 5, 2, 16), np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 5, 2, 16), np.float32))
    want = L.attention(q, k, v)
    for r in range(3):
        ks = TPM.kv_for_heads(k, 6, 2, 2, r)
        vs = TPM.kv_for_heads(v, 6, 2, 2, r)
        torch.testing.assert_close(
            L.attention(q[:, :, 2 * r:2 * r + 2], ks, vs),
            want[:, :, 2 * r:2 * r + 2], **TOL)


@pytest.mark.parametrize("m", SIZES)
def test_mlp_parts_sum_to_the_layer(m):
    cfg = _cfg("qwen2-0.5b")
    params = _params(cfg)
    p = M._layer(params["blocks"], 1)["mlp"]
    x = _x(cfg, 1)
    want = L.swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
    ff = cfg.d_ff // m
    parts = [L.swiglu(x, p["w_gate"][:, r * ff:(r + 1) * ff],
                      p["w_up"][:, r * ff:(r + 1) * ff],
                      p["w_down"][r * ff:(r + 1) * ff]) for r in range(m)]
    assert TPM.plan(cfg, m)["mlp"]["w_down"] == 0
    torch.testing.assert_close(sum(parts[1:], parts[0]), want, **TOL)


@pytest.mark.parametrize("m", SIZES)
def test_moe_parts_sum_to_the_layer(m):
    """Each rank routes every token over all the experts, runs its E/M
    experts and its columns of the shared expert; the parts sum to the
    layer, and every rank's aux is the layer's."""
    cfg = _cfg("deepseek-moe-16b")
    params = _params(cfg)
    p = M._layer(params["blocks"], 0)["moe"]
    h = _x(cfg, 2, B=2, S=6)
    want, want_aux = M._apply_moe(cfg, p, h)
    x = L.rms_norm(h, p["norm"], cfg.norm_eps)
    el, sp = cfg.n_experts // m, p["shared"]
    fs = sp["w_gate"].shape[1] // m
    parts = []
    for r in range(m):
        e = slice(r * el, (r + 1) * el)
        y, aux = L.moe_ffn(x, p["router"], p["w_gate"][e], p["w_up"][e],
                           p["w_down"][e], cfg.top_k, cfg.capacity_factor,
                           first_expert=r * el)
        torch.testing.assert_close(aux, want_aux, rtol=0, atol=0)
        c = slice(r * fs, (r + 1) * fs)
        parts.append(y + L.swiglu(x, sp["w_gate"][:, c], sp["w_up"][:, c],
                                  sp["w_down"][c]))
    torch.testing.assert_close(h + sum(parts[1:], parts[0]), want, **TOL)


@pytest.mark.parametrize("m", SIZES)
def test_embedding_parts_sum_to_the_lookup(m):
    cfg = _cfg("qwen2-0.5b")
    table = _params(cfg)["embed"]
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (3, 7)))
    n = cfg.vocab // m
    parts = [TPM.embed_local(table[r * n:(r + 1) * n], tokens, r)
             for r in range(m)]
    assert torch.equal(sum(parts[1:], parts[0]), table[tokens])


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("masked", [False, True])
def test_vocab_parallel_xent_equals_the_cross_entropy(m, masked):
    rng = np.random.default_rng(5)
    V = 64
    lg = torch.from_numpy(3 * rng.standard_normal((2, 9, V), np.float32))
    labels = torch.from_numpy(rng.integers(0, V, (2, 9)))
    mask = torch.from_numpy((rng.random((2, 9)) > 0.3).astype(np.float32)) \
        if masked else None
    want = L.softmax_xent(lg, labels, mask)
    n = V // m
    outs = combine(lambda r, amax, total: L.vocab_parallel_xent(
        lg[..., r * n:(r + 1) * n], labels, mask, first=r * n, amax=amax,
        total=total), m)
    for got in outs:
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("window", [None, 5])
def test_decode_over_a_ctx_split_cache(m, window):
    """The distributed softmax over each rank's block of the ring's slots
    (two of them empty) equals the decode attention over the whole ring."""
    rng = np.random.default_rng(6)
    W, H, KV, D = 8, 4, 2, 16
    q = torch.from_numpy(rng.standard_normal((2, 1, H, D), np.float32))
    kc = torch.from_numpy(rng.standard_normal((2, W, KV, D), np.float32))
    vc = torch.from_numpy(rng.standard_normal((2, W, KV, D), np.float32))
    cpos = torch.tensor([8, 9, 10, 3, 4, 5, -1, -1], dtype=torch.int32)
    want = L.decode_attention(q, kc, vc, cpos, 10, window=window)
    n = W // m
    outs = combine(lambda r, amax, total: L.decode_attention_ctx(
        q, kc[:, r * n:(r + 1) * n], vc[:, r * n:(r + 1) * n],
        cpos[r * n:(r + 1) * n], 10, window, amax, total), m)
    for got in outs:
        torch.testing.assert_close(got, want, **TOL)


# ---------------------------------------------------------------------------
# the product path's layers on ranks run as threads (models.tp.ThreadRanks)
# ---------------------------------------------------------------------------

def _rank_blocks(cfg, m, params):
    sh = _shardings(cfg, m)
    return [tree_map(lambda t, s, r=r: s.local(t, rank=r), params, sh)
            for r in range(m)]


@pytest.mark.parametrize("arch,m", CASES)
def test_thread_ranks_forward_and_loss_equal_the_model(arch, m):
    """``forward_logits`` and ``loss_fn`` on each rank's blocks through
    ``TP``'s own layers (the threads' operators standing for the
    collectives) give the unsharded model's logits, aux and loss on every
    rank."""
    cfg = _cfg(arch)
    params = _params(cfg)
    blocks = _rank_blocks(cfg, m, params)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (2, 9)))
    batch = {"tokens": tokens}
    with torch.no_grad():
        want, want_aux = M.forward_logits(cfg, params, batch)
        want_loss, _ = M.loss_fn(cfg, params, batch)
    outs = TPM.ThreadRanks(cfg, m).run(lambda tp: (
        M.forward_logits(cfg, blocks[tp.rank], batch, tp=tp),
        M.loss_fn(cfg, blocks[tp.rank], batch, tp=tp)[0]))
    for (got, aux), loss in outs:
        torch.testing.assert_close(got, want, **TOL)
        torch.testing.assert_close(torch.as_tensor(aux),
                                   torch.as_tensor(want_aux), **TOL)
        torch.testing.assert_close(loss, want_loss, **TOL)


@pytest.mark.parametrize("arch,m", CASES)
def test_thread_ranks_prefill_and_decode_equal_the_model(arch, m):
    """``prefill`` then ``decode_step`` on each rank's blocks of the params
    and of the cache (qwen2 at M 4: the ring split on ``ctx``) give the
    unsharded model's logits at every step, and its greedy tokens."""
    cfg = _cfg(arch)
    params = _params(cfg)
    blocks = _rank_blocks(cfg, m, params)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (2, 6)))
    S, T, ctx = tokens.shape[1], 4, 12

    def greedy(run_prefill, run_decode):
        last, cache = run_prefill({"tokens": tokens}, ctx)
        lgs, tok = [last], last.argmax(-1)
        for i in range(T):
            lg, cache = run_decode(cache, tok, S + i, ctx)
            lgs.append(lg)
            tok = lg.argmax(-1)
        return lgs

    with torch.no_grad():
        want = greedy(lambda b, c: M.prefill(cfg, params, b, c),
                      lambda k, t, p, c: M.decode_step(cfg, params, k, t, p,
                                                       c))
    outs = TPM.ThreadRanks(cfg, m).run(lambda tp: greedy(
        lambda b, c: M.prefill(cfg, blocks[tp.rank], b, c, tp=tp),
        lambda k, t, p, c: M.decode_step(cfg, blocks[tp.rank], k, t, p, c,
                                         tp=tp)))
    for got in outs:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)
            assert torch.equal(g.argmax(-1), w.argmax(-1))


def test_thread_ranks_raise_what_a_rank_raises():
    """An error on one rank stops the others at their next collective and
    is raised."""
    cfg = _cfg("qwen2-0.5b")

    def fn(tp):
        if tp.rank == 1:
            raise ValueError("rank 1")
        return tp.reduce(torch.ones(2))

    with pytest.raises(ValueError, match="rank 1"):
        TPM.ThreadRanks(cfg, 2, timeout=30).run(fn)
