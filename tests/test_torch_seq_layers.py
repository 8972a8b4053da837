"""Sequence parallelism over the model axis in one process, with no
process group.

Under ``SEQ_PARALLEL_RULES`` each model rank holds its block of the
residual's rows between blocks wherever the sequence length S is a
multiple of the model axis (``distributed.sharding.residual_seq_split``,
JAX's ``_shard_act`` layout), and the whole sequence where it is not.
The ranks run as threads (``models.tp.ThreadRanks``) through the product
path's own ``TP`` layers, on the reduced configs of all six families in
f32 (zamba2-7b at five layers, the shared block every two: two groups and
a one-layer tail) and on reduced qwen2-0.5b with 6 query heads, which a
model axis of 4 does not divide (its attention leaves are gathered: q of
the rank's rows against k / v of the gathered sequence, at the rows'
offset).  At a model axis of 2 and 4: ``forward_logits``, ``loss_fn`` and
its gradients (``ThreadRanks.run(grad=True)``: the operators' backward
collectives run over the threads) equal the unsharded model's, each
rank's gradient the block of the whole one; ``prefill`` (logits and the
rank's cache blocks) and three ``decode_step`` calls equal it too, with
equal greedy tokens.  Tolerances are the tensor-parallel suites': 1e-5 on
values, 1e-5 relative L2 on each gradient leaf.

The plain flash version at ``q_offset`` equals the matching rows of the
whole-sequence reference (f32, 1e-6), and the cost model counts the pairs
those rows see.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch                       # noqa: E402
from repro_torch.distributed import sharding as TS             # noqa: E402
from repro_torch.distributed.sharding import (                 # noqa: E402
    DEFAULT_RULES, SEQ_PARALLEL_RULES, residual_seq_split, tree_shardings)
from repro_torch.kernels import flash_attention as FA          # noqa: E402
from repro_torch.kernels.ref import (attention_mask,           # noqa: E402
                                     reference_attention)
from repro_torch.launch import op_cost                         # noqa: E402
from repro_torch.launch.mesh import Mesh                       # noqa: E402
from repro_torch.models import model as M                      # noqa: E402
from repro_torch.models import tp as TPM                       # noqa: E402
from repro_torch.tree import tree_leaves_with_path, tree_map   # noqa: E402

ARCHS = {"qwen2-0.5b": ("qwen2-0.5b", {}),
         "qwen2-0.5b-h6": ("qwen2-0.5b", dict(n_heads=6)),
         "deepseek-moe-16b": ("deepseek-moe-16b", {}),
         "pixtral-12b": ("pixtral-12b", {}),
         "mamba2-370m": ("mamba2-370m", {}),
         "zamba2-7b": ("zamba2-7b", dict(n_layers=5, attn_every=2)),
         "seamless-m4t-large-v2": ("seamless-m4t-large-v2", {})}
CASES = [(a, m) for a in ARCHS for m in (2, 4)]
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-5
SR = SEQ_PARALLEL_RULES
B, S = 2, 16


def _cfg(name, **kw):
    arch, over = ARCHS[name]
    return get_arch(arch).reduced().with_(dtype="float32", remat="none",
                                          **{**over, **kw})


def _params(cfg):
    return tree_map(lambda p: p.float(), M.init_params(cfg, 0, "cpu"))


def _blocks(cfg, m, params):
    sh = tree_shardings(M.param_specs(cfg), Mesh({"model": m}), SR)
    return [tree_map(lambda t, s, r=r: s.local(t, rank=r), params, sh)
            for r in range(m)]


def _batch(cfg, seq=S, seed=7):
    rng = np.random.default_rng(seed)
    out = {}
    for k, sp in M.batch_specs(cfg, B, seq).items():
        out[k] = torch.from_numpy(
            rng.integers(0, cfg.vocab, sp.shape) if k == "tokens"
            else rng.standard_normal(sp.shape).astype(np.float32))
    return out


def _rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm()
                 / max(b.double().norm(), 1e-30))


def test_residual_seq_split_reads_the_rules():
    mesh = Mesh({"data": 2, "model": 4})
    assert residual_seq_split(mesh, SR, 16, 256)
    assert not residual_seq_split(mesh, SR, 14, 256)      # 14 % 4
    assert not residual_seq_split(mesh, SR, 2, 256)       # 2 < 4
    assert not residual_seq_split(mesh, SR, 1, 256)       # decode
    assert not residual_seq_split(mesh, DEFAULT_RULES, 16, 256)
    assert not residual_seq_split(Mesh({"data": 8, "model": 1}), SR, 16)
    embed_first = TS.Rules(model_priority=("act_embed", "seq"))
    assert not residual_seq_split(mesh, embed_first, 16, 256)
    tp = TPM.TP(_cfg("qwen2-0.5b"), None, 4, 3, SR)
    seq = tp.for_seq(16)
    assert (seq.seq, seq.rows, seq.lo) == (True, 4, 12)
    assert tp.for_seq(14) is tp and not tp.seq
    assert seq.for_seq(1).seq is False
    assert TPM.TP(_cfg("qwen2-0.5b"), None, 4, 3, None).for_seq(16).seq \
        is False


def _probe(monkeypatch):
    """Record the residual's shape after every block of every stack."""
    seen = []
    runner = M._runner

    def probe_runner(cfg):
        run = runner(cfg)

        def rec(fn, *args):
            out = run(fn, *args)
            h = out[0] if isinstance(out, tuple) else out
            seen.append(tuple(h.shape))
            return out
        return rec
    monkeypatch.setattr(M, "_runner", probe_runner)
    return seen


def _leaves(tree):
    return [t for _, t in tree_leaves_with_path(tree)]


@pytest.mark.parametrize("arch,m", CASES)
def test_forward_loss_and_grads_equal_the_model(arch, m, monkeypatch):
    cfg = _cfg(arch)
    params = _params(cfg)
    batch = _batch(cfg)
    with torch.no_grad():
        want = M.forward_logits(cfg, params, batch)[0]
    whole = tree_map(lambda t: t.clone().requires_grad_(), params)
    loss = M.loss_fn(cfg, whole, batch)[0]
    gwant = torch.autograd.grad(loss, _leaves(whole), allow_unused=True)
    blocks = [tree_map(lambda t: t.clone().requires_grad_(), b)
              for b in _blocks(cfg, m, params)]
    seen = _probe(monkeypatch)

    def rank(tp):
        b = blocks[tp.rank]
        logits = M.forward_logits(cfg, b, batch, tp=tp)[0]
        lo = M.loss_fn(cfg, b, batch, tp=tp)[0]
        g = torch.autograd.grad(lo, _leaves(b), allow_unused=True)
        return logits.detach(), lo.detach(), g

    outs = TPM.ThreadRanks(cfg, m, SR).run(rank, grad=True)
    # between blocks every rank held its S/M rows (the audio encoder's
    # frames and decoder tokens both divide here)
    rows = {sh[1] for sh in seen}
    assert seen and all(len(sh) == 3 for sh in seen)
    seqs = {S // m} | ({M.batch_specs(cfg, B, S)["tokens"].shape[1] // m}
                       if cfg.family == "audio" else set())
    assert rows == seqs, (rows, seqs)
    sh = tree_shardings(M.param_specs(cfg), Mesh({"model": m}), SR)
    for r, (logits, lo, grads) in enumerate(outs):
        torch.testing.assert_close(logits, want, **TOL)
        torch.testing.assert_close(lo, loss.detach(), **TOL)
        for (path, leaf), g, gw, s in zip(tree_leaves_with_path(params),
                                          grads, gwant, _leaves(sh)):
            w = s.local(torch.zeros_like(leaf) if gw is None else gw,
                        rank=r)
            got = torch.zeros_like(w) if g is None else g
            assert _rel_l2(got, w) <= GRAD_TOL or \
                (got - w).abs().max() <= 1e-7, (r, path)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-0.5b-h6",
                                  "deepseek-moe-16b", "pixtral-12b"])
def test_residual_stays_whole_where_the_axis_does_not_divide(arch,
                                                             monkeypatch):
    """14 rows at model 4: every rank holds the whole sequence, as JAX's
    layout keeps it, and the numbers are the unsharded model's."""
    cfg, m, seq = _cfg(arch), 4, 14
    params = _params(cfg)
    batch = _batch(cfg, seq)
    with torch.no_grad():
        want = M.forward_logits(cfg, params, batch)[0]
    blocks = _blocks(cfg, m, params)
    seen = _probe(monkeypatch)
    outs = TPM.ThreadRanks(cfg, m, SR).run(lambda tp: M.forward_logits(
        cfg, blocks[tp.rank], batch, tp=tp)[0])
    assert seen and {sh[1] for sh in seen} == {seq}
    for got in outs:
        torch.testing.assert_close(got, want, **TOL)


def _greedy(run_prefill, run_decode, batch, steps=3, ctx=24):
    """The logits of prefill and ``steps`` decode steps, and the cache
    after prefill."""
    last, cache = run_prefill(batch, ctx)
    lgs, first = [last], tree_map(torch.clone, cache)
    tok = last.argmax(-1)
    for i in range(steps):
        lg, cache = run_decode(cache, tok, S + i, ctx)
        lgs.append(lg)
        tok = lg.argmax(-1)
    return lgs, first


@pytest.mark.parametrize("arch,m", CASES)
def test_prefill_and_decode_equal_the_model(arch, m, monkeypatch):
    cfg = _cfg(arch)
    params = _params(cfg)
    blocks = _blocks(cfg, m, params)
    batch = _batch(cfg, seed=8)
    ctx = 24
    with torch.no_grad():
        want, wcache = _greedy(
            lambda b, c: M.prefill(cfg, params, b, c),
            lambda k, t, p, c: M.decode_step(cfg, params, k, t, p, c), batch)
    flash_rows = []
    plain = FA.flash_attention_plain

    def spy(q, k, v, **kw):
        flash_rows.append((q.shape[1], k.shape[1], kw.get("q_offset", 0)))
        return plain(q, k, v, **kw)
    if cfg.n_heads and cfg.family != "ssm":
        cfg = cfg.with_(use_flash_attention=True)
        monkeypatch.setattr(FA, "flash_attention_plain", spy)
    outs = TPM.ThreadRanks(cfg, m, SR).run(lambda tp: _greedy(
        lambda b, c: M.prefill(cfg, blocks[tp.rank], b, c, tp=tp),
        lambda k, t, p, c: M.decode_step(cfg, blocks[tp.rank], k, t, p, c,
                                         tp=tp), batch))
    sh = tree_shardings(M.cache_specs(cfg, B, ctx), Mesh({"model": m}), SR)
    for r, (got, cache) in enumerate(outs):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)
            assert torch.equal(g.argmax(-1), w.argmax(-1))
        for (path, c), (_, wc), s in zip(tree_leaves_with_path(cache),
                                         tree_leaves_with_path(wcache),
                                         _leaves(sh)):
            torch.testing.assert_close(c, s.local(wc, rank=r), **TOL,
                                       msg=f"rank {r} {path}")
    if flash_rows and cfg.family != "audio":
        # the decoder's self-attention: the rank's rows against every key
        heads = TPM.TP(cfg, None, m, 0, SR).heads_split()
        selfs = [x for x in flash_rows if x[1] == S]
        want_rows = {(S, S, 0)} if heads else \
            {(S // m, S, r * S // m) for r in range(m)}
        assert set(selfs) == want_rows


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
@pytest.mark.parametrize("kv", [1, 2])
def test_plain_flash_at_q_offset_equals_the_rows_of_the_whole(causal,
                                                              window, kv):
    rng = np.random.default_rng(3)
    Bq, Sk, H, D = 2, 24, 4, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((Bq, Sk, H, D), (Bq, Sk, kv, D), (Bq, Sk, kv, D)))
    whole = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    for lo, n in ((0, 8), (8, 8), (16, 8), (6, 12)):
        got = FA.flash_attention_plain(q[:, lo:lo + n], k, v, causal=causal,
                                       window=window, q_offset=lo)
        torch.testing.assert_close(got, whole[:, lo:lo + n], rtol=1e-6,
                                   atol=1e-6)
        ref = reference_attention(q[:, lo:lo + n], k, v, causal=causal,
                                  window=window, q_offset=lo)
        full = reference_attention(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(ref, full[:, lo:lo + n], rtol=1e-6,
                                   atol=1e-6)
        mask = attention_mask(n, Sk, causal, window, q_offset=lo)
        assert torch.equal(mask, attention_mask(Sk, Sk, causal,
                                                window)[lo:lo + n])
        assert op_cost.visible_pairs(n, Sk, causal, window, lo) == \
            int(mask.sum())
        flops, _ = op_cost.flash_cost(q[:, lo:lo + n], k, causal, window,
                                      lo)
        assert flops == 4 * D * int(mask.sum()) * Bq * H


def test_flash_rows_past_every_key_and_the_kernel_cost_of_the_ranks():
    """Causal rows at an offset see every key up to their own position, so
    the ranks' blocks together cost what the whole causal call costs."""
    Sq, m, D, H = 32, 4, 16, 2
    q = torch.zeros(1, Sq, H, D)
    whole = op_cost.flash_cost(q, q, True, None)[0]
    n = Sq // m
    parts = [op_cost.flash_cost(q[:, :n], q, True, None, r * n)[0]
             for r in range(m)]
    assert sum(parts) == whole
    assert parts == sorted(parts)          # the last rank's rows see most
    assert parts[0] == 4 * D * H * n * (n + 1) // 2
    assert math.isclose(parts[-1] / whole, (2 * m - 1) / m ** 2, rel_tol=0.1)


def test_dryrun_rank_of_32x8_traces_its_block_of_the_queries(monkeypatch):
    """``dryrun --arch qwen2-0.5b --shape prefill_32k --both-meshes
    --auto-rules`` at one layer: rank 0 of ``32x8`` attends with 4096 of
    the 32768 query rows (its 14 heads do not divide the model axis of 8,
    so ``auto_rules`` picks the sequence-parallel rules), against every
    row under the default rules, with fewer dot flops and a lower
    estimated peak; its collectives gather and reduce-scatter the rows."""
    from repro_torch.launch import dryrun

    calls = []
    attn = TPM.attn_local

    def spy(cfg, p, x, rank, **kw):
        kv = kw.get("kv_x")
        calls.append((x.shape[1], None if kv is None else kv.shape[1],
                      kw.get("q_offset", 0)))
        return attn(cfg, p, x, rank, **kw)

    monkeypatch.setattr(TPM, "attn_local", spy)
    cfg = get_arch("qwen2-0.5b").with_(n_layers=1)
    recs = {}
    for auto in (True, False):
        calls.clear()
        recs[auto] = dryrun.run_one(cfg, "prefill_32k", auto=auto,
                                    mesh="32x8", verbose=False)
        assert recs[auto]["ok"], recs[auto].get("error")
        assert calls == ([(4096, 32768, 0)] if auto else [(32768, None, 0)])
    seq, base = (recs[a]["op_cost"] for a in (True, False))
    assert seq["dot_flops"] < base["dot_flops"]
    assert recs[True]["memory"]["peak_bytes_est"] < \
        recs[False]["memory"]["peak_bytes_est"]
    assert set(seq["collective_breakdown"]) == {"all-gather",
                                                "reduce-scatter"}
    assert "all-reduce" in base["collective_breakdown"]
