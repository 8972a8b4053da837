"""The ragged decode (the slot lane's step) tensor-parallel, in one process.

Each rank's part runs through the product path's own ``TP`` layers, the
ranks as threads (``models.tp.ThreadRanks``), on reduced qwen2-0.5b,
mamba2-370m, zamba2-7b (five layers, the shared block every two: two
groups and a one-layer tail) and deepseek-moe-16b in f32, params from the
port's initialiser cast to f32, prompts from numpy seeds.  A ragged cache
of four slots is filled the slot lane's way: one batch-1 prefill per slot,
of 5, 9, 12 and 7 tokens, written into its row, so the rows decode at
different positions.  Each rank takes its block of that cache under the
rules (``cache_specs(..., ragged=True)``: the (S, W) positions on
``("batch", "ctx")``), then three ragged ``decode_step`` calls run on the
ranks and on the whole model.  At a model axis of 2 and 4 the logits of
every step are within 1e-5 relative L2 of the unsharded model's, the
greedy tokens are equal, and each rank's positions buffer is its block of
the unsharded one, bit for bit.

qwen2-0.5b's two kv heads do not divide a model axis of 4, so its ring is
split on ``ctx`` there: each row writes its k/v and position through a
mask where the rank holds its slot.  The same config with a sliding
window of 8 (``W`` 8 < the rows' positions) decodes through a wrapped
ring at both model axes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch                       # noqa: E402
from repro_torch.distributed.sharding import tree_shardings    # noqa: E402
from repro_torch.launch.mesh import Mesh                       # noqa: E402
from repro_torch.models import model as M                      # noqa: E402
from repro_torch.models import tp as TPM                       # noqa: E402
from repro_torch.tree import tree_map                          # noqa: E402
from torch_parity import rel_l2                                # noqa: E402

ARCHS = {"dense": ("qwen2-0.5b", {}),
         "dense_window": ("qwen2-0.5b", dict(sliding_window=8)),
         "ssm": ("mamba2-370m", {}),
         "hybrid": ("zamba2-7b", dict(n_layers=5, attn_every=2)),
         "moe": ("deepseek-moe-16b", {})}
CASES = [(n, m) for n in ARCHS for m in (2, 4)]
PLENS = (5, 9, 12, 7)
CTX, STEPS = 24, 3


def _cfg(name):
    arch, over = ARCHS[name]
    return get_arch(arch).reduced().with_(dtype="float32", remat="none",
                                          **over)


def _filled(cfg, params):
    """The whole ragged cache of ``len(PLENS)`` slots, each row a batch-1
    prefill of its prompt, and the (tokens, positions) to decode from."""
    S = len(PLENS)
    cache = M.init_cache(cfg, S, CTX, "cpu", ragged=True)
    rng = np.random.default_rng(11)
    toks = []
    for s, plen in enumerate(PLENS):
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, plen)))
        last, row = M.prefill(cfg, params, {"tokens": prompt}, ctx_len=CTX)

        def write(c, p, s=s):
            if c.dim() == p.dim() + 1:            # the (S, W) positions row
                c[s].copy_(p)
            else:
                c[:, s].copy_(p[:, 0])
        tree_map(write, cache, row)
        toks.append(last.argmax(-1))
    return cache, torch.cat(toks), torch.tensor(PLENS, dtype=torch.int32)


def _steps(decode, cache, toks, pos):
    """``STEPS`` ragged decode steps → (logits per step, the cache)."""
    lgs = []
    for _ in range(STEPS):
        lg, cache = decode(cache, toks, pos)
        lgs.append(lg)
        toks = lg.argmax(-1)
        pos = pos + 1
    return lgs, cache


@pytest.mark.parametrize("name,m", CASES)
def test_ragged_decode_on_thread_ranks_equals_the_model(name, m):
    cfg = _cfg(name)
    params = tree_map(lambda p: p.float(), M.init_params(cfg, 0, "cpu"))
    mesh = Mesh({"model": m})
    psh = tree_shardings(M.param_specs(cfg), mesh)
    blocks = [tree_map(lambda t, s, r=r: s.local(t, rank=r), params, psh)
              for r in range(m)]
    with torch.no_grad():
        cache, toks, pos = _filled(cfg, params)
    csh = tree_shardings(M.cache_specs(cfg, len(PLENS), CTX, ragged=True),
                         mesh)
    ranks = [tree_map(lambda t, s, r=r: s.local(t, rank=r).clone(), cache,
                      csh) for r in range(m)]
    if name == "dense" and m == 4:
        # two kv heads on four ranks: the ring and the positions on ctx
        assert TPM.cache_split(cfg, m, len(PLENS), CTX)["ring"] == 1
        assert ranks[0]["positions"].shape == (len(PLENS), CTX // m)
    with torch.no_grad():
        want, whole = _steps(lambda c, t, p: M.decode_step(
            cfg, params, c, t, p, CTX), tree_map(torch.clone, cache), toks,
            pos)
    outs = TPM.ThreadRanks(cfg, m).run(lambda tp: _steps(
        lambda c, t, p: M.decode_step(cfg, blocks[tp.rank], c, t, p, CTX,
                                      tp=tp), ranks[tp.rank], toks, pos))
    for r, (got, rank_cache) in enumerate(outs):
        for step, (g, w) in enumerate(zip(got, want)):
            assert rel_l2(g.numpy(), w.numpy()) <= 1e-5, (r, step)
            assert torch.equal(g.argmax(-1), w.argmax(-1)), (r, step)
        if "positions" in whole:
            assert torch.equal(rank_cache["positions"], csh["positions"].local(
                whole["positions"], rank=r)), r
