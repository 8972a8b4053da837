"""The plain reference on the CPU at tiny sizes: against hand-built cases
(the SSD scan as its recurrence step by step, attention position by
position, a model whose blocks add nothing, one AsGrad run of Adam
worked out by hand), and against the program's own forward in float32,
so that a wrong reference is caught without the card."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from perfbench_tiny import TINY_RUN

from perfbench import weights
from perfbench.reference import asgrad, dense, hybrid
from perfbench.reference.common import (Arith, FP8Arith, attention_block,
                                        rms_norm, rope)


def _f32(run):
    return {**run, "dtype": "float32"}


def test_ssd_chunked_equals_the_recurrence():
    g = torch.Generator().manual_seed(0)
    b, S, H, P, N = 2, 24, 3, 4, 5
    x = torch.randn(b, S, H, P, generator=g)
    dt = torch.rand(b, S, H, generator=g) * 0.5
    A = -torch.rand(H, generator=g) * 2
    B, C = torch.randn(b, S, N, generator=g), torch.randn(b, S, N,
                                                          generator=g)
    h = torch.zeros(b, H, P, N)
    ys = []
    for t in range(S):
        h = torch.exp(dt[:, t] * A)[..., None, None] * h \
            + (dt[:, t, :, None] * x[:, t])[..., None] * B[:, t, None, None]
        ys.append(torch.einsum("bhpn,bn->bhp", h, C[:, t]))
    want = torch.stack(ys, 1)
    for chunk in (8, 6, 24, 5):          # 5 does not divide: halved to 1
        got = hybrid.ssd(x, dt, A, B, C, chunk)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_attention_position_by_position():
    g = torch.Generator().manual_seed(1)
    d, H, KV, Dh, S = 16, 4, 2, 4, 6
    p = {"norm": torch.rand(d, generator=g) + 0.5,
         "wq": torch.randn(d, H, Dh, generator=g),
         "wk": torch.randn(d, KV, Dh, generator=g),
         "wv": torch.randn(d, KV, Dh, generator=g),
         "wo": torch.randn(H, Dh, d, generator=g),
         "bq": torch.randn(H, Dh, generator=g),
         "bk": torch.randn(KV, Dh, generator=g),
         "bv": torch.randn(KV, Dh, generator=g)}
    h = torch.randn(1, S, d, generator=g)
    got = attention_block(Arith(), p, h, 1e-5, 1e4, True)
    x = rms_norm(h, p["norm"], 1e-5)[0]
    pos = torch.arange(S)
    q = rope((x @ p["wq"].reshape(d, -1)).reshape(1, S, H, Dh) + p["bq"],
             pos, 1e4)[0]
    k = rope((x @ p["wk"].reshape(d, -1)).reshape(1, S, KV, Dh) + p["bk"],
             pos, 1e4)[0]
    v = ((x @ p["wv"].reshape(d, -1)).reshape(S, KV, Dh) + p["bv"])
    out = torch.zeros(S, d)
    for i in range(S):
        for hh in range(H):
            kv = hh // (H // KV)
            w = torch.softmax(torch.stack([q[i, hh] @ k[j, kv]
                                           for j in range(i + 1)])
                              / math.sqrt(Dh), 0)
            o = sum(w[j] * v[j, kv] for j in range(i + 1))
            out[i] += o @ p["wo"][hh]
    torch.testing.assert_close(got[0], h[0] + out, rtol=1e-4, atol=1e-4)


def test_a_model_whose_blocks_add_nothing_is_its_embedding():
    r = _f32(TINY_RUN["qwen2-0.5b"])
    params = weights.make(r, 3, "cpu")
    for k in ("wo", "bq", "bk", "bv"):
        params["blocks"]["attn"][k].zero_()
    params["blocks"]["mlp"]["w_down"].zero_()
    tokens = torch.tensor([[1, 5, 7, 2]])
    e = params["embed"][tokens]
    x = rms_norm(e, params["final_norm"], r["norm_eps"])
    want = x @ params["embed"].T
    torch.testing.assert_close(dense.forward(Arith(), params, tokens, r),
                               want, rtol=1e-5, atol=1e-5)


def test_hybrid_blocks_that_add_nothing():
    r = _f32(TINY_RUN["zamba2-7b"])
    params = weights.make(r, 4, "cpu")
    params["blocks"]["mamba"]["out_proj"].zero_()
    params["tail"]["mamba"]["out_proj"].zero_()
    params["shared_attn"]["wo"].zero_()
    params["shared_mlp"]["w_down"].zero_()
    tokens = torch.tensor([[3, 9, 1, 4, 0, 2, 8, 5]])
    x = rms_norm(params["embed"][tokens], params["final_norm"], 1e-5)
    torch.testing.assert_close(hybrid.forward(Arith(), params, tokens, r),
                               x @ params["lm_head"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", ["qwen2-0.5b", "zamba2-7b"])
def test_reference_forward_equals_the_programs_in_f32(family):
    from repro_torch.configs import get_arch
    from repro_torch.models import model as M

    r = _f32(TINY_RUN[family])
    cfg = get_arch(family).with_(**r)
    params = weights.make(r, 5, "cpu")
    tokens = torch.randint(0, r["vocab"], (2, 32),
                           generator=torch.Generator().manual_seed(6))
    want, _ = M.forward_logits(cfg, params, {"tokens": tokens})
    ref = {"qwen2-0.5b": dense, "zamba2-7b": hybrid}[family]
    got = ref.forward(Arith(), params, tokens, r)
    torch.testing.assert_close(got, want.float(), rtol=2e-4, atol=2e-4)
    last = ref.forward(Arith(), params, tokens, r, last=3)
    torch.testing.assert_close(last, got[:, -3:])


def test_pure_masks_are_the_programs():
    from repro_torch.api import ExperimentSpec, TrainerBackend, TrainJob
    from repro_torch.core.engine import round_masks

    spec = ExperimentSpec(objective=TrainJob(), scheduler="pure",
                          timing="fixed:slow=5", n_workers=4, T=200)
    want = round_masks(TrainerBackend.world_for(spec, 4).schedule)
    np.testing.assert_array_equal(asgrad.pure_masks(4, 5.0, 200), want)


def test_delayed_adam_by_hand():
    """One parameter vector w of 2 logits, every round's loss the CE of
    label 1 at w = 0: g = softmax(0) − e₁ = (½, −½) each round.  Round 0
    buffers g and applies nothing; rounds 1 and 2 apply it with Adam at
    counts 2 and 3 (clip: ‖g‖ = 0.707 < 1)."""
    lr, b1, b2 = 0.01, 0.9, 0.95
    opt = {"lr": lr, "beta1": b1, "beta2": b2, "eps": 1e-8, "clip_norm": 1.0}

    def forward(ar, params, tokens, r):
        return torch.zeros(tokens.shape[0], 2, 2) + params["w"]

    batches = [torch.tensor([[0, 1]])] * 3
    masks = np.ones((3, 1), np.float32)
    p0 = {"w": torch.zeros(2)}
    out = asgrad.run_rounds(forward, Arith(), p0, batches, masks, {}, opt)
    assert out["grad0"]["w"] == pytest.approx(math.sqrt(0.5))
    # |step| at count c after c − 1 equal gradients of one sign
    m2, v2 = (1 - b1), (1 - b2)
    m3, v3 = b1 * m2 + (1 - b1), b2 * v2 + (1 - b2)
    s2 = (m2 / (1 - b1 ** 2)) / math.sqrt(v2 / (1 - b2 ** 2))
    s3 = (m3 / (1 - b1 ** 3)) / math.sqrt(v3 / (1 - b2 ** 3))
    a = lr * s2                         # round 2's w = (−a, a)
    assert out["losses"] == pytest.approx(
        [math.log(2), math.log(2), math.log(2 * math.cosh(a)) - a],
        rel=1e-5)
    assert out["change"]["w"] == pytest.approx(lr * (s2 + s3) * math.sqrt(2),
                                               rel=1e-5)
    one = asgrad.run_rounds(forward, Arith(), p0, batches[:1], masks, {},
                            opt)
    assert one["change"]["w"] == 0.0


def test_the_control_rounds_to_float8():
    x = torch.tensor([1.0, 0.3, -448.0, 1e-3])
    q = FP8Arith().q(x)
    assert q[2] == -448.0 and q[0] == 1.0
    assert (q - x).abs().max() > 0
    y = torch.randn(4, requires_grad=True)
    (FP8Arith().q(y) * torch.tensor([1.0, 0.3, 1e-3, 7.0])).sum().backward()
    torch.testing.assert_close(y.grad, FP8Arith().q(
        torch.tensor([1.0, 0.3, 1e-3, 7.0])))
    assert not torch.equal(y.grad, torch.tensor([1.0, 0.3, 1e-3, 7.0]))
    assert torch.equal(Arith().act(x), x)


def test_weights_are_the_seeds():
    r = TINY_RUN["zamba2-7b"]
    a, b = weights.make(r, 2**31 + 7, "cpu"), weights.make(r, 2**31 + 7,
                                                           "cpu")
    c = weights.make(r, 2**31 + 8, "cpu")
    for (p, x), (_, y), (_, z) in zip(weights.leaves(a), weights.leaves(b),
                                      weights.leaves(c)):
        assert torch.equal(x, y), p
        if x.numel() > 16 and p.rsplit("/", 1)[-1] not in ("norm", "D",
                                                           "gate_norm",
                                                           "final_norm"):
            assert not torch.equal(x, z), p
    assert a["blocks"]["mamba"]["A_log"].dtype == torch.float32
    assert F.softplus(a["blocks"]["mamba"]["dt_bias"]).max() <= 0.1 + 1e-6
