"""The frozen cost formulas against hand counts."""
from __future__ import annotations

import json
import os

import pytest

from perfbench_tiny import BENCH

from perfbench.costs import flops, kernels, peaks


def _run(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)["run"]


def test_qwen2_round_is_12_41_tflop():
    """8 × 512 tokens: 2 × 493.96 M matrix parameters + causal attention
    (4·64·14·24 a visible pair, 131,328 pairs a sequence), × 3."""
    r = _run("qwen2-0.5b")
    matrices = 24 * (896 * 896 + 2 * 896 * 128 + 896 * 896
                     + 3 * 896 * 4864) + 896 * 151936
    assert matrices == 493_961_216
    hand = 3 * 8 * (512 * 2 * matrices + 4 * 64 * 14 * 24 * 131_328)
    assert flops.train_round(r, 8, 512) == hand
    assert flops.train_round(r, 8, 512) == pytest.approx(12.41e12, rel=2e-3)


def test_zamba2_matrix_parameters_count_13_insertions():
    r = _run("zamba2-7b")
    mamba = 2 * 3584 * 7168 + 2 * 3584 * 64 + 3584 * 112 + 7168 * 3584
    shared = 4 * 3584 * 3584 + 3 * 3584 * 14336
    assert flops._matmul_params(r) == 81 * mamba + 13 * shared
    total = flops._matmul_params(r) + 3584 * 32000
    assert total == pytest.approx(9.1e9, rel=2e-3)


@pytest.mark.parametrize("shape, ms, by", [
    ((4, 1024, 1024, 14, 2, 64), 0.0076, "ops"),     # qwen2 prefill
    ((4, 1024, 1024, 32, 32, 112), 0.0351, "bytes"),  # zamba2 prefill
    ((1, 512, 512, 14, 2, 64), 0.0006, "bytes"),     # qwen2 admission
    ((1, 512, 512, 16, 16, 112), 0.0022, "bytes"),   # zamba2 admission, model 2
])
def test_flash_bounds_match_the_kernel_table(shape, ms, by):
    f, b = kernels.flash_cost(*shape)
    assert peaks.bound_s(f, b) * 1e3 == pytest.approx(ms, abs=6e-5)
    ops_bound = f / peaks.BF16_FLOPS >= b / peaks.HBM_BYTES_PER_S
    assert ops_bound == (by == "ops")


@pytest.mark.parametrize("shape, ms", [
    ((4, 8, 128, 32, 64, 128), 0.0208),    # mamba2-370m prefill
    ((4, 8, 128, 112, 64, 64), 0.0534),    # zamba2-7b prefill
    ((1, 4, 128, 32, 64, 128), 0.0026),    # mamba2-370m admission
    ((1, 4, 128, 56, 64, 64), 0.0034),     # zamba2-7b admission, model 2
])
def test_ssd_bounds_match_the_kernel_table(shape, ms):
    f, b = kernels.ssd_cost(*shape)
    assert peaks.bound_s(f, b) * 1e3 == pytest.approx(ms, abs=6e-5)


def test_pooled_update_bound_is_3_83_ms():
    """494,032,768 bf16 elements: p read and written, m and v (f32) read
    and written, the delayed buffer read and written, g read."""
    per = kernels.update_bytes_per_elem("fused_adam_delayed", 2, 2)
    assert per == 2 * 2 + 8 * 2 + 2 * 2 + 2
    assert 494_032_768 * per / peaks.HBM_BYTES_PER_S * 1e3 == \
        pytest.approx(3.8343, abs=1e-4)


def test_prefill_unembeds_one_position_and_decode_sees_its_keys():
    r = _run("qwen2-0.5b")
    full = flops.sequence_forward(r, 512, unembed_all=True)
    last = flops.sequence_forward(r, 512, unembed_all=False)
    assert full - last == 511 * flops.unembed(r)
    step = flops.decode_token(r, 600) - flops.decode_token(r, 599)
    assert step == 4 * 64 * 14 * 24
