"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit)."""

BF16_FLOPS = 989e12        # FLOP/s, tensor cores
F32_FLOPS = 67e12          # FLOP/s, CUDA cores
HBM_BYTES_PER_S = 3.35e12  # B/s
HBM_BYTES = 80e9           # B


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of ``flops`` at the
    bf16 peak and ``nbytes`` at the HBM rate."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
