"""Architecture + run configuration.

One :class:`ArchConfig` per assigned architecture lives in this package; the
exact dims come from the assignment table (sources cited per file).
``reduced()`` produces the smoke-test variant (≤2 layers, d_model ≤ 512,
≤4 experts) mandated by the brief.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None   # engaged for long_500k decode

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    attn_every: int = 0            # hybrid: shared attn block every k ssm layers

    # encoder-decoder (audio)
    enc_layers: int = 0
    dec_ratio: int = 4             # decoder seq = seq_len // dec_ratio
    frontend_dim: int = 0          # stubbed modality embedding dim (0 = none)

    # vlm
    n_patches: int = 0             # stub patch embeddings prepended in train
    vision_dim: int = 0

    # numerics / training
    use_flash_attention: bool = False   # Pallas kernel path (TPU target)
    use_ssd_kernel: bool = False        # Pallas SSD intra-chunk kernel
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    remat: str = "full"            # none | full

    # ---- derived -----------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_enc_dec(self) -> bool:
        return self.enc_layers > 0

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode (SSM state, hybrid, or SWA)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke variant of the same family: 2 layers, d_model ≤ 512, ≤4 experts."""
        d = min(self.d_model, 256)
        dh = 32
        nh = max(self.n_heads * d // self.d_model, 2)
        nh = min(max(nh, 2), d // dh)
        nkv = max(1, min(self.n_kv_heads, nh)) if self.n_kv_heads < self.n_heads else nh
        nkv = max(1, min(nkv, nh))
        while nh % nkv:
            nkv -= 1
        kw = dict(
            n_layers=2,
            d_model=d,
            n_heads=nh,
            n_kv_heads=nkv,
            d_head=dh,
            d_ff=min(self.d_ff, 512) or 0,
            vocab=min(self.vocab, 512),
        )
        if self.n_experts:
            kw.update(n_experts=4, top_k=min(self.top_k, 2),
                      n_shared_experts=min(self.n_shared_experts, 1),
                      moe_d_ff=min(self.moe_d_ff, 128))
        if self.ssm_state:
            kw.update(ssm_state=min(self.ssm_state, 32), ssm_head_dim=32,
                      ssm_chunk=16)
        if self.attn_every:
            kw.update(attn_every=1)   # 2 layers → 2 shared-attn insertions
        if self.enc_layers:
            kw.update(enc_layers=2)
        if self.n_patches:
            kw.update(n_patches=4, vision_dim=min(self.vision_dim, 64))
        if self.frontend_dim:
            kw.update(frontend_dim=min(self.frontend_dim, 32))
        if self.sliding_window:
            kw.update(sliding_window=32)
        return self.with_(**kw)


# ----------------------------------------------------------------------------
# input shapes (assigned)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def smoke_shape(kind: str) -> InputShape:
    return {
        "train": InputShape("smoke_train", 64, 2, "train"),
        "prefill": InputShape("smoke_prefill", 64, 2, "prefill"),
        "decode": InputShape("smoke_decode", 64, 2, "decode"),
    }[kind]
