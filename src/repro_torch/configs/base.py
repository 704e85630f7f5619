"""Architecture + shape configuration schema (the port's copy of
``repro.configs.base``, the same dataclasses as plain data).

One :class:`ArchConfig` per assigned architecture (see the sibling
modules); every config also provides ``reduced()`` — a same-family tiny
variant for CPU smoke tests.  :class:`ShapeSpec` describes the assigned
input shapes; ``supports()`` encodes the applicability matrix
(DESIGN.md §4): ``long_500k`` needs sub-quadratic attention, decode
shapes need a decoder.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    every: int = 1              # MoE layer every N layers (llama4: 2)
    capacity_factor: float = 1.25
    shared_experts: int = 0     # llama4: 1 shared expert


@dataclass(frozen=True)
class SSMCfg:
    state: int = 128            # N (SSD state dim)
    headdim: int = 64           # P
    expand: int = 2             # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 128            # SSD chunk length (tuning parameter)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | ssm | moe | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    qk_norm: bool = False                # qwen3
    qkv_bias: bool = False               # qwen1.5
    window: int | None = None            # sliding-window attention width
    rope_theta: float = 10_000.0
    use_rope: bool = True
    tie_embeddings: bool = False
    mlp_act: str = "swiglu"              # swiglu | gelu
    moe: MoECfg | None = None
    ssm: SSMCfg | None = None
    cross_attn_every: int | None = None  # vlm: 1 cross-attn per N layers
    n_img_tokens: int = 1024             # vlm stub frontend output length
    encoder_layers: int = 0              # audio enc-dec
    enc_seq: int = 1500                  # audio stub frame count
    logits_dtype: str = "float32"
    use_flash: bool = False              # route full-seq self-attention
    #   through the @autotune'd CUDA flash kernel (shapes the kernel
    #   cannot tile take the plain math per call site)
    remat: str = "full"                  # none | dots | full (tunable)
    ssd_dtype: str = "float32"           # SSD intra-chunk compute dtype (tunable)
    loss_seq_chunk: int = 0              # 0 = whole-sequence CE; else chunked
    source: str = ""                     # provenance tag

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def subquadratic(self) -> bool:
        """Can decode a 500k context without O(S^2) attention state?"""

        return self.family == "ssm" or self.window is not None

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""

        kw: dict = dict(
            n_layers=max(2, (self.cross_attn_every or 2)),
            d_model=64, n_heads=4, head_dim=16,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128, vocab=256, n_img_tokens=8, enc_seq=16,
        )
        if self.window is not None:
            kw["window"] = 8
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2))
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, state=8, headdim=8, chunk=8)
        if self.encoder_layers:
            kw["encoder_layers"] = 2
        if self.cross_attn_every:
            kw["cross_attn_every"] = 2
            kw["n_layers"] = 4
        if self.moe is not None and self.moe.every > 1:
            kw["n_layers"] = 4
        return self.replace(**kw)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode

    def reduced(self) -> "ShapeSpec":
        return ShapeSpec(self.name, min(self.seq_len, 32), min(self.global_batch, 2),
                         self.kind)


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def supports(arch: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(supported, reason-if-not) per the assignment's applicability rules."""

    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "long_500k needs sub-quadratic attention; " \
                      f"{arch.name} is pure full-attention"
    return True, ""


__all__ = ["ArchConfig", "ShapeSpec", "MoECfg", "SSMCfg", "SHAPES", "supports"]
