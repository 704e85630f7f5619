"""The 10 assigned architectures (exact public configs) + registry (the
port's copy of ``repro.configs.registry``: the same names and values)."""

from __future__ import annotations

from .base import ArchConfig, MoECfg, SSMCfg

minitron_8b = ArchConfig(
    name="minitron-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=16384, vocab=256_000, head_dim=128,
    source="pruned nemotron [arXiv:2407.14679; hf]")

qwen3_32b = ArchConfig(
    name="qwen3-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=64, n_kv_heads=8, d_ff=25600, vocab=151_936, head_dim=128,
    qk_norm=True, rope_theta=1e6,
    source="qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]")

qwen15_4b = ArchConfig(
    name="qwen1.5-4b", family="dense", n_layers=40, d_model=2560,
    n_heads=20, n_kv_heads=20, d_ff=6912, vocab=151_936, qkv_bias=True,
    use_flash=True,   # flash-path default: full-size shapes tile by 128;
                      # untileable smoke shapes fall back per call site
    source="QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]")

smollm_135m = ArchConfig(
    name="smollm-135m", family="dense", n_layers=30, d_model=576,
    n_heads=9, n_kv_heads=3, d_ff=1536, vocab=49_152, tie_embeddings=True,
    source="llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf]")

mamba2_27b = ArchConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
    n_heads=80, n_kv_heads=80, d_ff=0, vocab=50_280, head_dim=64,
    ssm=SSMCfg(state=128, headdim=64, expand=2, chunk=128),
    source="SSD (state-space duality) [arXiv:2405.21060; unverified]")

mixtral_8x22b = ArchConfig(
    name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=32_768, head_dim=128,
    window=4096, moe=MoECfg(num_experts=8, top_k=2),
    source="8 experts top-2, SWA [arXiv:2401.04088; hf]")

llama4_maverick = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48,
    d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202_048,
    head_dim=128,
    moe=MoECfg(num_experts=128, top_k=1, every=2, shared_experts=1),
    source="MoE, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E; "
           "unverified] — fused image tokens arrive via the token stream "
           "(frontend stubbed); public Llama-4 uses chunked attention on "
           "some layers, unpinned here -> modeled as full attention")

llama32_vision_90b = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm", n_layers=100, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128_256, head_dim=128,
    cross_attn_every=5, n_img_tokens=1024,
    source="cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision; "
           "unverified] — vision frontend stubbed: input_specs() provides "
           "precomputed patch embeddings")

hymba_15b = ArchConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, d_ff=5504, vocab=32_001, head_dim=64,
    window=1024, ssm=SSMCfg(state=16, headdim=64, expand=2, chunk=128),
    source="parallel attn+mamba heads [arXiv:2411.13676; hf] — SWA window "
           "1024 on the attention half, per-layer learned output mix")

whisper_medium = ArchConfig(
    name="whisper-medium", family="audio", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=51_865,
    encoder_layers=24, enc_seq=1500, use_rope=False, mlp_act="gelu",
    source="enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified] — "
           "input_specs() provides precomputed frame embeddings")

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [
    minitron_8b, qwen3_32b, qwen15_4b, smollm_135m, mamba2_27b,
    mixtral_8x22b, llama4_maverick, llama32_vision_90b, hymba_15b,
    whisper_medium,
]}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "get_config"] + [k.replace("-", "_").replace(".", "")
                                     for k in ()]
