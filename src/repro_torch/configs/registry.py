"""Architecture configs (exact numbers from the task pool), copied as
data from the JAX package."""

from __future__ import annotations

from typing import Dict

from .base import (ArchConfig, EncDecSpec, MLASpec, MoESpec, SSMSpec,
                   VLMSpec)

__all__ = ["ARCHS", "get", "reduced"]


ARCHS: Dict[str, ArchConfig] = {}


def _reg(cfg: ArchConfig) -> ArchConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# --- hybrid: parallel attn + mamba heads ----------------------------------
_reg(ArchConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, d_ff=5504, vocab_size=32001, head_dim=64,
    ssm=SSMSpec(state_dim=16, expand=2), sliding_window=1024,
    global_attn_every=16,  # layers 0, 16 (+ last forced) global
    source="[arXiv:2411.13676; hf]"))

# --- audio enc-dec ----------------------------------------------------------
_reg(ArchConfig(
    name="whisper-tiny", family="audio", n_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, d_ff=1536, vocab_size=51865,
    encdec=EncDecSpec(n_enc_layers=4, n_frames=1500),
    source="[arXiv:2212.04356; unverified]"))

# --- attention-free SSM (Finch) ---------------------------------------------
_reg(ArchConfig(
    name="rwkv6-7b", family="ssm", n_layers=32, d_model=4096,
    n_heads=64, n_kv_heads=64, d_ff=14336, vocab_size=65536, head_dim=64,
    attn_type="none", source="[arXiv:2404.05892; hf]"))

# --- MoE ---------------------------------------------------------------------
_reg(ArchConfig(
    name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=10752, vocab_size=100352, head_dim=128,
    moe=MoESpec(n_experts=16, top_k=4, d_expert=10752),
    source="[hf:databricks/dbrx-base; unverified]"))

_reg(ArchConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=151936, head_dim=128,
    moe=MoESpec(n_experts=60, top_k=4, d_expert=1408, n_shared=4),
    source="[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"))

# --- dense -------------------------------------------------------------------
_reg(ArchConfig(
    name="granite-3-8b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=12800, vocab_size=49155, head_dim=128,
    source="[hf:ibm-granite/granite-3.0-2b-base; hf]"))

_reg(ArchConfig(
    name="minicpm3-4b", family="dense", n_layers=62, d_model=2560,
    n_heads=40, n_kv_heads=40, d_ff=6400, vocab_size=73448,
    attn_type="mla",
    mla=MLASpec(q_rank=768, kv_rank=256, rope_dim=32, nope_dim=64,
                v_dim=64),
    source="[hf:openbmb/MiniCPM3-4B; hf]"))

_reg(ArchConfig(
    name="llama3-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=128256, head_dim=128,
    rope_theta=500000.0, source="[arXiv:2407.21783; unverified]"))

_reg(ArchConfig(
    name="qwen3-8b", family="dense", n_layers=36, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=12288, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1000000.0, source="[hf:Qwen/Qwen3-8B; hf]"))

# --- VLM backbone ------------------------------------------------------------
_reg(ArchConfig(
    name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=20480, vocab_size=64000, head_dim=128,
    vlm=VLMSpec(n_patches=576),
    source="[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"))


def get(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHS)}") from None


def reduced(name: str) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests (few layers, narrow
    widths, small vocab; MoE keeps multiple experts, enc-dec keeps both
    stacks, VLM keeps a patch prefix)."""
    import dataclasses

    cfg = get(name)
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128,
        vocab_size=257,
        head_dim=16,
    )
    if cfg.moe is not None:
        kw["moe"] = MoESpec(n_experts=4, top_k=2, d_expert=64,
                            n_shared=cfg.moe.n_shared and 1)
    if cfg.mla is not None:
        kw["mla"] = MLASpec(q_rank=32, kv_rank=16, rope_dim=8, nope_dim=16,
                            v_dim=16)
    if cfg.ssm is not None:
        kw["ssm"] = SSMSpec(state_dim=4, expand=2)
    if cfg.encdec is not None:
        kw["encdec"] = EncDecSpec(n_enc_layers=2, n_frames=16)
    if cfg.vlm is not None:
        kw["vlm"] = VLMSpec(n_patches=8)
    if cfg.sliding_window:
        kw["sliding_window"] = 8
        kw["global_attn_every"] = 2
    if cfg.family == "ssm":
        kw["n_heads"] = 4
        kw["n_kv_heads"] = 4
    return dataclasses.replace(cfg, **kw)
