"""FLOP arithmetic of the hybrid family (``reference/hybrid.py``):
attention heads and SSM heads side by side, a SwiGLU MLP."""

from __future__ import annotations

from typing import Dict

from ..reference.hybrid import windows  # noqa: F401  (per layer)


def layer_weights(cfg: Dict) -> int:
    """Multiply-adds of one token through one layer's weight products:
    q, k, v and o; the SSM's in, B, C and out projections; the MLP."""
    d = cfg["d_model"]
    hq = cfg["n_heads"] * cfg["head_dim"]
    hkv = cfg["n_kv_heads"] * cfg["head_dim"]
    di, n = cfg["ssm_expand"] * d, cfg["ssm_state_dim"]
    attn = 2 * d * hq + 2 * d * hkv
    ssm = d * 2 * di + 2 * d * n + di * d
    return attn + ssm + 3 * d * cfg["d_ff"]


def attention_width(cfg: Dict) -> int:
    """Scores and weighted values over all heads, head_dim each."""
    return 2 * cfg["n_heads"] * cfg["head_dim"]
