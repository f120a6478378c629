"""FLOP arithmetic of the MLA family (``reference/mla.py``): queries and
keys of nope + rope numbers a head, values of ``v_dim``, every layer
global."""

from __future__ import annotations

from typing import Dict, List


def windows(cfg: Dict) -> List[int]:
    return [0] * cfg["n_layers"]


def layer_weights(cfg: Dict) -> int:
    """Multiply-adds of one token through one layer's weight products:
    the query's down and up projections, the latent's down projection
    (with the shared rotary key), the keys' and values' up projections,
    the output, the MLP."""
    d, h = cfg["d_model"], cfg["n_heads"]
    qr, kr = cfg["q_rank"], cfg["kv_rank"]
    dn, dr, dv = cfg["nope_dim"], cfg["rope_dim"], cfg["v_dim"]
    attn = (d * qr + qr * h * (dn + dr) + d * (kr + dr)
            + kr * h * dn + kr * h * dv + h * dv * d)
    return attn + 3 * d * cfg["d_ff"]


def attention_width(cfg: Dict) -> int:
    """q . k over nope + rope, p . v over v_dim, all heads."""
    h = cfg["n_heads"]
    return h * (cfg["nope_dim"] + cfg["rope_dim"]) + h * cfg["v_dim"]
