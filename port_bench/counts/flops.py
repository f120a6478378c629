"""Model FLOPs of a step and the bytes of the scan kernels, from the
configuration file's sizes.

Model FLOPs count the contractions a step must do: 2 per multiply-add of
every weight product a token goes through (the embedding is a lookup and
counts nothing), and of the attention's scores and weighted values over
the keys each query may see (causal, and no older than the layer's
window).  The head over the real vocabulary counts at every position of
a training step and at the last position of a prefill, the only logits a
prefill returns.  A training step counts three times its forward (the
backward twice); recomputation counts nothing.  Elementwise work (norms,
softmax, the SSM's scan) is not counted.

What differs by family sits in ``counts/<family>.py``, the family being
the configuration's ``reference``: ``layer_weights(cfg)`` (multiply-adds
of one token through one layer's weight products), ``attention_width(cfg)``
(multiply-adds per query and key of one layer, all heads) and
``windows(cfg)`` (per layer, 0 or the sliding window).

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit.
"""

from __future__ import annotations

import importlib
from typing import Dict

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def family(cfg: Dict):
    """The module ``counts/<family>.py`` of the configuration's family."""
    name = f"port_bench.counts.{cfg['reference']}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"no FLOP count for family {cfg['reference']!r}: "
                         f"counts/{cfg['reference']}.py is missing") from e


def keys_seen(seq: int, window: int) -> int:
    """Sum over the queries of a causal sequence of the keys each sees."""
    if not window or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def forward_flops(cfg: Dict, batch: int, seq: int,
                  head_positions: int = 0) -> float:
    """FLOPs of one forward over ``batch`` sequences of ``seq`` tokens,
    the head at ``head_positions`` of each (0: at every position)."""
    fam = family(cfg)
    pairs = sum(keys_seen(seq, w) for w in fam.windows(cfg))
    head = (head_positions or seq) * cfg["d_model"] * cfg["vocab_size"]
    return 2.0 * batch * (seq * cfg["n_layers"] * fam.layer_weights(cfg)
                          + head + pairs * fam.attention_width(cfg))


def prefill_flops(cfg: Dict, batch: int, seq: int) -> float:
    return forward_flops(cfg, batch, seq, head_positions=1)


def train_flops(cfg: Dict, batch: int, seq: int) -> float:
    return 3.0 * forward_flops(cfg, batch, seq)


def scan_bytes(n: int, backward: bool = False) -> int:
    """Least bytes of one f32 linear-scan call over ``n`` elements: the
    forward reads a and b and writes y; the backward reads a, y and the
    upstream gradient and writes da and db."""
    return (5 if backward else 3) * n * 4


def scan_elements(cfg: Dict, rows: int, seq: int) -> int:
    """Elements of one SSM scan call: rows x time x d_inner x state."""
    return rows * seq * cfg["ssm_expand"] * cfg["d_model"] * cfg[
        "ssm_state_dim"]
