"""Plain PyTorch decode attention and the partial-merge monoid — the CPU
path and the version the CUDA kernel (``csrc/flash_decode.cu``) is held
against on the card.

``decode_partials_ref`` is the reference's ``_partials_gqa``
(``repro/models/sharded_decode.py``) over a live key range [lo, hi):
query head h attends KV head h // g (g = Hq / Hkv), scores are scaled by
d^-1/2 after the dot product, keys outside the range score -1e30.

A row with no live key follows the TPU kernel
(``repro/kernels/flash_decode/kernel.py::decode_partials_pallas``),
which does not mask ``p`` again after the exponential: every key of the
cache scores -1e30, so m = -1e30, p = 1 for each of the S keys,
l = S and o = the sum of the S value rows.  (``_partials_gqa`` masks
``p`` and returns l = 0, o = 0 there.)  A merge never sees the
difference, since exp(-1e30 - m) = 0 beside any live partial, and no
decode row of the model is empty: the token just written is live.
For a row with a live key the masked p are exactly 0 in float32, so the
two definitions agree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["NEG", "decode_partials_ref", "decode_attention_ref",
           "merge_partials", "finalize_partials"]

NEG = -1e30


def decode_partials_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lo: torch.Tensor, hi: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial-softmax state (m, l, o) over the live keys [lo, hi).

    q: (B, Hq, D); k/v: (B, S, Hkv, D); lo/hi: (B,) int.  Returns
    m, l: (B, Hq) and o: (B, Hq, D), float32.
    """
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.to(torch.float32).reshape(b, hkv, g, d)
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k.to(torch.float32)) \
        * d ** -0.5
    pos = torch.arange(s, device=k.device)
    live = (pos[None, :] >= lo[:, None]) & (pos[None, :] < hi[:, None])
    sc = torch.where(live[:, None, None, :], sc, NEG)
    m = sc.amax(dim=-1)
    p = torch.exp(sc - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.to(torch.float32))
    return m.reshape(b, hq), l.reshape(b, hq), o.reshape(b, hq, d)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Single-token attention in one softmax: q (B, Hq, D), k/v
    (B, S, Hkv, D), mask (B, S) of live keys -> (B, Hq, D) float32."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(b, hkv, hq // hkv, d)
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k.to(torch.float32)) \
        * d ** -0.5
    if mask is not None:
        sc = torch.where(mask[:, None, None, :], sc, NEG)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.to(torch.float32))
    return out.reshape(b, hq, d)


def merge_partials(a, b):
    """Combine two (m, l, o) shard partials — associative & commutative."""
    ma, la, oa = a
    mb, lb, ob = b
    m = torch.maximum(ma, mb)
    ea = torch.exp(ma - m)
    eb = torch.exp(mb - m)
    return m, la * ea + lb * eb, oa * ea[..., None] + ob * eb[..., None]


def finalize_partials(m, l, o) -> torch.Tensor:
    return o / torch.clamp(l, min=1e-30)[..., None]
