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

A dead key of a row with a live key is not read: its score is masked and
its value row counts as zero, so a NaN or Inf there (a stale or unwritten
cache slot) does not reach the result, as in the CUDA kernel, which never
loads it.  (The reference's einsum would give 0 * NaN = NaN.)

``decode_partials_split_ref`` is the CUDA kernel's split-KV schedule in
plain PyTorch, for the tests: the key axis cut into splits, each split's
state computed by ``decode_partials_ref``, splits outside a live row's
range given the merge identity, merged in split order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["NEG", "decode_partials_ref", "decode_partials_split_ref",
           "decode_attention_ref", "merge_partials", "finalize_partials"]

NEG = -1e30


def decode_partials_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lo: torch.Tensor, hi: torch.Tensor,
                        dtype: torch.dtype = torch.float32
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial-softmax state (m, l, o) over the live keys [lo, hi).

    q: (B, Hq, D); k/v: (B, S, Hkv, D); lo/hi: (B,) int.  Returns
    m, l: (B, Hq) and o: (B, Hq, D) in ``dtype`` (float32; a test may ask
    for float64, the exact value the float32 sums round).
    """
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.to(dtype).reshape(b, hkv, g, d)
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k.to(dtype)) * d ** -0.5
    pos = torch.arange(s, device=k.device)
    live = (pos[None, :] >= lo[:, None]) & (pos[None, :] < hi[:, None])
    sc = torch.where(live[:, None, None, :], sc, NEG)
    m = sc.amax(dim=-1)
    p = torch.exp(sc - m[..., None])
    l = p.sum(dim=-1)
    read = live | ~live.any(dim=1, keepdim=True)   # an empty row reads all
    vv = torch.where(read[:, :, None, None], v.to(dtype), 0.0)
    o = torch.einsum("bkgs,bskd->bkgd", p, vv)
    return m.reshape(b, hq), l.reshape(b, hq), o.reshape(b, hq, d)


def decode_partials_split_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, lo: torch.Tensor,
                              hi: torch.Tensor, split: int
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """``decode_partials_ref`` computed split by split (``split`` keys
    each) and merged in split order with ``merge_partials``; a split
    outside a live row's [lo, hi) gives the identity (m = -1e30, l = 0,
    o = 0).  A row with no live key walks every split masked, so its
    counts add up to l = S."""
    s = k.shape[1]
    lo, hi = lo.to(torch.int64), hi.to(torch.int64)
    start, end = lo.clamp(min=0), hi.clamp(max=s)
    live = start < end
    acc = None
    for a in range(0, s, split):
        z = min(a + split, s)
        m, l, o = decode_partials_ref(q, k[:, a:z], v[:, a:z],
                                      (start - a).clamp(0, z - a),
                                      (end - a).clamp(0, z - a))
        outside = live & ((end <= a) | (start >= z))
        m = torch.where(outside[:, None], NEG, m)
        l = torch.where(outside[:, None], 0.0, l)
        o = torch.where(outside[:, None, None], 0.0, o)
        acc = (m, l, o) if acc is None else merge_partials(acc, (m, l, o))
    return acc


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
