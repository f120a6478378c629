"""Sequence-sharded decode attention: per-shard partial softmax, then the
merge of the shards' states.

This is the paper's pre-aggregation insight applied to the model layer
(DESIGN.md §2): each ``model``-axis shard holds a contiguous KV-cache
chunk [s·S_loc, (s+1)·S_loc) and produces the partial-softmax state
(m, l, o) over the live keys of its chunk — the monoid of
``kernels.flash_decode`` — and the shards' states are merged in the
reference's form and order: the global max first, then
corr_s = exp(m_s − m_g), l_g = Σ_s l_s·corr_s and o_g = Σ_s o_s·corr_s
summed in shard order (no atomics), and o_g / max(l_g, 1e-30).

The mesh is single-controller and every device of it must be the
cache's device: the chunks are ranges of one cache tensor, and a shard's
partials are one ``decode_partials`` call (the CUDA kernel on the card)
over the WHOLE cache with its [lo, hi) clipped into the chunk — a slice
of the cache along the sequence axis is a non-contiguous view, which the
kernel's wrapper would copy every step.  Placing the chunks on distinct
cards needs the decode state placed by ``distributed.sharding.
named_shardings``' consumer, which is not ported yet; such a mesh is
refused (``models.layers._decode_mesh``).

A shard whose clipped range is empty for a row adds exactly the merge
identity (m = −1e30, l = 0, o = 0), as the reference's ``_partials_gqa``
does.  The kernel (like the TPU kernel) treats an empty row otherwise —
l = S, o = the sum of every value row, the whole cache read — so such a
row is given its chunk's first key instead (one key row read, never the
cache) and its state is replaced by the identity before the merge.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.flash_decode import decode_partials

__all__ = ["sharded_decode_attention", "shard_ranges"]

_NEG = -1e30


def _chunk_starts(n_shards: int, s_loc: int, device) -> torch.Tensor:
    """(n_shards, 1) int32 first position of every shard's chunk."""
    return (torch.arange(n_shards, dtype=torch.int32, device=device)
            * s_loc)[:, None]


def shard_ranges(pos: torch.Tensor, n_shards: int, s_loc: int,
                 window=0):
    """Every row's live range clipped into each shard's chunk
    [s·S_loc, (s+1)·S_loc): (lo, hi, live), each (n_shards, B), lo/hi
    int32 absolute positions and ``live`` = lo < hi.  The row's live
    range is [max(pos + 1 − window, 0), pos + 1) (the whole prefix
    without a window)."""
    hi_g = (pos + 1).to(torch.int32)
    lo_g = (torch.clamp(hi_g - window, min=0) if window
            else torch.zeros_like(hi_g))
    start = _chunk_starts(n_shards, s_loc, pos.device)
    lo = torch.minimum(torch.maximum(lo_g[None], start), start + s_loc)
    hi = torch.minimum(torch.maximum(hi_g[None], start), start + s_loc)
    return lo, hi, lo < hi


def sharded_decode_attention(q, cache_k, cache_v, k_new, v_new, pos,
                             mesh, axis: str = "model", window=0,
                             use_kernel: Optional[bool] = None):
    """One decode step against a sequence-sharded KV cache.

    q: (B, 1, Hq, D); cache_k/v: (B, S, Hkv, D), S a multiple of the
    axis size, on the mesh's device; k_new/v_new: (B, 1, Hkv, D); pos:
    (B,) current lengths.  The new token's K/V are written into its
    owning chunk (in place).  Returns (out (B, 1, Hq, D), cache_k,
    cache_v)."""
    b = q.shape[0]
    n_shards = mesh.shape[axis]
    s_loc = cache_k.shape[1] // n_shards
    rows = torch.arange(b, device=cache_k.device)
    cache_k[rows, pos.long()] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, pos.long()] = v_new[:, 0].to(cache_v.dtype)
    q0 = q[:, 0].to(torch.float32).contiguous()
    lo, hi, live = shard_ranges(pos, n_shards, s_loc, window)
    # a dead row reads its chunk's first key instead of the whole cache
    first = _chunk_starts(n_shards, s_loc, lo.device)
    lo = torch.where(live, lo, first)
    hi = torch.where(live, hi, first + 1)
    parts = [decode_partials(q0, cache_k, cache_v, lo[s], hi[s],
                             use_kernel=use_kernel, span=s_loc)
             for s in range(n_shards)]
    # dead rows add exactly the merge identity (m = -1e30, l = 0, o = 0)
    m = torch.where(live[..., None], torch.stack([p[0] for p in parts]),
                    _NEG)
    l = torch.where(live[..., None], torch.stack([p[1] for p in parts]),
                    0.0)
    o = torch.where(live[..., None, None],
                    torch.stack([p[2] for p in parts]), 0.0)
    # the aggregator merge across shards: the global max, then the
    # rescaled sums in shard order
    corr = torch.exp(m - m.amax(dim=0))
    lc, oc = l * corr, o * corr[..., None]
    l_g, o_g = lc[0], oc[0]
    for s in range(1, n_shards):
        l_g = l_g + lc[s]
        o_g = o_g + oc[s]
    out = (o_g / torch.clamp(l_g, min=1e-30)[..., None]).to(q.dtype)
    return out[:, None], cache_k, cache_v
