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

The reference's ``shard_map`` on pieces.  The cache is placed as its
``in_specs`` place it, P(bspec, model, None, None) with the batch over
``data`` where it divides (``decode_cache_spec``): mesh entry (d, s)
holds the K/V rows of data block d and chunk s as one contiguous tensor
on its own device (``distributed.sharding.Placed``; a whole cache handed
in is placed at the first step).  Per call, on every entry's device:
block d's q / new K/V / positions are copied there; the new token is
written, by its owner, and every other entry writes back the value
already at the slot (no host sync, no data-dependent branch); one
``decode_partials`` (the CUDA kernel on a card) runs over the chunk with
the row's live range in chunk positions.  The partials come to the home
device (q's), are merged per data block in shard order, and the blocks
are joined in data order.  Entries that differ only along other mesh
axes are replicas: each is written, the first computes.  The entries may
be distinct cards or repeat one device.

A shard whose live range is empty for a row adds exactly the merge
identity (m = −1e30, l = 0, o = 0), as the reference's ``_partials_gqa``
does.  The kernel (like the TPU kernel) treats an empty row otherwise —
l = S, o = the sum of every value row, the whole chunk read — so such a
row is given its chunk's first key instead (one key row read) and its
state is replaced by the identity before the merge.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..distributed.sharding import NamedSharding, PartitionSpec, device_put
from ..kernels.flash_decode import decode_partials

__all__ = ["sharded_decode_attention", "chunk_range", "decode_cache_spec"]

_NEG = -1e30


def decode_cache_spec(b: int, mesh, axis: str = "model",
                      batch_axis: Optional[str] = "data") -> PartitionSpec:
    """The spec of a (B, S, Hkv, D) cache under the sequence-sharded
    decode, the reference's ``in_specs``: the batch over ``batch_axis``
    where it divides, the sequence over ``axis``."""
    bspec = batch_axis if (batch_axis in mesh.shape
                           and b % mesh.shape[batch_axis] == 0
                           and b >= mesh.shape[batch_axis]) else None
    return PartitionSpec(bspec, axis, None, None)


def chunk_range(pos: torch.Tensor, start: int, s_loc: int, window=0):
    """Every row's live range [max(pos + 1 − window, 0), pos + 1) (the
    whole prefix without a window) clipped into the chunk
    [start, start + s_loc), in chunk positions: (lo, hi, live), each
    (B,) on ``pos``'s device, lo/hi int32 and ``live`` = lo < hi."""
    hi = torch.clamp(pos + 1 - start, 0, s_loc).to(torch.int32)
    lo = (torch.clamp(pos + 1 - window - start, 0, s_loc).to(torch.int32)
          if window else torch.zeros_like(hi))
    return lo, hi, lo < hi


def _write(pk, pv, k_new, v_new, pos, start: int) -> None:
    """The new token's K/V at chunk position ``pos - start`` of pieces
    ``pk`` / ``pv`` where the chunk owns it; elsewhere the slot's own
    value is written back (the reference's owner-or-old write)."""
    s_loc = pk.shape[1]
    local = pos - start
    own = ((local >= 0) & (local < s_loc))[:, None, None]
    slot = torch.clamp(local, 0, s_loc - 1).long()
    rows = torch.arange(pk.shape[0], device=pk.device)
    for piece, new in ((pk, k_new), (pv, v_new)):
        piece[rows, slot] = torch.where(own, new.to(piece.dtype),
                                        piece[rows, slot])


def sharded_decode_attention(q, cache_k, cache_v, k_new, v_new, pos,
                             mesh, axis: str = "model", window=0,
                             use_kernel: Optional[bool] = None,
                             batch_axis: Optional[str] = "data"):
    """One decode step against a sequence-sharded KV cache.

    q: (B, 1, Hq, D) on the home device; cache_k/v: (B, S, Hkv, D) in
    pieces (``Placed``) or whole, S a multiple of the axis size;
    k_new/v_new: (B, 1, Hkv, D); pos: (B,) current lengths.  The new
    token's K/V are written into its owning chunk's pieces (in place).
    Returns (out (B, 1, Hq, D) on the home device, cache_k, cache_v),
    the caches as ``Placed``."""
    home = q.device
    b = q.shape[0]
    sharding = NamedSharding(mesh, decode_cache_spec(b, mesh, axis,
                                                     batch_axis))
    ck, cv = device_put((cache_k, cache_v), (sharding, sharding))
    bspec = sharding.spec[0]
    names = mesh.axis_names
    a_s = names.index(axis)
    a_b = names.index(bspec) if bspec is not None else None
    n_shards = mesh.shape[axis]
    n_blocks = mesh.shape[bspec] if bspec is not None else 1
    bl, s_loc = b // n_blocks, ck.shape[1] // n_shards
    q0 = q[:, 0].to(torch.float32)
    parts = [[None] * n_shards for _ in range(n_blocks)]
    for i in np.ndindex(mesh.devices.shape):
        s, d = i[a_s], (i[a_b] if a_b is not None else 0)
        dev = mesh.devices[i]
        rows = slice(d * bl, (d + 1) * bl)
        p = pos[rows].to(dev)
        pk, pv = ck.pieces[i], cv.pieces[i]
        _write(pk, pv, k_new[rows, 0].to(dev), v_new[rows, 0].to(dev), p,
               s * s_loc)
        if any(x for j, x in enumerate(i) if j not in (a_s, a_b)):
            continue                          # a replica: written only
        lo, hi, live = chunk_range(p, s * s_loc, s_loc, window)
        # a dead row reads its chunk's first key, not the whole chunk
        m, l, o = decode_partials(q0[rows].to(dev), pk, pv,
                                  torch.where(live, lo, 0),
                                  torch.where(live, hi, 1),
                                  use_kernel=use_kernel)
        # dead rows add exactly the merge identity (m = -1e30, l = 0, o = 0)
        parts[d][s] = (torch.where(live[:, None], m, _NEG).to(home),
                       torch.where(live[:, None], l, 0.0).to(home),
                       torch.where(live[:, None, None], o, 0.0).to(home))
    outs = []
    for blk in parts:
        # the aggregator merge across shards: the global max, then the
        # rescaled sums in shard order
        m = torch.stack([x[0] for x in blk])
        corr = torch.exp(m - m.amax(dim=0))
        l_g = blk[0][1] * corr[0]
        o_g = blk[0][2] * corr[0][..., None]
        for s in range(1, n_shards):
            l_g = l_g + blk[s][1] * corr[s]
            o_g = o_g + blk[s][2] * corr[s][..., None]
        outs.append(o_g / torch.clamp(l_g, min=1e-30)[..., None])
    out = torch.cat(outs).to(q.dtype)
    return out[:, None], ck, cv
