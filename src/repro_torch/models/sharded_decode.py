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
are joined in data order.  The copies out, the work and the copies home
are issued in three passes over the entries, so that distinct cards
work at once (``_over_entries``).  Entries that differ only along other mesh
axes are replicas: each is written, the first computes.  The entries may
be distinct cards or repeat one device.

A shard whose live range is empty for a row adds exactly the merge
identity (m = −1e30, l = 0, o = 0), as the reference's ``_partials_gqa``
does.  The kernel (like the TPU kernel) treats an empty row otherwise —
l = S, o = the sum of every value row, the whole chunk read — so such a
row is given its chunk's first key instead (one key row read) and its
state is replaced by the identity before the merge.

A decode state's recurrent leaves placed by ``cache_pspecs`` are updated
the same way, piece by piece on their entries' devices in the three
passes: RWKV6's ``S`` (B, H, dh, dh), batch blocks over ``data``
(``placed_wkv_step``), and hymba's SSM state (B, d_inner, n), channel
pieces over ``model`` (``placed_ssm_step``).  Each entry gets its
block's slices of the step's inputs, repeats the whole update's
arithmetic on its piece (replicas too, so they stay equal), and the
first entry of each block sends its rows of the output home, where the
blocks are joined in entry order.  The state never leaves its cards.

MLA's latent cache (B, S, kv_rank + rope_dim) takes the same route
(``sharded_mla_decode``), placed P(bspec, model, None).  The
reference's absorbed decode is plain ``jnp`` and reaches no Pallas
kernel, so each entry computes its piece's partial state in plain
torch: f32 scores ``q_abs · c + q_rope · r`` over the piece (the piece
alone cast to f32), then (m, l, o) over its ``c`` half; the same merge
combines them.

A prefill into a placed state (``model.forward_prefill(..., state=)``)
writes each layer's contribution for a block of rows into the leaves in
place (``write_region``): every entry whose block meets the region --
the rows' positions [0, S) of a sequence piece, a batch block's rows, a
channel piece -- gets its part, replicas too, in the same passes: every
part copied to its entry's card first, then every write there; nothing
comes home.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..distributed.sharding import (NamedSharding, PartitionSpec, Placed,
                                    blocks, canonical_device, device_put,
                                    gather, region_pieces, shard_slices)
from ..kernels.flash_decode import decode_partials

__all__ = ["sharded_decode_attention", "sharded_mla_decode", "chunk_range",
           "decode_cache_spec", "three_passes", "placed_wkv_step",
           "placed_ssm_step", "write_region"]

_NEG = -1e30


def decode_cache_spec(b: int, mesh, axis: str = "model",
                      batch_axis: Optional[str] = "data",
                      ndim: int = 4) -> PartitionSpec:
    """The spec of a (B, S, Hkv, D) cache (``ndim`` 4) or a (B, S, R)
    latent cache (``ndim`` 3) under the sequence-sharded decode, the
    reference's ``in_specs``: the batch over ``batch_axis`` where it
    divides, the sequence over ``axis``."""
    bspec = batch_axis if (batch_axis in mesh.shape
                           and b % mesh.shape[batch_axis] == 0
                           and b >= mesh.shape[batch_axis]) else None
    return PartitionSpec(bspec, axis, *([None] * (ndim - 2)))


def chunk_range(pos: torch.Tensor, start: int, s_loc: int, window=0):
    """Every row's live range [max(pos + 1 − window, 0), pos + 1) (the
    whole prefix without a window) clipped into the chunk
    [start, start + s_loc), in chunk positions: (lo, hi, live), each
    (B,) on ``pos``'s device, lo/hi int32 and ``live`` = lo < hi."""
    hi = torch.clamp(pos + 1 - start, 0, s_loc).to(torch.int32)
    lo = (torch.clamp(pos + 1 - window - start, 0, s_loc).to(torch.int32)
          if window else torch.zeros_like(hi))
    return lo, hi, lo < hi


def _write(pieces, news, pos, start: int) -> None:
    """Each row's new entry (``news[j]`` (B, ...) for the (B, S_loc, ...)
    piece ``pieces[j]``) at chunk position ``pos - start`` where the
    chunk owns it; elsewhere the slot's own value is written back (the
    reference's owner-or-old write)."""
    s_loc = pieces[0].shape[1]
    local = pos - start
    own = (local >= 0) & (local < s_loc)
    slot = torch.clamp(local, 0, s_loc - 1).long()
    rows = torch.arange(pieces[0].shape[0], device=pieces[0].device)
    for piece, new in zip(pieces, news):
        keep = own.reshape((-1,) + (1,) * (new.dim() - 1))
        piece[rows, slot] = torch.where(keep, new.to(piece.dtype),
                                        piece[rows, slot])


def _entries(caches, b: int, mesh, axis: str, batch_axis: Optional[str]):
    """``caches`` (leaves of one shape, ``Placed`` or whole) placed by the
    decode's spec, and the mesh entries to visit as (index, shard s,
    data block d, replica) -- a replica differs from another entry only
    along other mesh axes: it is written, never read -- with the
    shard and data-block counts."""
    sharding = NamedSharding(mesh, decode_cache_spec(
        b, mesh, axis, batch_axis, len(caches[0].shape)))
    placed = device_put(tuple(caches), (sharding,) * len(caches))
    bspec = sharding.spec[0]
    names = mesh.axis_names
    a_s = names.index(axis)
    a_b = names.index(bspec) if bspec is not None else None
    entries = [(i, i[a_s], i[a_b] if a_b is not None else 0,
                any(x for j, x in enumerate(i) if j not in (a_s, a_b)))
               for i in np.ndindex(mesh.devices.shape)]
    return (placed, entries, mesh.shape[axis],
            mesh.shape[bspec] if bspec is not None else 1)


def _dead_to_identity(live, m, l, o):
    """A piece's partial state with every row that has no live position
    in the chunk replaced by exactly the merge identity (m = −1e30, l =
    0, o = 0)."""
    return (torch.where(live[:, None], m, _NEG),
            torch.where(live[:, None], l, 0.0),
            torch.where(live[:, None, None], o, 0.0))


def three_passes(entries, send, work, home):
    """``work``'s outputs of every entry on ``home``, in three passes:
    every entry's inputs copied to its device (``send(entry)``), then
    every entry's work there (``work(entry, inputs)``: a tuple of
    tensors, or None where nothing comes home), then the outputs copied
    to ``home`` in entry order.  A copy between two cards makes each
    card's stream wait for the other's earlier work, so an output
    brought home between two entries' work would hold the next card
    until the last one finished: the passes let the cards work at
    once."""
    inputs = [send(e) for e in entries]
    outs = [work(e, x) for e, x in zip(entries, inputs)]
    return [None if out is None else tuple(t.to(home) for t in out)
            for out in outs]


def _over_entries(entries, send, work, home, n_shards: int,
                  n_blocks: int):
    """``parts[d][s]``, the partial states of the mesh entries on
    ``home`` (``three_passes``; ``work`` gives the write, and (m, l, o),
    or None for a replica)."""
    parts = [[None] * n_shards for _ in range(n_blocks)]
    for (_, s, d, _), out in zip(entries,
                                 three_passes(entries, send, work, home)):
        if out is not None:
            parts[d][s] = out
    return parts


def _merge(parts) -> torch.Tensor:
    """The aggregator merge of ``parts[d][s] = (m, l, o)`` ((B_blk, H),
    (B_blk, H), (B_blk, H, ·) f32 on one device): per data block across
    shards the global max, then the rescaled sums in shard order, o_g /
    max(l_g, 1e-30); the blocks joined in data order."""
    outs = []
    for blk in parts:
        m = torch.stack([x[0] for x in blk])
        corr = torch.exp(m - m.amax(dim=0))
        l_g = blk[0][1] * corr[0]
        o_g = blk[0][2] * corr[0][..., None]
        for s in range(1, len(blk)):
            l_g = l_g + blk[s][1] * corr[s]
            o_g = o_g + blk[s][2] * corr[s][..., None]
        outs.append(o_g / torch.clamp(l_g, min=1e-30)[..., None])
    return torch.cat(outs)


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
    b = q.shape[0]
    (ck, cv), entries, n_shards, n_blocks = _entries(
        (cache_k, cache_v), b, mesh, axis, batch_axis)
    bl, s_loc = b // n_blocks, ck.shape[1] // n_shards
    q0 = q[:, 0].to(torch.float32)

    def send(e):
        i, _, d, replica = e
        dev, rows = mesh.devices[i], slice(d * bl, (d + 1) * bl)
        return (pos[rows].to(dev), k_new[rows, 0].to(dev),
                v_new[rows, 0].to(dev),
                None if replica else q0[rows].to(dev))

    def work(e, x):
        i, s, _, replica = e
        p, kn, vn, qd = x
        pk, pv = ck.pieces[i], cv.pieces[i]
        _write((pk, pv), (kn, vn), p, s * s_loc)
        if replica:
            return None                       # written only
        lo, hi, live = chunk_range(p, s * s_loc, s_loc, window)
        # a dead row reads its chunk's first key, not the whole chunk
        part = decode_partials(qd, pk, pv, torch.where(live, lo, 0),
                               torch.where(live, hi, 1),
                               use_kernel=use_kernel)
        return _dead_to_identity(live, *part)

    parts = _over_entries(entries, send, work, q.device, n_shards,
                          n_blocks)
    out = _merge(parts).to(q.dtype)
    return out[:, None], ck, cv


def _mla_partials(q, piece, hi, kv_rank: int, scale: float):
    """(m, l, o) in f32 of one latent piece (B_blk, S_loc, R): the scores
    of q = (q_abs, q_rope) (B_blk, H, R) against the piece cast to f32,
    times ``scale``, masked at chunk positions >= ``hi``; their row max,
    the sum of their exp, and the exp times the piece's ``c`` half
    (B_blk, H, kv_rank)."""
    f = piece.to(torch.float32)
    scores = torch.einsum("bhr,btr->bht", q, f) * scale
    t = torch.arange(piece.shape[1], dtype=torch.int32, device=piece.device)
    scores = torch.where((t[None, :] < hi[:, None])[:, None, :], scores,
                         _NEG)
    m = scores.amax(dim=-1)
    e = torch.exp(scores - m[..., None])
    return m, e.sum(dim=-1), torch.einsum("bht,btr->bhr", e,
                                          f[..., :kv_rank])


def sharded_mla_decode(q_abs, q_rope, cache_latent, lat_new, pos, mesh,
                       kv_rank: int, scale: float, axis: str = "model",
                       batch_axis: Optional[str] = "data"):
    """One absorbed MLA decode step against a sequence-sharded latent
    cache.

    q_abs: (B, 1, H, kv_rank) and q_rope: (B, 1, H, rope_dim) on the home
    device; cache_latent: (B, S, kv_rank + rope_dim) in pieces
    (``Placed``) or whole, S a multiple of the axis size; lat_new: (B, 1,
    kv_rank + rope_dim), the token's c_kv beside its roped k_rope; pos:
    (B,) current lengths; ``scale``: (nope + rope)^-0.5.  On each entry's
    device, the owner-or-old write of lat_new at ``pos - start``, then
    the piece's partial state over each row's live range (MLA has no
    window: the whole prefix), a row with none the merge identity; the
    partials copied to the home device once per entry, merged per data
    block in shard order.  Returns (o_lat (B, 1, H, kv_rank) f32 on the
    home device, the latent as ``Placed``)."""
    b = q_abs.shape[0]
    (cl,), entries, n_shards, n_blocks = _entries(
        (cache_latent,), b, mesh, axis, batch_axis)
    bl, s_loc = b // n_blocks, cl.shape[1] // n_shards
    q = torch.cat([q_abs[:, 0], q_rope[:, 0]], dim=-1).to(torch.float32)

    def send(e):
        i, _, d, replica = e
        dev, rows = mesh.devices[i], slice(d * bl, (d + 1) * bl)
        return (pos[rows].to(dev), lat_new[rows, 0].to(dev),
                None if replica else q[rows].to(dev))

    def work(e, x):
        i, s, _, replica = e
        p, new, qd = x
        piece = cl.pieces[i]
        _write((piece,), (new,), p, s * s_loc)
        if replica:
            return None                       # written only
        _, hi, live = chunk_range(p, s * s_loc, s_loc)
        return _dead_to_identity(
            live, *_mla_partials(qd, piece, hi, kv_rank, scale))

    parts = _over_entries(entries, send, work, q_abs.device, n_shards,
                          n_blocks)
    return _merge(parts)[:, None], cl


def _state_entries(state: Placed):
    """A placed state's mesh entries as (index, its block's slices,
    whether it is the block's first entry), in entry order."""
    first = {entries[0] for entries in blocks(state)}
    return [(i, shard_slices(state.shape, state.spec, state.mesh, i),
             i in first) for i in np.ndindex(state.pieces.shape)]


def _join(outs, entries, shape, home, where) -> torch.Tensor:
    """The outputs of a state's blocks (``three_passes``' first entries)
    joined on ``home``: each added at ``where(slices)`` of f32 zeros of
    ``shape``, in entry order (a block whose piece splits the summed
    dimension adds its partial product)."""
    out = torch.zeros(shape, dtype=torch.float32, device=home)
    for (_, sl, _), o in zip(entries, outs):
        if o is not None:
            out[where(sl)] += o[0]
    return out


def placed_wkv_step(r, k, v, w, u, S: Placed):
    """One step of RWKV6's WKV recurrence (``layers.rwkv_time_mix``'s
    loop body) on a state in pieces, each piece updated on its card.

    r, v: (B, H, 1, dh), k, w: (B, H, dh, 1) f32 on the home device, u:
    (1, H, dh, 1); S: (B, H, dh, dh) f32, ``Placed`` (``cache_pspecs``:
    batch blocks over ``data``).  Each entry gets its block's rows and
    heads of r, k, v, w and u (its columns of them where the block
    splits a head dimension), copied there once; there ``kv = k v``,
    ``y = r (S + u kv)`` and ``S' = w S + kv`` on its piece, the whole
    update's arithmetic on a slice.  Every replica of a block updates
    its own piece; the first's y comes home, and the blocks' y are
    joined in entry order (``three_passes``).  Returns (y (B, H, 1, dh)
    on r's device, S' placed as S)."""
    entries = _state_entries(S)
    new = np.empty(S.pieces.shape, dtype=object)

    def send(e):
        i, (rows, heads, ks, vs), _ = e
        dev = S.pieces[i].device
        return tuple(t.to(dev) for t in (
            r[rows, heads, :, ks], k[rows, heads, ks], v[rows, heads, :, vs],
            w[rows, heads, ks], u[:, heads, ks]))

    def work(e, x):
        i, _, first = e
        rp, kp, vp, wp, up = x
        piece = S.pieces[i]
        kv = kp * vp
        y = rp @ torch.addcmul(piece, up, kv)
        new[i] = torch.addcmul(kv, wp, piece)
        return (y,) if first else None

    outs = three_passes(entries, send, work, r.device)
    y = _join(outs, entries, (S.shape[0], S.shape[1], 1, S.shape[3]),
              r.device, lambda sl: (sl[0], sl[1], slice(None), sl[3]))
    return y, Placed(S.sharding, S.shape, S.dtype, new)


def _own_piece(x, sl, dev) -> Optional[torch.Tensor]:
    """The piece of a ``Placed`` ``x`` that holds exactly the block ``sl``
    on ``dev``, or None (a tensor, or no such piece there)."""
    if isinstance(x, Placed):
        for j in np.ndindex(x.pieces.shape):
            if (shard_slices(x.shape, x.spec, x.mesh, j) == tuple(sl)
                    and canonical_device(x.pieces[j].device)
                    == canonical_device(dev)):
                return x.pieces[j]
    return None


def placed_ssm_step(dt, xi, log_a, bmat, cmat, state: Placed):
    """One decode step of hymba's SSM branch (``layers.ssm_forward`` at S
    = 1) on a state in pieces, each piece updated on its card.

    dt, xi: (B, di) f32 and bmat, cmat: (B, n) f32 on the home device;
    ``log_a`` (di, n), whole or ``Placed``; state: (B, di, n) f32,
    ``Placed`` (``cache_pspecs``: channel pieces over ``model``, batch
    blocks over ``data``).  Each entry gets its block's rows and channels
    of dt and xi, its rows of B and C (its state columns of them) and its
    channels of ``log_a`` -- the entry's own piece where ``log_a`` is
    placed with that block on the entry's card (params in pieces on the
    same cards), else a slice of the whole leaf, gathered once a call
    -- and computes ``h = exp(dt log_a) * state + (dt xi) B`` and ``y = h
    · C`` there, the whole update's arithmetic on a slice.  Every
    replica updates its own piece; the first's y comes home, joined in
    entry order.  Returns (y (B, di) f32 on dt's device, the new state
    placed as ``state``)."""
    home = dt.device
    entries = _state_entries(state)
    new = np.empty(state.pieces.shape, dtype=object)
    whole_a = []

    def log_a_block(sl, dev):
        own = _own_piece(log_a, sl, dev)
        if own is not None:
            return own
        if not whole_a:
            whole_a.append(gather(log_a, home)
                           if isinstance(log_a, Placed) else log_a)
        return whole_a[0][sl].to(dev)

    def send(e):
        i, (rows, chans, ns), _ = e
        dev = state.pieces[i].device
        return (dt[rows, chans].to(dev), xi[rows, chans].to(dev),
                log_a_block((chans, ns), dev), bmat[rows, ns].to(dev),
                cmat[rows, ns].to(dev))

    def work(e, x):
        i, _, first = e
        dtp, xip, lap, bp, cp = x
        a = (dtp[..., None] * lap.to(torch.float32)).exp_()
        h = a * state.pieces[i] + (dtp * xip)[..., None] * bp[:, None, :]
        new[i] = h
        if not first:
            return None
        return (torch.einsum("bsdn,bsn->bsd", h[:, None], cp[:, None])[:, 0],)

    outs = three_passes(entries, send, work, home)
    y = _join(outs, entries, tuple(state.shape[:2]), home,
              lambda sl: (sl[0], sl[1]))
    return y, Placed(state.sharding, state.shape, state.dtype, new)


def _parts(src):
    """A write's source as (tensor, its slices in region coordinates):
    a tensor whole; a ``Placed`` leaf block by block, each from its
    first entry."""
    if not isinstance(src, Placed):
        return [(src, tuple(slice(0, n) for n in src.shape))]
    return [(src.pieces[entries[0]],
             shard_slices(src.shape, src.spec, src.mesh, entries[0]))
            for entries in blocks(src)]


def write_region(dst, src, index) -> None:
    """Write ``src`` into the region ``index`` of ``dst`` in place.

    ``dst``: a tensor or a ``Placed`` leaf (a decode state's); ``index``:
    one ``slice`` per leading dimension (``sharding.region_pieces``);
    ``src``: a tensor or a ``Placed`` holding the region's elements from
    its origin (cut where it is larger than the region), or None for
    zeros.  Every entry of ``dst`` whose block meets the region, replicas
    included, gets the part it holds, cast to its dtype, in the passes of
    ``three_passes``: every part copied to its entry's card (a part
    already there is read in place), then every entry's writes; nothing
    comes home."""
    parts = [] if src is None else _parts(src)
    targets = region_pieces(dst, index)

    def piece(entry):
        return dst if entry is None else dst.pieces[entry]

    def send(e):
        entry, piece_sl, region_sl = e
        dev = piece(entry).device
        out = []
        for t, sl in parts:
            lo = [max(r.start, s.start) for r, s in zip(region_sl, sl)]
            hi = [min(r.stop, s.stop) for r, s in zip(region_sl, sl)]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            at = tuple(slice(p.start + a - r.start, p.start + b - r.start)
                       for p, r, a, b in zip(piece_sl, region_sl, lo, hi))
            out.append((at, t[tuple(slice(a - s.start, b - s.start)
                                    for s, a, b in zip(sl, lo, hi))]
                        .to(dev)))
        return out

    def work(e, copies):
        target = piece(e[0])
        if src is None:
            target[e[1]].zero_()
        for at, t in copies:
            target[at].copy_(t)
        return None

    three_passes(targets, send, work, None)
