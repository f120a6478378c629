"""Layer primitives of every model family, in PyTorch.

The same functions as ``repro/models/layers.py``, on tensors:

  * params are plain dicts of tensors (one dict per layer; the JAX
    package stacks layers on a leading L axis for its scan, PyTorch runs
    a Python loop over them);
  * activations (B, S, D); attention heads (B, S, H, Dh);
  * prefill attention is *chunked* (flash-style online softmax over KV
    tiles, plain torch, as the reference's is plain jnp); decode
    attention goes through ``kernels.flash_decode.decode_partials`` over
    the live cache range (once per mesh entry, on its piece of the
    cache, under an active mesh: ``models.sharded_decode``), the SSM
    prefill (and training forward, with its backward) through
    ``kernels.chunked_scan.linear_scan``;
  * MLA (minicpm3) prefill expands K/V per head into the same chunked
    attention; its decode is absorbed attention over the latent cache,
    plain torch ops as in the reference (no Pallas call there), on each
    sequence piece of the latent under an active mesh
    (``models.sharded_decode``);
  * MoE (qwen2-moe, dbrx) routes with the reference's sort-based,
    capacity-bounded dispatch; the grouped expert products are plain
    batched matmuls and the combine sums each token's contributions in
    a fixed order (no float atomics);
  * weights in pieces (``Placed`` leaves of a tree placed by
    ``param_pspecs``): ``gqa_forward`` runs card k's head group on card
    k (its cache in KV-head pieces) where the entries divide the KV
    heads, ``moe_forward`` each card's experts on their card, and every
    other projection of every family -- GQA whose KV heads the entries
    do not divide, MLA, hymba's SSM branch, RWKV6's mixes, the audio
    encoder, cross-attention and GELU MLP, SwiGLU -- reads its column
    or row pieces where they lie (``models.tensor_parallel``'s product
    route), while the recurrences and attention run on x's card;
  * ``layer_norm`` and the biased tanh-GELU MLP (the audio family);
  * RWKV6's time mix runs the WKV recurrence as a Python loop over time
    in float32 (the reference's sequential ``lax.scan``, no Pallas call
    there): the projections and decays of every step are batched
    products before the loop, so a step is four launches.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import runtime
from ..distributed.sharding import NamedSharding, Placed, device_put, gather
from ..kernels.chunked_scan import linear_scan
from ..kernels.flash_decode import decode_partials, finalize_partials
from . import tensor_parallel as tp
from .sharded_decode import (placed_ssm_step, placed_wkv_step,
                             sharded_decode_attention, sharded_mla_decode)

__all__ = ["rms_norm", "swiglu", "rope_tables", "apply_rope",
           "chunked_attention", "init_gqa", "gqa_forward", "init_ssm",
           "ssm_forward", "layer_norm", "gelu_mlp", "init_mla",
           "mla_forward", "init_moe", "moe_route",
           "moe_capacity", "BlockRouting", "block_routes", "moe_dispatch",
           "moe_forward", "init_rwkv",
           "rwkv_time_mix", "rwkv_channel_mix", "normal_init"]

Params = Dict[str, Any]

_NEG = -1e30


def normal_init(shape, scale: float, generator: torch.Generator, dtype,
                device) -> torch.Tensor:
    """N(0, 1) float32 draws from ``generator``, scaled, cast to dtype."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# norms / activations / rope
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def _silu_gate(x, g, u):
    return F.silu(g.to(torch.float32)).to(x.dtype) * u


def swiglu(x, w_gate, w_up, w_down):
    """``silu(x W_gate) * (x W_up)`` through ``W_down``.  Weights in pieces
    split by column (gate, up) and by row (down) over the same cards run
    there, the partial products summed on x's card in entry order
    (``tp.column_row``)."""
    return tp.column_row(x, (w_gate, w_up), w_down,
                         lambda g, u: _silu_gate(g, g, u))


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def gelu_mlp(x, w_up, b_up, w_down, b_down):
    """``jax.nn.gelu`` defaults to the tanh approximation (``F.gelu`` to
    the exact erf form), in float32.  Weights in pieces: ``w_up`` by
    column and ``w_down`` by row, card k adding its slice of ``b_up``
    (``tp.column_row``); ``b_down`` added on x's card."""
    def act(h):
        return F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)

    y = tp.column_row(x, (w_up,), w_down, act, biases=(b_up,))
    return y + tp.on(b_down, x.device)


def rope_tables(positions: torch.Tensor, dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given positions: (..., dim/2) float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (S, D/2) or (B, S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# chunked (flash-style) attention — plain torch
# ---------------------------------------------------------------------------


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool = True, window: int = 0,
                      chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV tiles (the prefill; non-causal
    for the audio encoder and cross-attention), float32 accumulators.

    q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) with Hq = G * Hkv (query head
    h reads KV head h // G).  ``window`` > 0 masks keys ``window`` or more
    positions older than the query (SWA).  Never holds more than
    (B, Hq, Sq, chunk) scores.  Without ``causal`` nothing masks the zero
    keys that pad the last chunk, as in the reference: each adds
    exp(-m) to the softmax's denominator (whisper-tiny's 1,500 frames
    in chunks of 1,024 carry 548).  (The reference's ``kv_len``/``kv_min``
    decode masks live in ``flash_decode.decode_partials``'s [lo, hi).)
    """
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    chunk = min(chunk, sk)
    dev = q.device
    qg = q.reshape(b, sq, hkv, g, d).to(torch.float32)
    scale = d ** -0.5
    q_pos = torch.arange(sq, dtype=torch.int32, device=dev)

    m_acc = torch.full((b, hkv, g, sq), _NEG, dtype=torch.float32,
                       device=dev)
    l_acc = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    o_acc = torch.zeros((b, hkv, g, sq, dv), dtype=torch.float32, device=dev)
    for c0 in range(0, sk, chunk):
        kb = k[:, c0:c0 + chunk].to(torch.float32)
        vb = v[:, c0:c0 + chunk].to(torch.float32)
        c = kb.shape[1]
        if c < chunk:                    # the reference pads with zeros
            kb = F.pad(kb, (0, 0, 0, 0, 0, chunk - c))
            vb = F.pad(vb, (0, 0, 0, 0, 0, chunk - c))
        s = torch.einsum("bskgd,bckd->bkgsc", qg, kb) * scale
        if causal or window:
            k_pos = c0 + torch.arange(chunk, dtype=torch.int32, device=dev)
            msk = torch.ones((sq, chunk), dtype=torch.bool, device=dev)
            if causal:
                msk &= q_pos[:, None] >= k_pos[None, :]
            if window:
                msk &= q_pos[:, None] - k_pos[None, :] < window
            s = torch.where(msk[None, None, None], s, _NEG)

        m_new = torch.maximum(m_acc, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_acc - m_new)
        l_acc = l_acc * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgsc,bckd->bkgsd", p, vb)
        o_acc = o_acc * corr[..., None] + pv
        m_acc = m_new
    out = o_acc / torch.clamp(l_acc, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dv)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------


def _decode_mesh(cache_k):
    """Active mesh for the sequence-sharded decode path — only when the
    cache's sequence axis divides the decode axis size.  The mesh's
    entries may be distinct devices: the cache is then held in pieces,
    one on each entry's device (``sharded_decode``)."""
    mesh = runtime.decode_mesh()
    if mesh is None or cache_k.shape[1] % mesh.shape[runtime.decode_axis()]:
        return None
    return mesh


def init_gqa(generator: torch.Generator, cfg, dtype, device) -> Params:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = d ** -0.5
    shapes = (("wq", (d, hq * dh)), ("wk", (d, hkv * dh)),
              ("wv", (d, hkv * dh)), ("wo", (hq * dh, d)))
    p = {name: normal_init(shape, s, generator, dtype, device)
         for name, shape in shapes}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((dh,), dtype=dtype, device=device)
    return p


def gqa_forward(p: Params, x: torch.Tensor, cfg, *, positions,
                cache: Optional[Dict] = None, window: int = 0,
                chunk: int = 1024, use_kernel: Optional[bool] = None):
    """Full-sequence prefill or cached single-step decode.

    cache: {"k": (B, Smax, Hkv, Dh), "v": ..., "len": (B,)} or None.
    Returns (out, new_cache).  Prefill (cache None) returns this
    sequence's roped k and v as {"k", "v"} (the reference's
    ``forward_prefill`` computes them a second time for the cache).
    Decode writes k/v at ``len`` into the cache **in place** (the
    reference returns updated copies) and runs
    ``flash_decode.decode_partials`` over the live range
    [max(len + 1 - window, 0), len + 1); under an active mesh
    (``distributed.runtime``) whose decode axis divides the cache length,
    once per mesh entry on the entry's piece of the cache, merged by
    ``sharded_decode.sharded_decode_attention`` (the cache comes back in
    pieces, ``distributed.sharding.Placed``).  A cache in pieces with no
    such mesh is gathered whole onto q's device first.

    Weights in pieces (``Placed``): where ``wq|wk|wv`` are split by column
    and ``wo`` by row over the same n cards and n divides the KV heads,
    the head route (``_gqa_heads``) runs card k's head group on card k,
    whatever mesh is active.  Otherwise (hymba-1.5b's 5 KV heads on four
    entries) the product route: q/k/v by column, concatenated on x's
    card (``tp.columns``), attention there over a whole cache, ``wo`` by
    row (``tp.matmul``).
    """
    if any(isinstance(t, Placed) for t in p.values()):
        mesh = tp.head_mesh(cfg, p)
        if mesh is not None:
            return _gqa_heads(p, x, cfg, mesh, positions=positions,
                              cache=cache, window=window, chunk=chunk,
                              use_kernel=use_kernel)
    b, s, _ = x.shape
    hq, dh = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(x, p["wq"], p["wk"], p["wv"], p.get("q_norm"),
                   p.get("k_norm"), cfg, positions)

    if cache is None:
        out = chunked_attention(q, k, v, window=window, chunk=chunk)
        new_cache = {"k": k, "v": v}
    else:
        if s != 1:
            raise ValueError(f"cached decode takes one token, got {s}")
        pos = cache["len"]                                    # (B,)
        ck, cv = cache["k"], cache["v"]
        mesh = _decode_mesh(ck)
        if mesh is not None:
            # sequence-sharded cache: partial-softmax shard merge
            # (pre-aggregation at the model layer — DESIGN.md §2)
            out, ck, cv = sharded_decode_attention(
                q, ck, cv, k, v, pos, mesh, axis=runtime.decode_axis(),
                window=window, use_kernel=use_kernel)
        else:
            if isinstance(ck, Placed):
                ck, cv = gather((ck, cv), q.device)
            out = _cached_attention(q, k, v, ck, cv, pos, window,
                                    use_kernel)
        new_cache = {"k": ck, "v": cv, "len": pos + 1}
    y = tp.matmul(out.reshape(b, s, hq * dh), p["wo"])
    return y, new_cache


def _qkv(x, wq, wk, wv, q_norm, k_norm, cfg, positions):
    """The roped q (B, S, ·, Dh) and k, and v, of x's heads through
    ``wq|wk|wv`` (the whole model's, one head group's, or column pieces:
    ``tp.columns``), behind the q/k norms where the config has them."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    q, k, v = (t.reshape(b, s, -1, dh) for t in tp.columns(x, (wq, wk, wv)))
    if cfg.qk_norm:
        q = rms_norm(q, tp.on(q_norm, x.device), cfg.norm_eps)
        k = rms_norm(k, tp.on(k_norm, x.device), cfg.norm_eps)
    cos, sin = rope_tables(positions, dh, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _cached_attention(q, k, v, ck, cv, pos, window: int,
                      use_kernel: Optional[bool]):
    """One decode token against a cache on q's device: the new k/v
    written at ``pos`` in place, one ``decode_partials`` over each row's
    live range [max(pos + 1 - window, 0), pos + 1), finalized."""
    rows = torch.arange(q.shape[0], device=ck.device)
    ck[rows, pos.long()] = k[:, 0].to(ck.dtype)
    cv[rows, pos.long()] = v[:, 0].to(cv.dtype)
    hi = (pos + 1).to(torch.int32)
    lo = (torch.clamp(hi - window, min=0) if window
          else torch.zeros_like(hi))
    part = decode_partials(q[:, 0], ck, cv, lo, hi, use_kernel=use_kernel)
    return finalize_partials(*part).to(q.dtype)[:, None]


def _gqa_heads(p: Params, x: torch.Tensor, cfg, mesh, *, positions,
               cache: Optional[Dict], window: int, chunk: int,
               use_kernel: Optional[bool]):
    """``gqa_forward`` on weights in pieces, head group by head group.

    Card k (the k-th entry of ``mesh`` along ``model``) holds q heads
    [k Hq/n, (k+1) Hq/n) of ``wq`` and the KV heads [k Hkv/n, (k+1)
    Hkv/n) of ``wk|wv`` they read (groups never straddle cards: n
    divides Hkv), and the matching rows of ``wo``.  x, the positions
    (and a decode's lengths) are copied once to each card, every card's
    before any card's work; there the group's q/k/v, norms and rope,
    then its
    attention: the chunked prefill, or the decode's in-place write at
    ``len`` and one ``decode_partials`` over the group's piece of the
    cache.  The ``wo`` partial products are summed on x's card in entry
    order.  The cache is held in KV-head pieces (``tp.HEAD_SPEC`` on
    ``mesh``): prefill returns the group's K/V as one; a decode cache in
    another layout (whole, or the sequence pieces of ``cache_pspecs``)
    is placed so at the first step and comes back in head pieces."""
    b, s, _ = x.shape
    dev0 = x.device
    wq, wk, wv, wo = tp.split([p["wq"], p["wk"], p["wv"], p["wo"]],
                              (1, 1, 1, 0))
    hq, dh = cfg.n_heads // len(wq), cfg.head_dim
    devs = [w.device for w in wq]
    if cache is not None:
        if s != 1:
            raise ValueError(f"cached decode takes one token, got {s}")
        sharding = NamedSharding(mesh, tp.HEAD_SPEC)
        ck, cv = device_put((cache["k"], cache["v"]), (sharding, sharding))
        pos = cache["len"]
        cks, cvs = tp.split([ck, cv], (2, 2))
    # every card's inputs copied before any card's work: a copy between
    # two cards makes each wait for the other's earlier work, so a copy
    # made inside the loop would hold card k until card k - 1 finished
    xs = tp.spread(x, devs)
    ps = [positions.to(dev) for dev in devs]
    lens = None if cache is None else [pos.to(dev) for dev in devs]
    norms = [p.get(k) for k in ("q_norm", "k_norm")]
    parts, new_k, new_v = [], [], []
    for i, dev in enumerate(devs):
        q, k, v = _qkv(xs[i], wq[i], wk[i], wv[i],
                       *(None if t is None else tp.on(t, dev)
                         for t in norms), cfg, ps[i])
        if cache is None:
            out = chunked_attention(q, k, v, window=window, chunk=chunk)
            new_k.append(k)
            new_v.append(v)
        else:
            out = _cached_attention(q, k, v, cks[i], cvs[i], lens[i],
                                    window, use_kernel)
        parts.append(out.reshape(b, s, hq * dh) @ wo[i])
    y = tp.row_sum(parts, dev0, x.dtype)
    if cache is not None:
        return y, {"k": ck, "v": cv, "len": pos + 1}
    shape = (b, s, cfg.n_kv_heads, dh)
    return y, {"k": tp.placed_along(mesh, tp.HEAD_SPEC, shape, x.dtype,
                                    new_k),
               "v": tp.placed_along(mesh, tp.HEAD_SPEC, shape, x.dtype,
                                    new_v)}


# ---------------------------------------------------------------------------
# MLA attention (MiniCPM3 / DeepSeek-style latent attention)
# ---------------------------------------------------------------------------


def init_mla(generator: torch.Generator, cfg, dtype, device) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    s = d ** -0.5
    shapes = (("q_down", (d, m.q_rank), s),
              ("q_up", (m.q_rank, h * (m.nope_dim + m.rope_dim)),
               m.q_rank ** -0.5),
              ("kv_down", (d, m.kv_rank + m.rope_dim), s),
              ("k_up", (m.kv_rank, h * m.nope_dim), m.kv_rank ** -0.5),
              ("v_up", (m.kv_rank, h * m.v_dim), m.kv_rank ** -0.5),
              ("wo", (h * m.v_dim, d), s))
    return {name: normal_init(shape, scale, generator, dtype, device)
            for name, shape, scale in shapes}


def mla_forward(p: Params, x: torch.Tensor, cfg, *, positions,
                cache: Optional[Dict] = None, chunk: int = 1024):
    """MLA: queries/keys split into nope + shared-rope parts; the cache
    keeps only the latent (kv_rank + rope_dim per position).

    Prefill (cache None) expands K/V per head (the rope half of K is one
    head, broadcast to all) through ``chunked_attention``, whose scale is
    (nope + rope)^-0.5 from q's last dim, and returns this sequence's
    {"latent"}.  Decode writes the latent at ``len`` into
    ``cache["latent"]`` (B, Smax, kv_rank + rope_dim) **in place** and
    runs *absorbed* attention against the whole latent cache: float32
    scores masked where t >= len + 1, a softmax, then ``v_up``, cast to
    x's dtype before ``wo`` -- plain torch ops, as the reference's plain
    jnp.  Under an active mesh (``distributed.runtime``) whose decode
    axis divides the cache length, the latent is read and written in its
    sequence pieces instead, each on its entry's device, and the pieces'
    partial states merged on x's card
    (``sharded_decode.sharded_mla_decode``; the latent comes back as
    ``Placed``).  A latent in pieces with no such mesh is gathered whole
    onto x's device first.

    Weights in pieces: ``q_down`` and ``kv_down`` (replicated) read on
    x's card, ``q_up|k_up|v_up`` by column and ``wo`` by row
    (``tp.matmul``); the absorbed decode reads ``k_up`` / ``v_up`` head
    group by head group on their cards (``tp.by_head``).
    """
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = m.nope_dim, m.rope_dim, m.v_dim
    f32 = torch.float32

    q = tp.matmul(tp.matmul(x, p["q_down"]), p["q_up"]).reshape(
        b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    latent = tp.matmul(x, p["kv_down"])
    c_kv = latent[..., :m.kv_rank]
    cos, sin = rope_tables(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(latent[:, :, None, m.kv_rank:], cos, sin)[:, :, 0]
    # what the cache keeps per position: c_kv beside the roped k_rope
    lat = torch.cat([c_kv, k_rope], dim=-1)

    if cache is None:
        k_nope, v = tp.columns(c_kv, (p["k_up"], p["v_up"]))
        k_nope = k_nope.reshape(b, s, h, dn)
        v = v.reshape(b, s, h, dv)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)],
                      dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        out = chunked_attention(qq, k, v, chunk=chunk)
        y = tp.matmul(out.reshape(b, s, h * dv), p["wo"])
        return y, {"latent": lat}

    if s != 1:
        raise ValueError(f"cached decode takes one token, got {s}")
    pos = cache["len"]                                        # (B,)
    cl = cache["latent"]
    q_abs = tp.by_head(lambda qn, w: torch.einsum(
        "bshn,rhn->bshr", qn, w.to(f32)), q_nope.to(f32), p["k_up"], h)
    mesh = _decode_mesh(cl)
    if mesh is not None:
        # the latent in sequence pieces, each read and written on its card
        o_lat, cl = sharded_mla_decode(
            q_abs, q_rope, cl, lat, pos, mesh, m.kv_rank,
            (dn + dr) ** -0.5, axis=runtime.decode_axis())
    else:
        if isinstance(cl, Placed):
            cl = gather(cl, x.device)
        rows = torch.arange(b, device=cl.device)
        cl[rows, pos.long()] = lat[:, 0].to(cl.dtype)
        c_cache = cl[..., :m.kv_rank].to(f32)
        r_cache = cl[..., m.kv_rank:].to(f32)
        scores = torch.einsum("bshr,btr->bhst", q_abs, c_cache)
        scores = scores + torch.einsum("bshr,btr->bhst", q_rope.to(f32),
                                       r_cache)
        scores = scores * (dn + dr) ** -0.5
        t_pos = torch.arange(cl.shape[1], dtype=torch.int32,
                             device=cl.device)
        live = t_pos[None, :] < (pos + 1)[:, None]
        scores = torch.where(live[:, None, None, :], scores, _NEG)
        pattn = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bhst,btr->bshr", pattn, c_cache)
    out = tp.by_head(lambda o, w: torch.einsum(
        "bshr,rhv->bshv", o, w.to(f32)), o_lat, p["v_up"], h)
    y = tp.matmul(out.reshape(b, s, h * dv).to(x.dtype), p["wo"])
    return y, {"latent": cl, "len": pos + 1}


# ---------------------------------------------------------------------------
# MoE FFN (sort-based grouped dispatch, static shapes)
# ---------------------------------------------------------------------------


def init_moe(generator: torch.Generator, cfg, dtype, device) -> Params:
    e = cfg.moe
    d, ep, f = cfg.d_model, e.n_experts_padded, e.d_expert
    s = d ** -0.5
    shapes = [("router", (d, ep), s), ("w_gate", (ep, d, f), s),
              ("w_up", (ep, d, f), s), ("w_down", (ep, f, d), f ** -0.5)]
    if e.n_shared:
        f_sh = e.n_shared * f
        shapes += [("shared_gate", (d, f_sh), s), ("shared_up", (d, f_sh), s),
                   ("shared_down", (f_sh, d), f_sh ** -0.5)]
    return {name: normal_init(shape, scale, generator, dtype, device)
            for name, shape, scale in shapes}


def moe_route(p: Params, xf: torch.Tensor, cfg):
    """Top-k routing of (n, d) tokens: float32 router logits (padded
    experts at -1e30, never routed), the k largest in descending order,
    and a softmax over the k.  Returns (weights (n, k) float32, experts
    (n, k) int64).

    ``lax.top_k`` breaks a tie toward the lower expert index;
    ``torch.topk`` does not (it returned 39, 40, 41, 38 for 64 equal
    logits on the CPU), so the k come from a stable descending sort."""
    e = cfg.moe
    ep = e.n_experts_padded
    logits = xf.to(torch.float32) @ p["router"].to(torch.float32)
    if ep > e.n_experts:
        pad = torch.arange(ep, device=xf.device) >= e.n_experts
        logits = torch.where(pad[None, :], _NEG, logits)
    top_w, top_i = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :e.top_k], top_i[:, :e.top_k]
    return torch.softmax(top_w, dim=-1), top_i


def moe_capacity(moe, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` routed tokens: ceil(n k /
    n_experts * capacity_factor), from the unpadded expert count.
    qwen2-moe-a2.7b: 683 at a prefill of 8 x 1,024 tokens, 1 at a decode
    of 8 (where tokens are dropped, as in the reference)."""
    return int(math.ceil(n_tokens * moe.top_k / moe.n_experts
                         * moe.capacity_factor))


@dataclasses.dataclass
class BlockRouting:
    """One MoE layer's view of the microbatch whose data block it routes
    (``train.steps``' data-parallel blocks, run one after another in data
    order): ``n_tokens``, the microbatch's routed tokens, sizes the
    capacity; ``before``, an (ep,) int32 tensor on the block's card, counts
    each expert's (token, expert) pairs in the earlier blocks (None for
    the first block).  The layer's first forward sets ``through`` =
    ``before`` + this block's counts, what the next block reads; the
    backward's recompute of the layer (remat) reads ``before`` again and
    leaves ``through`` as it is."""

    n_tokens: int
    before: Optional[torch.Tensor] = None
    through: Optional[torch.Tensor] = None


def block_routes(cfg, n_blocks: int, n_tokens: int, dev, previous=None):
    """Each layer's ``BlockRouting`` for the next of ``n_blocks`` blocks,
    run in order, of a batch of ``n_tokens`` routed tokens (a train
    step's microbatch, a prefill's batch) on ``dev``: None without MoE
    or with one block; per layer, the expert counts through the previous
    block (``previous``, None for the first) copied to ``dev``.  No host
    sync: the counts stay tensors."""
    if cfg.moe is None or n_blocks == 1:
        return None
    if previous is None:
        return [BlockRouting(n_tokens) for _ in range(cfg.n_layers)]
    return [BlockRouting(n_tokens, r.through.to(dev)) for r in previous]


def moe_dispatch(top_i: torch.Tensor, cfg, route: Optional[BlockRouting]
                 = None):
    """The capacity-bounded slots of (n, k) routed experts: the (token,
    expert) pairs sorted by expert (stable: token order within an
    expert), each ranked within its expert, and the first ``cap`` of each
    given slot ``expert * cap + rank`` of an (ep cap, d) buffer; a dropped
    pair gets ``ep * cap``.  ``cap = moe_capacity(moe, n)``, ``n`` the
    routed tokens, as in the reference's ``moe_forward``.

    With ``route`` (a data block of a microbatch) the rank is the one the
    pair has in the whole microbatch, in the reference's token order: the
    expert's pairs in the earlier blocks (``route.before``) plus its
    stable rank in this block, and ``cap`` is the microbatch's
    (``route.n_tokens``).  Returns (order, sorted experts (int32), sorted
    tokens, slots (int64), cap)."""
    e = cfg.moe
    n, k = top_i.shape
    ep, dev = e.n_experts_padded, top_i.device
    flat_expert = top_i.reshape(-1).to(torch.int32)            # (n k,)
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    st = torch.div(order, k, rounding_mode="floor")            # token
    grp_start = torch.searchsorted(
        se, torch.arange(ep, dtype=torch.int32, device=dev),
        side="left").to(torch.int32)
    rank = torch.arange(n * k, dtype=torch.int32, device=dev) \
        - grp_start[se.long()]
    cap = moe_capacity(e, n)
    if route is not None:
        cap = moe_capacity(e, route.n_tokens)
        if route.before is not None:
            rank = rank + route.before[se.long()]
        if route.through is None:
            counts = torch.diff(grp_start, append=torch.full(
                (1,), n * k, dtype=torch.int32, device=dev))
            route.through = counts if route.before is None \
                else route.before + counts
    slot = torch.where(rank < cap, se * cap + rank,
                       torch.full_like(rank, ep * cap)).long()
    return order, se, st, slot, cap


def moe_forward(p: Params, x: torch.Tensor, cfg,
                route: Optional[BlockRouting] = None) -> torch.Tensor:
    """Top-k routed experts via the reference's sort-based grouped matmul.

    (token, expert) pairs are sorted by expert (stable: token order within
    an expert), ranked within their expert, and the first ``cap`` of each
    take its slots of an (ep, cap, d) buffer, ``cap = ceil(n k / n_experts
    * capacity_factor)`` from the unpadded count (an over-capacity pair is
    dropped: it contributes nothing; ``moe_dispatch``).  The dispatch
    writes into an (ep cap + 1, d) buffer whose last row takes the dropped
    pairs and is cut off.  The grouped products are batched matmuls over
    experts.  The combine sums each token's k weighted contributions in
    ``x.dtype`` from zero, in the order of their sorted positions (the
    order of the reference's ``.at[].add`` scatter): gathers and adds
    only, no float atomics.

    ``route`` (a ``BlockRouting``): ``x`` is one data block of a
    microbatch, and the pairs are ranked and kept as in the whole
    microbatch (``moe_dispatch``).  The buffer has the microbatch's
    ``cap``, so each expert product has the whole step's shapes and a
    kept pair the slot it has there; the block's other slots are zeros.
    The router, a kept pair's products, the shared experts and the
    combine are per token.

    Experts in pieces (``w_gate|w_up|w_down`` split by ``model`` along the
    expert axis over the same n cards, n dividing ``n_experts_padded``):
    the routing, dispatch and combine run on x's card exactly as above;
    card k gets its experts' (E/n, cap, d) slice of the buffer, runs the
    three products there and sends its (E/n, cap, d) outputs back, joined
    in entry order.  Shared experts go through ``swiglu`` (column / row
    parallel in pieces).  Any other placement is gathered whole.
    """
    e = cfg.moe
    b, s, d = x.shape
    n = b * s
    ep, k = e.n_experts_padded, e.top_k
    xf = x.reshape(n, d)
    if any(isinstance(t, Placed) for t in p.values()):
        p = dict(p, router=tp.on(p["router"], x.device))
    top_w, top_i = moe_route(p, xf, cfg)
    order, se, st, slot, cap = moe_dispatch(top_i, cfg, route)
    sw = top_w.reshape(-1)[order]

    buf = torch.zeros((ep * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((slot,), xf[st])[:ep * cap]
    h = buf.reshape(ep, cap, d)
    experts = (p["w_gate"], p["w_up"], p["w_down"])
    ws = tp.split(experts, (0, 0, 0))
    if ws is None:
        y = _experts(h, *(tp.whole(w, x.device) for w in experts))
    else:
        per = ep // len(ws[0])
        hs = [h[i * per:(i + 1) * per].to(g.device)
              for i, g in enumerate(ws[0])]
        y = torch.cat([_experts(hk, g, u, dn).to(x.device)
                       for hk, g, u, dn in zip(hs, *ws)])
    y = y.reshape(ep * cap, d)

    # a dropped pair reads the zero row past the buffer
    y = torch.cat([y, torch.zeros((1, d), dtype=y.dtype, device=y.device)])
    contrib = y[slot] * sw[:, None].to(x.dtype)                 # (n k, d)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n * k, device=x.device)
    pos = torch.sort(inv.reshape(n, k), dim=1).values           # (n, k)
    parts = contrib[pos]                                        # (n, k, d)
    out = torch.zeros((n, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + parts[:, j]

    if e.n_shared:
        out = out + swiglu(xf, p["shared_gate"], p["shared_up"],
                           p["shared_down"])
    return out.reshape(b, s, d)


def _experts(h: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """The grouped SwiGLU of (E, cap, d) dispatched tokens through E
    experts' weights: three batched products."""
    act = _silu_gate(h, torch.bmm(h, w_gate), torch.bmm(h, w_up))
    return torch.bmm(act, w_down)


# ---------------------------------------------------------------------------
# RWKV6 (Finch) time mix + channel mix: data-dependent decay
# ---------------------------------------------------------------------------


def init_rwkv(generator: torch.Generator, cfg, dtype, device) -> Params:
    d, h, dh, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    s = d ** -0.5

    def normal(shape, scale):
        return normal_init(shape, scale, generator, dtype, device)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "wr": normal((d, d), s), "wk": normal((d, d), s),
        "wv": normal((d, d), s), "wg": normal((d, d), s),
        "ww": normal((d, d), s * 0.1),
        "w0": full((d,), -6.0),                       # base decay (slow)
        "u_bonus": normal((h, dh), 0.1),
        "wo": normal((d, d), s),
        "mu": full((5, d), 0.5),                      # token-shift lerp
        "cm_k": normal((d, f), s), "cm_v": normal((f, d), f ** -0.5),
        "cm_r": normal((d, d), s),
        "mu_cm": full((2, d), 0.5),
    }


def _shift_lerps(x: torch.Tensor, shift: torch.Tensor, mu: torch.Tensor):
    """x with the token before each position (``shift`` before the first)
    mixed in by each row of ``mu``, in float32, cast to x's dtype."""
    prev = torch.cat([shift[:, None].to(x.dtype), x[:, :-1]], dim=1)
    xs, ps = x.to(torch.float32), prev.to(torch.float32)
    mu = mu.to(torch.float32)
    return [(xs * m + ps * (1 - m)).to(x.dtype) for m in mu]


def rwkv_time_mix(p: Params, x: torch.Tensor, cfg, *,
                  state: Optional[Tuple] = None):
    """WKV6 recurrence.  state = (shift (B, d), S (B, H, dh, dh) float32).

        S_t = diag(w_t) S_{t-1} + k_t^T v_t
        y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

    r, k, v, g and the decay ``w = exp(-exp(w0 + mix @ ww))`` of every
    step are batched products; the loop over time (the reference's
    ``lax.scan``) keeps only the state update, in float32: the outer
    product, ``S + u kv``, r's product with it, and ``w S + kv`` -- four
    launches a step.  Returns (out, (x[:, -1], S_final)).  Weights in
    pieces: ``wr|wk|wv|wg|ww`` by column, ``wo`` by row (``tp.matmul``),
    ``mu|w0|u_bonus`` replicated; the loop runs on x's card.

    A state in pieces (``Placed``, ``model.decode_step`` under a decode
    mesh): ``shift`` is read whole on x's card; each step of ``S`` runs
    on the cards of its pieces (``sharded_decode.placed_wkv_step``), and
    S comes back placed as it came."""
    b, s, d = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    f32 = torch.float32
    if state is None:
        state = (torch.zeros((b, d), dtype=x.dtype, device=x.device),
                 torch.zeros((b, h, dh, dh), dtype=f32, device=x.device))
    shift, S = state
    dev = x.device
    if isinstance(shift, Placed):
        shift = gather(shift, dev)
    mr, mk, mv, mg, mw = _shift_lerps(x, shift, tp.on(p["mu"], dev))
    r = tp.matmul(mr, p["wr"]).to(f32).reshape(b, s, h, 1, dh)
    k = tp.matmul(mk, p["wk"]).to(f32).reshape(b, s, h, dh, 1)
    v = tp.matmul(mv, p["wv"]).to(f32).reshape(b, s, h, 1, dh)
    g = tp.matmul(mg, p["wg"])
    wlog = -torch.exp(tp.on(p["w0"], dev).to(f32)
                      + tp.matmul(mw, p["ww"]).to(f32))
    w = torch.exp(wlog).reshape(b, s, h, dh, 1)              # in (0, 1)
    u = tp.on(p["u_bonus"], dev).to(f32).reshape(1, h, dh, 1)

    ys = []
    for t in range(s):
        if isinstance(S, Placed):
            y_t, S = placed_wkv_step(r[:, t], k[:, t], v[:, t], w[:, t], u,
                                     S)
            ys.append(y_t)
            continue
        kv = k[:, t] * v[:, t]                                 # (B,H,dh,dh)
        ys.append(r[:, t] @ torch.addcmul(S, u, kv))           # (B,H,1,dh)
        S = torch.addcmul(kv, w[:, t], S)
    y = torch.cat(ys, dim=2).transpose(1, 2).reshape(b, s, d)
    y = y * F.silu(g.to(f32))
    return tp.matmul(y.to(x.dtype), p["wo"]), (x[:, -1], S)


def rwkv_channel_mix(p: Params, x: torch.Tensor, *,
                     shift: Optional[torch.Tensor] = None):
    """relu(k)^2 through ``cm_v`` under a sigmoid gate; returns (out,
    x[:, -1]), the latter the next call's ``shift``.  Weights in pieces:
    ``cm_k`` by column and ``cm_v`` by row, relu^2 on each card
    (``tp.column_row``), ``cm_r`` by column (``tp.matmul``).  A
    ``shift`` in pieces is read whole on x's card."""
    b, _, d = x.shape
    if shift is None:
        shift = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    elif isinstance(shift, Placed):
        shift = gather(shift, x.device)
    xk, xr = _shift_lerps(x, shift, tp.on(p["mu_cm"], x.device))

    def act(k):
        return torch.square(F.relu(k.to(torch.float32))).to(x.dtype)

    kv = tp.column_row(xk, (p["cm_k"],), p["cm_v"], act)
    r = torch.sigmoid(tp.matmul(xr, p["cm_r"]).to(torch.float32))
    return (r * kv.to(torch.float32)).to(x.dtype), x[:, -1]


# ---------------------------------------------------------------------------
# Mamba-lite SSM branch (hymba) — diagonal S6
# ---------------------------------------------------------------------------


def init_ssm(generator: torch.Generator, cfg, dtype, device) -> Params:
    sm = cfg.ssm
    d = cfg.d_model
    di = sm.expand * d
    n = sm.state_dim
    s = d ** -0.5
    log_a = -torch.exp(torch.randn((di, n), generator=generator,
                                   dtype=torch.float32, device=device) * 0.5)
    return {
        "in_proj": normal_init((d, 2 * di), s, generator, dtype, device),
        "w_dt": normal_init((di,), 0.1, generator, dtype, device),
        "b_dt": torch.full((di,), -4.0, dtype=dtype, device=device),
        "log_a": log_a.to(dtype),
        "w_b": normal_init((d, n), s, generator, dtype, device),
        "w_c": normal_init((d, n), s, generator, dtype, device),
        "d_skip": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": normal_init((di, d), di ** -0.5, generator, dtype,
                                device),
    }


def ssm_forward(p: Params, x: torch.Tensor, cfg, *,
                state: Optional[torch.Tensor] = None,
                use_kernel: Optional[bool] = None):
    """Diagonal selective-state-space branch.

    h_t (di, n):  h = a_t * h + dt_t * x_t ⊗ B_t ;  y = (h · C_t) + D*x.
    Prefill and training (S > 1): ``chunked_scan.linear_scan`` over
    (B, S, di·n) from a zero state, differentiable on both routes (its
    backward is the scan's own kernel or plain version; the in-place
    ``exp_`` writes a product whose backward saved only its inputs).
    Decode (S = 1): the one-step update on the carried state.  Returns
    (y (B, S, d), new_state (B, di, n) float32); training drops the
    state.

    Weights in pieces: ``in_proj`` by column (its ``[xi | z]`` halves
    joined in order on x's card), ``w_b|w_c`` and ``out_proj`` by row
    (``tp.matmul``; ``auto_pspec`` splits ``w_b|w_c`` along d at full
    width), ``w_dt|b_dt|d_skip`` replicated; ``log_a``, split along its
    channels and read elementwise, is gathered (``tp.on``); the scan runs
    on x's card.

    A decode state in pieces (``Placed``, ``model.decode_step`` under a
    decode mesh; ``cache_pspecs`` splits its channels over ``model``):
    each piece's update and its ``h · C`` run on the piece's card, the y
    pieces joined on x's card before ``d_skip``, the gate and
    ``out_proj`` (``sharded_decode.placed_ssm_step``; ``log_a``'s piece
    read in place where the params' pieces lie on the same cards), and
    the state comes back placed as it came.
    """
    sm = cfg.ssm
    b, s, _ = x.shape
    di, n = sm.expand * cfg.d_model, sm.state_dim
    f32 = torch.float32

    def leaf(name):
        return tp.on(p[name], x.device).to(f32)

    xz = tp.matmul(x, p["in_proj"])
    xi, z = xz[..., :di], xz[..., di:]
    dt = F.softplus(xi.to(f32) * leaf("w_dt") + leaf("b_dt"))
    x32 = x.to(f32)
    bmat, cmat = tp.columns(x32, (p["w_b"], p["w_c"]), dtype=f32)

    if s == 1 and isinstance(state, Placed):
        y, new_state = placed_ssm_step(dt[:, 0], xi[:, 0].to(f32),
                                       p["log_a"], bmat[:, 0], cmat[:, 0],
                                       state)
        y = y[:, None]
    else:
        a = (dt[..., None] * leaf("log_a")).exp_()           # (B,S,di,n)
        u = (dt * xi.to(f32))[..., None] * bmat[:, :, None, :]
        if s == 1:
            if state is None:
                state = torch.zeros((b, di, n), dtype=f32, device=x.device)
            h = a[:, 0] * state + u[:, 0]                      # (B, di, n)
            hs = h[:, None]
            new_state = h
        else:
            if state is not None:
                raise ValueError("the prefill scan starts from a zero state")
            hs = linear_scan(a.reshape(b, s, di * n),
                             u.reshape(b, s, di * n),
                             use_kernel=use_kernel).reshape(b, s, di, n)
            new_state = hs[:, -1].clone()
        del a, u
        y = torch.einsum("bsdn,bsn->bsd", hs, cmat)
    y = y + leaf("d_skip") * xi.to(f32)
    y = y * F.silu(z.to(f32))
    return tp.matmul(y.to(x.dtype), p["out_proj"]), new_state
