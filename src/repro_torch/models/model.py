"""Every model family of the JAX package, in PyTorch.

The same entry points as ``repro/models/model.py``: ``dense`` (llama3-8b,
qwen3-8b, granite-3-8b, and with MLA attention minicpm3-4b), ``hybrid``
(hymba-1.5b: parallel attention + SSM heads, sliding-window layers),
``moe`` (qwen2-moe-a2.7b, dbrx-132b), ``vlm`` (llava-next-34b: a dense
GQA decoder behind a prefix of precomputed patch embeddings), ``audio``
(whisper-tiny: a bidirectional encoder over precomputed frame
embeddings, a decoder with cross-attention, layer norms and a GELU MLP)
and ``ssm`` (rwkv6-7b: attention-free RWKV6 time and channel mixes):

  init_params(cfg, generator, dtype, device)   -> params
  params_from_jax(cfg, params_np, device)      -> params
  forward_train(cfg, params, batch, remat)     -> (loss, {"logits"})
  forward_prefill(cfg, params, batch, cap)     -> (last logits, state)
  init_decode_state(cfg, batch, max_len, ...)  -> state
  decode_step(cfg, params, state, token)       -> (logits, state)
  model_input_spec(cfg, shape)                 -> {name: (shape, dtype)}
  train_state_from_jax(cfg, state_np, device)  -> train.TrainState

Params are a dict ``{"embed", "layers": [one dict per layer],
"final_norm", "lm_head"}`` (+ ``"enc_layers"``, ``"enc_norm"`` for the
audio encoder) with the reference's names and per-layer shapes; a batch
is ``{"tokens"}`` (+ ``"patches"`` (B, P, d) for VLM, ``"frames"`` (B,
n_frames, d) for audio).  The decode state is ``{"len": (B,) int32,
"layers": [...]}`` (+ ``"enc_out"`` for audio) with per-layer ``{"attn":
{"k", "v"} (GQA) or {"latent"} (MLA), "ssm"}``, or for RWKV ``{"shift1",
"S", "shift2"}``; an MoE layer holds ``"moe"`` where a dense one holds
``"mlp"``.  A decode state placed by ``distributed.sharding.device_put``
(e.g. by ``cache_pspecs``, from a ``device="meta"`` state: allocated
piece by piece) holds ``Placed`` leaves; ``decode_step`` reads GQA K/V
in pieces under a decode mesh and every other leaf whole.  Training runs
the layer loop with per-layer
rematerialisation (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``).

Params placed by ``device_put(params, named_shardings(param_pspecs(...),
mesh))`` serve and train as they are (``forward_prefill``,
``decode_step``, ``forward_train``; ``train.steps`` differentiates each
piece on its card): the
activations live on the home card (mesh entry 0's device), the
embedding and the logits take the vocab-parallel route, a GQA layer's
heads, a SwiGLU MLP and MoE experts run on the cards that hold their
pieces, and every other leaf is gathered whole for the layer that reads
it (``models.tensor_parallel``).  The decode state's GQA K/V are then
held in KV-head pieces (``init_decode_state(mesh=)``).
``fill_placed`` draws such a tree piece by piece on each piece's card.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig, ShapeSpec
from ..distributed.fault import tree_flatten
from ..distributed.sharding import (NamedSharding, Placed, axis_mesh,
                                    device_put, gather, shard_slices)
from ..kernels.dispatch import resolve_device
from . import layers as L
from . import tensor_parallel as tp

__all__ = ["ATTN_CHUNK", "init_params", "params_from_jax", "forward_train",
           "loss_fn", "forward_prefill", "init_decode_state", "decode_step",
           "model_input_spec", "train_state_from_jax", "fill_placed",
           "kv_head_mesh"]

Params = Dict[str, Any]

# attention chunk used by the flash-style online softmax
ATTN_CHUNK = 1024


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(cfg: ArchConfig, generator, dtype, device) -> Params:
    """One layer's params, as the reference's ``_init_layer`` (the audio
    encoder's layers too carry the decoder's ``xattn`` / ``norm_x``)."""
    d, f = cfg.d_model, cfg.d_ff

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def normal(shape, scale):
        return L.normal_init(shape, scale, generator, dtype, device)

    p: Params = {"norm1": ones(d), "norm2": ones(d)}
    if cfg.family == "ssm":
        p["rwkv"] = L.init_rwkv(generator, cfg, dtype, device)
        return p
    init_attn = L.init_mla if cfg.attn_type == "mla" else L.init_gqa
    p["attn"] = init_attn(generator, cfg, dtype, device)
    if cfg.family == "hybrid":
        p["ssm"] = L.init_ssm(generator, cfg, dtype, device)
        p["mix_a"] = torch.full((), 0.5, dtype=dtype, device=device)
        p["mix_s"] = torch.full((), 0.5, dtype=dtype, device=device)
    s = d ** -0.5
    if cfg.moe is not None:
        p["moe"] = L.init_moe(generator, cfg, dtype, device)
    elif cfg.family == "audio":
        p["mlp"] = {"w_up": normal((d, f), s),
                    "b_up": torch.zeros((f,), dtype=dtype, device=device),
                    "w_down": normal((f, d), f ** -0.5),
                    "b_down": torch.zeros((d,), dtype=dtype, device=device)}
        # decoder cross-attention (the encoder output as keys and values)
        p["xattn"] = L.init_gqa(generator, cfg, dtype, device)
        p["norm_x"] = ones(d)
    else:
        p["mlp"] = {"w_gate": normal((d, f), s), "w_up": normal((d, f), s),
                    "w_down": normal((f, d), f ** -0.5)}
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda") -> Params:
    """Random weights with the reference's shapes and scales (not its
    values: ``torch.Generator`` draws other numbers than ``jax.random``).
    The generator must live on ``device`` (the card unless the caller
    passes ``device="cpu"``)."""
    device = resolve_device(device)
    vp, d = cfg.vocab_padded, cfg.d_model
    params: Params = {
        "embed": L.normal_init((vp, d), 0.02, generator, dtype, device),
        "layers": [_init_layer(cfg, generator, dtype, device)
                   for _ in range(cfg.n_layers)],
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.normal_init((d, vp), 0.02, generator, dtype,
                                          device)
    if cfg.encdec is not None:
        params["enc_layers"] = [_init_layer(cfg, generator, dtype, device)
                                for _ in range(cfg.encdec.n_enc_layers)]
        params["enc_norm"] = torch.ones((d,), dtype=dtype, device=device)
    return params


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                    # a writable copy, 0-d kept 0-d
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(cfg: ArchConfig, params_np: Params,
                    device="cuda") -> Params:
    """The JAX package's parameter pytree (numpy arrays, per-layer leaves
    stacked on a leading L axis under ``"layers"`` and, for audio,
    ``"enc_layers"``) as the port's parameters: one dict per layer, same
    names and dtypes, on ``device`` (the card unless the caller passes
    ``device="cpu"``)."""
    device = resolve_device(device)
    stacks = {"layers": cfg.n_layers}
    if cfg.encdec is not None:
        stacks["enc_layers"] = cfg.encdec.n_enc_layers

    def unstack(tree, i):
        if isinstance(tree, dict):
            return {k: unstack(v, i) for k, v in tree.items()}
        return _tensor(tree[i], device)

    out: Params = {k: _tensor(v, device) for k, v in params_np.items()
                   if k not in stacks}
    for k, n in stacks.items():
        out[k] = [unstack(params_np[k], i) for i in range(n)]
    return out


def _piece_init(cfg: ArchConfig, path: Tuple[str, ...]):
    """How ``init_params`` draws the leaf at ``path``: ("normal", scale)
    or ("const", value); the leaves of GQA attention (``attn`` and the
    audio ``xattn``), the dense and audio MLPs, MoE and the norms."""
    d, name = cfg.d_model, path[-1]
    block = path[-2] if len(path) > 1 else ""
    if name in ("embed", "lm_head"):
        return "normal", 0.02
    if "norm" in name:
        return "const", 1.0
    if block in ("attn", "xattn") and cfg.attn_type != "mla":
        return "normal", d ** -0.5
    if block == "mlp":
        if name in ("b_up", "b_down"):
            return "const", 0.0
        return "normal", (cfg.d_ff if name == "w_down" else d) ** -0.5
    if block == "moe":
        e = cfg.moe
        fan = {"w_down": e.d_expert,
               "shared_down": e.n_shared * e.d_expert}.get(name, d)
        return "normal", fan ** -0.5
    raise ValueError(f"fill_placed draws the GQA, MLP, MoE and norm "
                     f"leaves; {'/'.join(path)} is not one")


def fill_placed(cfg: ArchConfig, params: Params, seed: int) -> Params:
    """Fill a params tree placed piece by piece (``device_put`` of
    ``init_params(..., device="meta")``, which allocates zero pieces) with
    ``init_params``' distributions, in place: each piece is drawn on its
    own card from a generator seeded by (``seed``, the leaf's place in
    ``tree_flatten`` order, the piece's block), so no leaf is ever whole
    on one card and the entries that hold one block (replicas) hold the
    same values.  The values are not an unsharded draw's.  Returns
    ``params``."""
    paths: List[Tuple[str, ...]] = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t, key=str):
                walk(t[k], path + (str(k),))
        elif isinstance(t, list):
            for v in t:
                walk(v, path)
        else:
            paths.append(path)

    walk(params, ())
    leaves = tree_flatten(params)[0]
    for i, (path, x) in enumerate(zip(paths, leaves)):
        if not isinstance(x, Placed):
            raise TypeError(f"fill_placed fills Placed leaves; "
                            f"{'/'.join(path)} is a {type(x).__name__}")
        kind, value = _piece_init(cfg, path)
        for j in np.ndindex(x.pieces.shape):
            piece = x.pieces[j]
            if kind == "const":
                piece.fill_(value)
                continue
            block = [sl.start for sl in shard_slices(x.shape, x.spec,
                                                     x.mesh, j)]
            key = np.random.SeedSequence([seed, i] + block)
            gen = torch.Generator(device=piece.device).manual_seed(
                int(key.generate_state(1, np.uint64)[0] >> 1))
            draw = torch.randn(piece.shape, generator=gen,
                               dtype=torch.float32, device=piece.device)
            piece.copy_(draw.mul_(value))
            del draw
    return params


def train_state_from_jax(cfg: ArchConfig, state_np, device="cuda"):
    """The JAX package's ``TrainState`` (its fields as numpy: step,
    params, mu, nu, compress_err) as the port's ``train.TrainState`` on
    ``device`` (the card unless the caller passes ``device="cpu"``).
    Params and moments go through ``params_from_jax``; a residual of
    0-d zeros (no compression) becomes 0-d zeros per port leaf."""
    from ..distributed.fault import tree_map
    from ..train.optimizer import TrainState

    fields = (state_np._asdict() if hasattr(state_np, "_asdict")
              else dict(state_np))
    device = resolve_device(device)
    params, mu, nu = (params_from_jax(cfg, fields[k], device)
                      for k in ("params", "mu", "nu"))
    err = fields["compress_err"]
    if all(np.ndim(x) == 0 for x in tree_flatten(err)[0]):
        err = tree_map(lambda p: torch.zeros((), dtype=torch.float32,
                                             device=device), params)
    else:
        err = params_from_jax(cfg, err, device)
    step = torch.tensor(int(np.asarray(fields["step"])), dtype=torch.int32,
                        device=device)
    return TrainState(step=step, params=params, mu=mu, nu=nu,
                      compress_err=err)


def _layer_flags(cfg: ArchConfig) -> np.ndarray:
    """(L,) per-layer global-attention flags (hybrid SWA pattern)."""
    flags = np.zeros((cfg.n_layers,), np.bool_)
    if cfg.sliding_window and cfg.global_attn_every:
        flags[::cfg.global_attn_every] = True
        flags[-1] = True
    else:
        flags[:] = True
    return flags


def _windows(cfg: ArchConfig) -> List[int]:
    """Per-layer attention window: 0 (none) on global layers, the sliding
    window on the others (the reference's unreachable 2^30 horizon on a
    global layer masks nothing, like 0 here)."""
    if not cfg.sliding_window:
        return [0] * cfg.n_layers
    return [0 if g else cfg.sliding_window for g in _layer_flags(cfg)]


# ---------------------------------------------------------------------------
# layer body (training, prefill and decode)
# ---------------------------------------------------------------------------


def _norm(cfg: ArchConfig, x, scale):
    """A layer's norm: the audio family's layer norm (zero bias), every
    other family's RMS norm."""
    if cfg.family == "audio":
        return L.layer_norm(x, scale, torch.zeros_like(scale), cfg.norm_eps)
    return L.rms_norm(x, scale, cfg.norm_eps)


def _rwkv_layer(cfg: ArchConfig, p: Params, x, cache):
    """An RWKV6 layer: time mix, then channel mix, each behind an RMS norm
    and carrying its token shift; returns (y, {"shift1", "S",
    "shift2"})."""
    eps = cfg.norm_eps
    y, (shift1, S) = L.rwkv_time_mix(
        p["rwkv"], L.rms_norm(x, p["norm1"], eps), cfg,
        state=None if cache is None else (cache["shift1"], cache["S"]))
    x = x + y
    y, shift2 = L.rwkv_channel_mix(
        p["rwkv"], L.rms_norm(x, p["norm2"], eps),
        shift=None if cache is None else cache["shift2"])
    return x + y, {"shift1": shift1, "S": S, "shift2": shift2}


def _encoder_gqa(cfg: ArchConfig, p: Params, h, positions):
    """The audio encoder's bidirectional self-attention (roped)."""
    b, s, _ = h.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (h @ p["wq"]).reshape(b, s, hq, dh)
    k = (h @ p["wk"]).reshape(b, s, hkv, dh)
    v = (h @ p["wv"]).reshape(b, s, hkv, dh)
    cos, sin = L.rope_tables(positions, dh, cfg.rope_theta)
    out = L.chunked_attention(L.apply_rope(q, cos, sin),
                              L.apply_rope(k, cos, sin), v, causal=False,
                              chunk=ATTN_CHUNK)
    return out.reshape(b, s, hq * dh) @ p["wo"]


def _cross_gqa(cfg: ArchConfig, p: Params, h, enc_out):
    """The audio decoder's cross-attention over ``enc_out``, without
    rope; keys and values are projected from ``enc_out`` at every call,
    decode steps included, as in the reference."""
    b, s, _ = h.shape
    t = enc_out.shape[1]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (h @ p["wq"]).reshape(b, s, hq, dh)
    k = (enc_out @ p["wk"]).reshape(b, t, hkv, dh)
    v = (enc_out @ p["wv"]).reshape(b, t, hkv, dh)
    out = L.chunked_attention(q, k, v, causal=False, chunk=ATTN_CHUNK)
    return out.reshape(b, s, hq * dh) @ p["wo"]


def _pieces_or_whole(cfg: ArchConfig, p: Params, dev) -> Params:
    """A layer's params with every ``Placed`` leaf gathered whole onto
    ``dev`` (the gather route) but those of the blocks that read pieces
    themselves: a GQA ``attn`` (not the audio family's, whose encoder
    and cross-attention read whole weights), a SwiGLU ``mlp`` and
    ``moe``; the MLA, SSM, RWKV6 and audio blocks read whole leaves."""
    if not any(isinstance(t, Placed) for v in p.values()
               for t in (v.values() if isinstance(v, dict) else (v,))):
        return p
    keep = _piece_blocks(cfg)
    return {k: v if k in keep else tp.whole_tree(v, dev)
            for k, v in p.items()}


def _piece_blocks(cfg: ArchConfig) -> set:
    if cfg.family in ("ssm", "audio"):
        return set()
    keep = {"moe" if cfg.moe is not None else "mlp"}
    if cfg.attn_type != "mla":
        keep.add("attn")
    return keep


def kv_head_mesh(cfg: ArchConfig, params: Params):
    """The mesh whose entries hold the decode state's K/V in KV-head
    pieces for ``params`` (``init_decode_state(mesh=)``): that of the
    first layer's attention where its heads run in groups on its pieces,
    else None."""
    if "attn" not in _piece_blocks(cfg):
        return None
    return tp.head_mesh(cfg, params["layers"][0]["attn"])


def _layer_fwd(cfg: ArchConfig, p: Params, x, *, positions, window: int,
               cache=None, enc_out=None, causal: bool = True,
               use_kernel=None):
    """One layer.  Returns (y, layer cache): prefill gives this
    sequence's {"attn": {"k", "v"} or {"latent"}, "ssm"} (RWKV: {"shift1",
    "S", "shift2"}); decode updates ``cache``.  ``causal=False`` is an
    audio encoder layer (no cache); ``enc_out`` adds an audio decoder
    layer's cross-attention.  Weights in pieces: the blocks that read
    pieces (a GQA ``attn``, a SwiGLU ``mlp``, ``moe``) get them as they
    are; every other placed leaf is gathered whole onto x's card for
    this layer only (``_pieces_or_whole``)."""
    p = _pieces_or_whole(cfg, p, x.device)
    if cfg.family == "ssm":
        return _rwkv_layer(cfg, p, x, cache)
    h = _norm(cfg, x, p["norm1"])
    new_cache: Dict[str, Any] = {}
    if not causal:
        attn_out = _encoder_gqa(cfg, p["attn"], h, positions)
    else:
        attn_cache = None if cache is None else cache["attn"]
        if cfg.attn_type == "mla":
            attn_out, attn_cache = L.mla_forward(
                p["attn"], h, cfg, positions=positions, cache=attn_cache,
                chunk=ATTN_CHUNK)
        else:
            attn_out, attn_cache = L.gqa_forward(
                p["attn"], h, cfg, positions=positions, cache=attn_cache,
                window=window, chunk=ATTN_CHUNK, use_kernel=use_kernel)
        new_cache["attn"] = {k: t for k, t in attn_cache.items()
                             if k != "len"}
    if cfg.family == "hybrid":
        ssm_out, new_cache["ssm"] = L.ssm_forward(
            p["ssm"], h, cfg, state=None if cache is None else cache["ssm"],
            use_kernel=use_kernel)
        f32 = torch.float32
        mixed = (p["mix_a"].to(f32) * attn_out.to(f32)
                 + p["mix_s"].to(f32) * ssm_out.to(f32)).to(x.dtype)
        x = x + mixed
    else:
        x = x + attn_out
    if cfg.family == "audio" and enc_out is not None:
        x = x + _cross_gqa(cfg, p["xattn"], _norm(cfg, x, p["norm_x"]),
                           enc_out)
    h = _norm(cfg, x, p["norm2"])
    if cfg.moe is not None:
        y = L.moe_forward(p["moe"], h, cfg)
    elif cfg.family == "audio":
        y = L.gelu_mlp(h, **p["mlp"])
    else:
        y = L.swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                     p["mlp"]["w_down"])
    return x + y, new_cache


def _logits(cfg: ArchConfig, params: Params, x: torch.Tensor):
    """The final norm is an RMS norm for every family, audio included,
    as in the reference.  A head in vocabulary pieces runs one product
    per card, concatenated on x's card (``tp.logits``)."""
    x = L.rms_norm(x, tp.on(params["final_norm"], x.device), cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        return tp.logits(x, params["embed"], tied=True)
    return tp.logits(x, head, tied=False)


def _pad_seq(x: torch.Tensor, cap: int) -> torch.Tensor:
    """Pad the sequence axis (axis 1) of a cache contribution to cap (a
    contribution in pieces piece by piece)."""
    if isinstance(x, Placed):
        return tp.map_pieces(lambda t: _pad_seq(t, cap), x,
                             shape=(x.shape[0], cap) + tuple(x.shape[2:]))
    s = x.shape[1]
    if s >= cap:
        return x[:, :cap].contiguous()
    out = torch.zeros((x.shape[0], cap) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    out[:, :s] = x
    return out


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------


def _embed_inputs(cfg: ArchConfig, params: Params, batch):
    """Token embedding behind the VLM family's patch prefix (``patches``
    cast to the embedding's dtype).  Returns (x (B, S, d), label_mask (B,
    S) bool), the mask marking positions that carry next-token loss:
    False over the patches."""
    tokens = batch["tokens"]
    x = tp.embedding(tokens.long(), params["embed"])
    mask = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    if cfg.vlm is not None:
        patches = batch["patches"].to(x.dtype)
        x = torch.cat([patches, x], dim=1)
        mask = torch.cat([torch.zeros(patches.shape[:2], dtype=torch.bool,
                                      device=mask.device), mask], dim=1)
    return x, mask


def _run_encoder(cfg: ArchConfig, params: Params, frames: torch.Tensor):
    """The audio encoder: its layers, non-causal over ``frames`` (cast to
    the embedding's dtype), then the layer norm ``enc_norm``."""
    x = frames.to(params["embed"].dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for lp in params["enc_layers"]:
        x, _ = _layer_fwd(cfg, lp, x, positions=positions, window=0,
                          causal=False)
    norm = tp.on(params["enc_norm"], x.device)
    return L.layer_norm(x, norm, torch.zeros_like(norm), cfg.norm_eps)


def _encode(cfg: ArchConfig, params: Params, batch):
    return (_run_encoder(cfg, params, batch["frames"])
            if cfg.encdec is not None else None)


def forward_train(cfg: ArchConfig, params: Params, batch,
                  remat: bool = True, use_kernel: Optional[bool] = None):
    """Teacher-forced forward over ``batch["tokens"]`` (B, T) (behind
    ``patches`` for VLM; over the encoded ``frames`` for audio); returns
    (loss, {"logits": (B, S, vocab_padded)}), S = P + T for VLM.

    Each layer is ``_layer_fwd`` with no cache (its k/v are dropped);
    with ``remat`` each runs under ``torch.utils.checkpoint`` (not
    reentrant), so the backward recomputes one layer at a time: on the
    hybrid family the scan's forward runs twice per layer and its
    backward once.  The audio encoder runs without remat, as in the
    reference.  Params in pieces take the routes of ``_layer_fwd`` and
    the vocab-parallel embedding and logits; the loss is taken on the
    tokens' card, and a leaf gathered for a layer (``_pieces_or_whole``)
    is gathered again when the backward recomputes that layer."""
    x, label_mask = _embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    enc_out = _encode(cfg, params, batch)

    def layer(lp, window, h):
        return _layer_fwd(cfg, lp, h, positions=positions, window=window,
                          enc_out=enc_out, use_kernel=use_kernel)[0]

    for lp, window in zip(params["layers"], _windows(cfg)):
        if remat:
            x = checkpoint(layer, lp, window, x, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = layer(lp, window, x)
    logits = _logits(cfg, params, x)
    loss = loss_fn(cfg, logits, batch["tokens"], label_mask)
    return loss, {"logits": logits}


def loss_fn(cfg: ArchConfig, logits: torch.Tensor, tokens: torch.Tensor,
            label_mask: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy over the real vocabulary, float32: the
    padded vocabulary columns are masked to -1e30 before the logsumexp;
    the mean is over the positions ``label_mask`` marks (at least 1)."""
    logits = logits.to(torch.float32)
    vocab_ok = torch.arange(logits.shape[-1], device=logits.device) \
        < cfg.vocab_size
    logits = torch.where(vocab_ok, logits, -1e30)
    # predict token t+1 at position t (the last token has no target)
    tgt_mask = label_mask[:, 1:]
    targets = tokens[:, 1:].long()
    n_prefix = logits.shape[1] - tokens.shape[1]
    pred = logits[:, n_prefix:logits.shape[1] - 1]
    lse = torch.logsumexp(pred, dim=-1)
    tgt_logit = torch.gather(pred, -1, targets[..., None])[..., 0]
    nll = (lse - tgt_logit) * tgt_mask[:, -pred.shape[1]:]
    denom = torch.clamp(tgt_mask.sum().to(torch.float32), min=1.0)
    return nll.sum() / denom


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


def forward_prefill(cfg: ArchConfig, params: Params, batch,
                    cache_capacity: Optional[int] = None,
                    use_kernel: Optional[bool] = None):
    """Serving prefill: full-sequence forward over the batch (tokens,
    behind ``patches`` for VLM; ``frames`` encoded for audio) that also
    emits the decode state (per-layer KV, or the MLA latent, padded to
    ``cache_capacity``; SSM states; RWKV shifts and S; audio's
    ``enc_out``) and the last position's logits (B, vocab_padded)."""
    x, _ = _embed_inputs(cfg, params, batch)
    b, s, _ = x.shape
    cap = cache_capacity or s
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    enc_out = _encode(cfg, params, batch)
    layers = []
    for lp, window in zip(params["layers"], _windows(cfg)):
        x, contrib = _layer_fwd(cfg, lp, x, positions=positions,
                                window=window, enc_out=enc_out,
                                use_kernel=use_kernel)
        if "attn" in contrib:
            contrib["attn"] = {k: _pad_seq(t, cap)
                               for k, t in contrib["attn"].items()}
        layers.append(contrib)
    logits = _logits(cfg, params, x[:, -1])
    state = {"layers": layers,
             "len": torch.full((b,), s, dtype=torch.int32, device=x.device)}
    if enc_out is not None:
        state["enc_out"] = enc_out
    return logits, state


def init_decode_state(cfg: ArchConfig, batch_size: int, max_len: int,
                      dtype=torch.bfloat16, device="cuda",
                      mesh=None) -> Dict[str, Any]:
    """An empty decode state: zero KV caches (B, max_len, Hkv, Dh), or
    for MLA a zero latent cache (B, max_len, kv_rank + rope_dim), and,
    for the hybrid family, zero SSM states (B, d_inner, state) float32;
    for RWKV zero shifts (B, d) and S (B, H, dh, dh) float32; for audio a
    zero ``enc_out`` (B, n_frames, d); on ``device`` (the card unless the
    caller passes ``device="cpu"``).  On ``meta`` it is the shape tree
    that ``distributed.sharding.device_put`` allocates in pieces (zeros
    on each mesh entry's device), so that a state larger than one card
    is never whole.

    ``mesh`` (that of params in pieces, ``tensor_parallel.head_mesh``)
    gives the state of the head route: GQA K/V in KV-head pieces
    (``tensor_parallel.HEAD_SPEC`` on the mesh's entries along
    ``model``) allocated from ``meta`` entry by entry, where the entries
    divide the KV heads, and every other leaf whole on mesh entry 0's
    device (``device`` is not read)."""
    if mesh is not None:
        return _head_state(cfg, batch_size, max_len, dtype, mesh)
    device = resolve_device(device)
    b, d = batch_size, cfg.d_model

    def zeros(*shape, dtype=dtype):
        return torch.zeros((b,) + shape, dtype=dtype, device=device)

    layers = []
    for _ in range(cfg.n_layers):
        if cfg.family == "ssm":
            layers.append({"shift1": zeros(d),
                           "S": zeros(cfg.n_heads, cfg.head_dim,
                                      cfg.head_dim, dtype=torch.float32),
                           "shift2": zeros(d)})
            continue
        if cfg.attn_type == "mla":
            lc = {"attn": {"latent": zeros(max_len, cfg.mla.kv_rank
                                           + cfg.mla.rope_dim)}}
        else:
            lc = {"attn": {"k": zeros(max_len, cfg.n_kv_heads, cfg.head_dim),
                           "v": zeros(max_len, cfg.n_kv_heads,
                                      cfg.head_dim)}}
        if cfg.family == "hybrid":
            sm = cfg.ssm
            lc["ssm"] = zeros(sm.expand * d, sm.state_dim,
                              dtype=torch.float32)
        layers.append(lc)
    state = {"len": torch.zeros((b,), dtype=torch.int32, device=device),
             "layers": layers}
    if cfg.encdec is not None:
        state["enc_out"] = zeros(cfg.encdec.n_frames, d)
    return state


def _head_state(cfg: ArchConfig, b: int, max_len: int, dtype, mesh):
    meta = init_decode_state(cfg, b, max_len, dtype=dtype, device="meta")
    row = axis_mesh(mesh, tp.AXIS)
    dev = row.devices.flat[0]
    split = cfg.n_kv_heads % row.shape[tp.AXIS] == 0
    sharding = NamedSharding(row, tp.HEAD_SPEC)

    def alloc(t, kv=False):
        if kv and split:
            return device_put(t, sharding)
        return torch.zeros(t.shape, dtype=t.dtype, device=dev)

    def layer(lc):
        return {k: {n: alloc(t, n in ("k", "v")) for n, t in v.items()}
                if k == "attn" else alloc(v) for k, v in lc.items()}

    out = {k: alloc(v) for k, v in meta.items() if k != "layers"}
    out["layers"] = [layer(lc) for lc in meta["layers"]]
    return out


def _whole_but_kv(state: Dict[str, Any], home) -> Dict[str, Any]:
    """``state`` with every ``Placed`` leaf but a GQA layer's ``attn``
    K/V gathered onto ``home`` (``gqa_forward`` decides for those)."""
    def whole(t):
        return gather(t, home) if isinstance(t, Placed) else t

    def layer(lc):
        return {k: ({n: t if n in ("k", "v") else whole(t)
                     for n, t in v.items()} if k == "attn" else whole(v))
                for k, v in lc.items()}

    out = {k: whole(v) for k, v in state.items() if k != "layers"}
    out["layers"] = [layer(lc) for lc in state["layers"]]
    return out


def decode_step(cfg: ArchConfig, params: Params, state: Dict[str, Any],
                token: torch.Tensor, use_kernel: Optional[bool] = None):
    """One token for every sequence in the batch.  token: (B, 1) int.

    Returns (logits (B, vocab_padded), new state).  The KV (or MLA
    latent) caches of ``state`` are written in place (the new state
    holds the same tensors); SSM and RWKV states and ``len`` are
    replaced; audio reads ``state["enc_out"]``.

    A state placed by ``distributed.sharding.device_put``: GQA K/V held
    in pieces (``Placed``) are read and written in pieces under an active
    decode mesh (``models.sharded_decode``) and come back so; every other
    leaf (``len``, SSM / conv / RWKV states, MLA latents, ``enc_out``,
    and K/V with no such mesh) is gathered whole onto the params' device
    at its first use and returned whole.  Params in pieces: the work
    runs on their home card (mesh entry 0's device) and the cards of
    their pieces, a GQA layer on the head route reading and writing its
    K/V in KV-head pieces whatever mesh is active (``_gqa_heads``).  (The reference's automatic
    partitioning would keep a leaf that ``cache_pspecs`` splits, such as
    an SSM state with ``model`` on a dimension of 128 or more, split.)
    """
    state = _whole_but_kv(state, tp.home(params["embed"]))
    x = tp.embedding(token.long().to(tp.home(params["embed"])),
                     params["embed"])                       # (B, 1, d)
    pos = state["len"]
    positions = pos[:, None]
    enc_out = state.get("enc_out")
    layers = []
    for lp, lc, window in zip(params["layers"], state["layers"],
                              _windows(cfg)):
        cache = lc if cfg.family == "ssm" else {
            "attn": dict(lc["attn"], len=pos), "ssm": lc.get("ssm")}
        x, new_cache = _layer_fwd(cfg, lp, x, positions=positions,
                                  window=window, cache=cache,
                                  enc_out=enc_out, use_kernel=use_kernel)
        layers.append(new_cache)
    logits = _logits(cfg, params, x)[:, 0]
    new_state = dict(state)
    new_state["layers"] = layers
    new_state["len"] = pos + 1
    return logits, new_state


# ---------------------------------------------------------------------------
# input specs (shapes and dtypes; no allocation)
# ---------------------------------------------------------------------------


def model_input_spec(cfg: ArchConfig, shape: ShapeSpec
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{input name: (shape, dtype)} of a shape cell, the port's stand-in
    for the reference's ``jax.ShapeDtypeStruct`` tree: (B, S) int32
    tokens for training and prefill (VLM: S - P tokens behind (B, P, d)
    bf16 ``patches``; audio: (B, n_frames, d) bf16 ``frames`` beside
    them), one (B, 1) token for decode."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind not in ("train", "prefill"):
        return {"token": ((b, 1), torch.int32)}
    spec = {"tokens": ((b, s), torch.int32)}
    if cfg.vlm is not None:
        p = cfg.vlm.n_patches
        spec["tokens"] = ((b, s - p), torch.int32)
        spec["patches"] = ((b, p, cfg.d_model), torch.bfloat16)
    if cfg.encdec is not None:
        spec["frames"] = ((b, cfg.encdec.n_frames, cfg.d_model),
                          torch.bfloat16)
    return spec
