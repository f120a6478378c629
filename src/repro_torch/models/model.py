"""The dense and hybrid model families, in PyTorch.

The same entry points as ``repro/models/model.py`` for the families the
port serves (``dense``: llama3-8b and its kin; ``hybrid``: hymba-1.5b,
parallel attention + SSM heads with sliding-window layers):

  init_params(cfg, generator, dtype, device)   -> params
  params_from_jax(cfg, params_np, device)      -> params
  forward_prefill(cfg, params, batch, cap)     -> (last logits, state)
  init_decode_state(cfg, batch, max_len, ...)  -> state
  decode_step(cfg, params, state, token)       -> (logits, state)

Params are a dict ``{"embed", "layers": [one dict per layer],
"final_norm", "lm_head"}`` with the reference's names and per-layer
shapes; the decode state is ``{"len": (B,) int32, "layers": [...]}``
with per-layer ``{"attn": {"k", "v"}, "ssm"}``.  The other families
(MoE, MLA, RWKV, audio, VLM) raise NotImplementedError; training
(``forward_train``, ``loss_fn``) is a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..kernels.dispatch import resolve_device
from . import layers as L

__all__ = ["ATTN_CHUNK", "init_params", "params_from_jax", "forward_prefill",
           "init_decode_state", "decode_step"]

Params = Dict[str, Any]

# attention chunk used by the flash-style online softmax
ATTN_CHUNK = 1024

_FAMILIES = ("dense", "hybrid")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in _FAMILIES or cfg.attn_type != "gqa" \
            or cfg.moe is not None:
        L.not_ported(f"the {cfg.family!r} family ({cfg.name}, attention "
                     f"{cfg.attn_type!r}{', MoE' if cfg.moe else ''})")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(cfg: ArchConfig, generator, dtype, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    p: Params = {"norm1": torch.ones((d,), dtype=dtype, device=device),
                 "norm2": torch.ones((d,), dtype=dtype, device=device),
                 "attn": L.init_gqa(generator, cfg, dtype, device)}
    if cfg.family == "hybrid":
        p["ssm"] = L.init_ssm(generator, cfg, dtype, device)
        p["mix_a"] = torch.full((), 0.5, dtype=dtype, device=device)
        p["mix_s"] = torch.full((), 0.5, dtype=dtype, device=device)
    s = d ** -0.5
    p["mlp"] = {
        "w_gate": L.normal_init((d, f), s, generator, dtype, device),
        "w_up": L.normal_init((d, f), s, generator, dtype, device),
        "w_down": L.normal_init((f, d), f ** -0.5, generator, dtype,
                                device),
    }
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda") -> Params:
    """Random weights with the reference's shapes and scales (not its
    values: ``torch.Generator`` draws other numbers than ``jax.random``).
    The generator must live on ``device`` (the card unless the caller
    passes ``device="cpu"``)."""
    _check_family(cfg)
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
    stacked on a leading L axis) as the port's parameters: one dict per
    layer, same names and dtypes, on ``device`` (the card unless the
    caller passes ``device="cpu"``)."""
    _check_family(cfg)
    device = resolve_device(device)

    def unstack(tree, i):
        if isinstance(tree, dict):
            return {k: unstack(v, i) for k, v in tree.items()}
        return _tensor(tree[i], device)

    out: Params = {k: _tensor(v, device) for k, v in params_np.items()
                   if k != "layers"}
    out["layers"] = [unstack(params_np["layers"], i)
                     for i in range(cfg.n_layers)]
    return out


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
# layer body (prefill and decode)
# ---------------------------------------------------------------------------


def _layer_fwd(cfg: ArchConfig, p: Params, x, *, positions, window: int,
               cache=None, use_kernel=None):
    """One layer.  Returns (y, layer cache): prefill gives this
    sequence's {"attn": {"k", "v"}, "ssm"}; decode updates ``cache``."""
    eps = cfg.norm_eps
    h = L.rms_norm(x, p["norm1"], eps)
    attn_cache = None if cache is None else cache["attn"]
    attn_out, attn_cache = L.gqa_forward(
        p["attn"], h, cfg, positions=positions, cache=attn_cache,
        window=window, chunk=ATTN_CHUNK, use_kernel=use_kernel)
    new_cache: Dict[str, Any] = {
        "attn": {"k": attn_cache["k"], "v": attn_cache["v"]}}
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
    h = L.rms_norm(x, p["norm2"], eps)
    y = L.swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                 p["mlp"]["w_down"])
    return x + y, new_cache


def _logits(cfg: ArchConfig, params: Params, x: torch.Tensor):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    return x @ head if head is not None else x @ params["embed"].T


def _pad_seq(x: torch.Tensor, cap: int) -> torch.Tensor:
    """Pad the sequence axis (axis 1) of a cache contribution to cap."""
    s = x.shape[1]
    if s >= cap:
        return x[:, :cap].contiguous()
    out = torch.zeros((x.shape[0], cap) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    out[:, :s] = x
    return out


def forward_prefill(cfg: ArchConfig, params: Params, batch,
                    cache_capacity: Optional[int] = None,
                    use_kernel: Optional[bool] = None):
    """Serving prefill: full-sequence forward over ``batch["tokens"]``
    (B, S) that also emits the decode state (per-layer KV padded to
    ``cache_capacity`` and SSM states) and the last token's logits
    (B, vocab_padded)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()]
    b, s, _ = x.shape
    cap = cache_capacity or s
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    layers = []
    for lp, window in zip(params["layers"], _windows(cfg)):
        x, contrib = _layer_fwd(cfg, lp, x, positions=positions,
                                window=window, use_kernel=use_kernel)
        contrib["attn"] = {k: _pad_seq(t, cap)
                           for k, t in contrib["attn"].items()}
        layers.append(contrib)
    logits = _logits(cfg, params, x[:, -1])
    state = {"layers": layers,
             "len": torch.full((b,), s, dtype=torch.int32, device=x.device)}
    return logits, state


def init_decode_state(cfg: ArchConfig, batch_size: int, max_len: int,
                      dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    """An empty decode state: zero KV caches (B, max_len, Hkv, Dh) and,
    for the hybrid family, zero SSM states (B, d_inner, state) float32,
    on ``device`` (the card unless the caller passes ``device="cpu"``)."""
    _check_family(cfg)
    device = resolve_device(device)
    b, hkv, dh = batch_size, cfg.n_kv_heads, cfg.head_dim
    layers = []
    for _ in range(cfg.n_layers):
        lc = {"attn": {"k": torch.zeros((b, max_len, hkv, dh), dtype=dtype,
                                        device=device),
                       "v": torch.zeros((b, max_len, hkv, dh), dtype=dtype,
                                        device=device)}}
        if cfg.family == "hybrid":
            sm = cfg.ssm
            lc["ssm"] = torch.zeros((b, sm.expand * cfg.d_model,
                                     sm.state_dim), dtype=torch.float32,
                                    device=device)
        layers.append(lc)
    return {"len": torch.zeros((b,), dtype=torch.int32, device=device),
            "layers": layers}


def decode_step(cfg: ArchConfig, params: Params, state: Dict[str, Any],
                token: torch.Tensor, use_kernel: Optional[bool] = None):
    """One token for every sequence in the batch.  token: (B, 1) int.

    Returns (logits (B, vocab_padded), new state).  The KV caches of
    ``state`` are written in place (the new state holds the same
    tensors); SSM states and ``len`` are replaced.
    """
    _check_family(cfg)
    x = params["embed"][token.long()]                       # (B, 1, d)
    pos = state["len"]
    positions = pos[:, None]
    layers = []
    for lp, lc, window in zip(params["layers"], state["layers"],
                              _windows(cfg)):
        cache = {"attn": dict(lc["attn"], len=pos), "ssm": lc.get("ssm")}
        x, new_cache = _layer_fwd(cfg, lp, x, positions=positions,
                                  window=window, cache=cache,
                                  use_kernel=use_kernel)
        layers.append(new_cache)
    logits = _logits(cfg, params, x)[:, 0]
    new_state = dict(state)
    new_state["layers"] = layers
    new_state["len"] = pos + 1
    return logits, new_state
