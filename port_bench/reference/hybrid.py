"""Plain float32 reference of the hybrid family (hymba-1.5b,
arXiv:2411.13676): in every layer attention heads and selective-SSM heads
read the same normed input side by side, their outputs averaged by two
learned scalars; a SwiGLU MLP follows.  Attention is global on the layers
the configuration names and sliding-window on the others.

Departures from the paper, as the configuration file lists them: no meta
tokens, no cross-layer KV sharing, the SSM's depthwise convolution left
out (the state update reads the projected input directly), the SSM's B and
C read from the layer's normed input.

The selective scan is written here as a chunked log-space scan (a
cumulative sum of log-decays within a chunk of 64 steps, chunks carried
one after another): the same recurrence as a step-by-step loop, in other
rounding.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import common as C

SCAN_CHUNK = 64


def layout(cfg: Dict) -> Dict:
    """The parameter tree: for each leaf (shape, how it is drawn, the
    number it is drawn with): ("normal", scale) is N(0, 1) * scale,
    ("const", v) is v everywhere, ("neg_exp", s) is -exp(s N(0, 1))."""
    d, f = cfg["d_model"], cfg["d_ff"]
    hq = cfg["n_heads"] * cfg["head_dim"]
    hkv = cfg["n_kv_heads"] * cfg["head_dim"]
    di, n = cfg["ssm_expand"] * d, cfg["ssm_state_dim"]
    vp = cfg["vocab_padded"]
    s = d ** -0.5
    layer = {
        "norm1": ((d,), "const", 1.0), "norm2": ((d,), "const", 1.0),
        "attn": {"wq": ((d, hq), "normal", s), "wk": ((d, hkv), "normal", s),
                 "wv": ((d, hkv), "normal", s),
                 "wo": ((hq, d), "normal", s)},
        "ssm": {"in_proj": ((d, 2 * di), "normal", s),
                "w_dt": ((di,), "normal", 0.1),
                "b_dt": ((di,), "const", -4.0),
                "log_a": ((di, n), "neg_exp", 0.5),
                "w_b": ((d, n), "normal", s), "w_c": ((d, n), "normal", s),
                "d_skip": ((di,), "const", 1.0),
                "out_proj": ((di, d), "normal", di ** -0.5)},
        "mix_a": ((), "const", 0.5), "mix_s": ((), "const", 0.5),
        "mlp": {"w_gate": ((d, f), "normal", s), "w_up": ((d, f), "normal", s),
                "w_down": ((f, d), "normal", f ** -0.5)},
    }
    return {"embed": ((vp, d), "normal", 0.02),
            "layers": [layer] * cfg["n_layers"],
            "final_norm": ((d,), "const", 1.0),
            "lm_head": ((d, vp), "normal", 0.02)}


def windows(cfg: Dict) -> List[int]:
    """Per layer: 0 (global) or the sliding window."""
    n, every = cfg["n_layers"], cfg["global_attn_every"]
    glob = [i % every == 0 for i in range(n)]
    if cfg["last_layer_global"]:
        glob[-1] = True
    return [0 if g else cfg["sliding_window"] for g in glob]


def scan(la: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """h_t = exp(la_t) h_{t-1} + u_t from h = 0, over axis 1 of (B, S, N)."""
    b, s, n = la.shape
    c = min(SCAN_CHUNK, s)
    pad = (-s) % c
    if pad:
        la = F.pad(la, (0, 0, 0, pad))
        u = F.pad(u, (0, 0, 0, pad))
    nc = la.shape[1] // c
    lc = torch.cumsum(la.reshape(b, nc, c, n), dim=2)
    local = torch.exp(lc) * torch.cumsum(
        torch.exp(-lc) * u.reshape(b, nc, c, n), dim=2)
    decay = torch.exp(lc[:, :, -1])
    carry = [torch.zeros((b, n), dtype=la.dtype, device=la.device)]
    for i in range(nc - 1):
        carry.append(decay[:, i] * carry[-1] + local[:, i, -1])
    h = local + torch.exp(lc) * torch.stack(carry, dim=1)[:, :, None]
    return h.reshape(b, nc * c, n)[:, :s]


def ssm(prec: C.Precision, p: Dict, h: torch.Tensor, cfg: Dict):
    """The SSM heads over the normed input h (B, S, d); returns (y, the
    last state (B, di, n))."""
    b, s, d = h.shape
    di, n = cfg["ssm_expand"] * d, cfg["ssm_state_dim"]
    xz = prec.mm(h, p["in_proj"])
    xi, z = xz[..., :di], xz[..., di:]
    dt = F.softplus(xi * p["w_dt"] + p["b_dt"])
    bm, cm = prec.mm(h, p["w_b"]), prec.mm(h, p["w_c"])
    la = dt[..., None] * p["log_a"]                          # (B, S, di, n)
    u = (dt * xi)[..., None] * bm[:, :, None, :]
    hs = scan(la.reshape(b, s, di * n), u.reshape(b, s, di * n))
    hs = hs.reshape(b, s, di, n)
    y = torch.einsum("bsdn,bsn->bsd", hs, cm) + p["d_skip"] * xi
    y = y * F.silu(z)
    return prec.mm(y, p["out_proj"]), hs[:, -1]


def layer(prec: C.Precision, cfg: Dict, p: Dict, x: torch.Tensor,
          window: int, want_state: bool = False):
    b, s, d = x.shape
    hd = cfg["head_dim"]
    pos = torch.arange(s, device=x.device)
    h = C.rms_norm(x, p["norm1"], cfg["norm_eps"])
    a = p["attn"]
    q = prec.mm(h, a["wq"]).reshape(b, s, cfg["n_heads"], hd)
    k = prec.mm(h, a["wk"]).reshape(b, s, cfg["n_kv_heads"], hd)
    v = prec.mm(h, a["wv"]).reshape(b, s, cfg["n_kv_heads"], hd)
    q, k = C.rope(q, pos, cfg["rope_theta"]), C.rope(k, pos, cfg["rope_theta"])
    att = C.attention(prec, q, k, v, window=window)
    att = prec.mm(att.reshape(b, s, -1), a["wo"])
    y, last = ssm(prec, p["ssm"], h, cfg)
    x = x + p["mix_a"] * att + p["mix_s"] * y
    m = p["mlp"]
    x = x + C.swiglu(prec, C.rms_norm(x, p["norm2"], cfg["norm_eps"]),
                     m["w_gate"], m["w_up"], m["w_down"])
    if want_state:
        return x, {"k": k, "v": v, "ssm": last}
    return x


def loss(cfg: Dict, params: Dict, tokens: torch.Tensor,
         prec: Optional[C.Precision] = None) -> torch.Tensor:
    """Mean next-token cross entropy of ``tokens`` (B, S), each layer
    recomputed in the backward (activation memory of one layer)."""
    prec = prec or C.Precision()
    x = params["embed"][tokens.long()]
    for p, w in zip(params["layers"], windows(cfg)):
        x = checkpoint(layer, prec, cfg, p, x, w, use_reentrant=False)
    lg = C.logits(prec, x, params["final_norm"], params["lm_head"],
                  cfg["norm_eps"])
    return C.next_token_loss(lg, tokens, cfg["vocab_size"])


@torch.no_grad()
def prefill(cfg: Dict, params: Dict, tokens: torch.Tensor,
            prec: Optional[C.Precision] = None, layer_params=None):
    """Last position's logits (B, vocab_padded) and the state a decode
    would go on from, f32, as a tree of the program's leaf names: "len"
    (B,), and per layer {"attn": {"k", "v"} roped, "ssm": the last SSM
    state}.  ``layer_params(i)`` may hand the layers one at a time."""
    prec = prec or C.Precision()
    get = layer_params or (lambda i: params["layers"][i])
    x = params["embed"][tokens.long()]
    states = []
    for i, w in enumerate(windows(cfg)):
        x, st = layer(prec, cfg, get(i), x, w, want_state=True)
        states.append({"attn": {"k": st["k"], "v": st["v"]},
                       "ssm": st["ssm"]})
    lg = C.logits(prec, x[:, -1], params["final_norm"], params["lm_head"],
                  cfg["norm_eps"])
    return lg, C.decode_state(tokens, states)
