"""Plain float32 reference of a dense decoder with multi-head latent
attention (minicpm3-4b, hf:openbmb/MiniCPM3-4B): queries through a
low-rank down and up projection, split into a part without position and
a rotary part; keys and values expanded per head from a shared latent
c_kv, with one rotary key part shared by all heads; a SwiGLU MLP.  What
a cache keeps per position is the latent beside the roped shared key
part (kv_rank + rope_dim numbers).

Departures from the published model, as the configuration file lists
them: no norms on the query and key/value latents, plain rotary
embedding (no LongRoPE scaling), no scaling of the embedding, the
residual branches or the logits (MiniCPM's scale_emb, scale_depth,
dim_model_base).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import common as C


def layout(cfg: Dict) -> Dict:
    """The parameter tree, as ``hybrid.layout`` gives it."""
    d, f, h = cfg["d_model"], cfg["d_ff"], cfg["n_heads"]
    qr, kr = cfg["q_rank"], cfg["kv_rank"]
    dn, dr, dv = cfg["nope_dim"], cfg["rope_dim"], cfg["v_dim"]
    vp = cfg["vocab_padded"]
    s = d ** -0.5
    layer = {
        "norm1": ((d,), "const", 1.0), "norm2": ((d,), "const", 1.0),
        "attn": {"q_down": ((d, qr), "normal", s),
                 "q_up": ((qr, h * (dn + dr)), "normal", qr ** -0.5),
                 "kv_down": ((d, kr + dr), "normal", s),
                 "k_up": ((kr, h * dn), "normal", kr ** -0.5),
                 "v_up": ((kr, h * dv), "normal", kr ** -0.5),
                 "wo": ((h * dv, d), "normal", s)},
        "mlp": {"w_gate": ((d, f), "normal", s), "w_up": ((d, f), "normal", s),
                "w_down": ((f, d), "normal", f ** -0.5)},
    }
    return {"embed": ((vp, d), "normal", 0.02),
            "layers": [layer] * cfg["n_layers"],
            "final_norm": ((d,), "const", 1.0),
            "lm_head": ((d, vp), "normal", 0.02)}


def layer(prec: C.Precision, cfg: Dict, p: Dict, x: torch.Tensor):
    """One layer over x (B, S, d); returns (x, the latent (B, S, kv_rank +
    rope_dim) a cache keeps)."""
    b, s, _ = x.shape
    h, kr = cfg["n_heads"], cfg["kv_rank"]
    dn, dr, dv = cfg["nope_dim"], cfg["rope_dim"], cfg["v_dim"]
    pos = torch.arange(s, device=x.device)
    a = p["attn"]
    hn = C.rms_norm(x, p["norm1"], cfg["norm_eps"])
    q = prec.mm(prec.mm(hn, a["q_down"]), a["q_up"]).reshape(b, s, h, dn + dr)
    lat = prec.mm(hn, a["kv_down"])
    c_kv = lat[..., :kr]
    k_rope = C.rope(lat[:, :, None, kr:], pos, cfg["rope_theta"])
    q = torch.cat([q[..., :dn], C.rope(q[..., dn:], pos, cfg["rope_theta"])],
                  dim=-1)
    k = torch.cat([prec.mm(c_kv, a["k_up"]).reshape(b, s, h, dn),
                   k_rope.expand(b, s, h, dr)], dim=-1)
    v = prec.mm(c_kv, a["v_up"]).reshape(b, s, h, dv)
    att = C.attention(prec, q, k, v)
    x = x + prec.mm(att.reshape(b, s, h * dv), a["wo"])
    m = p["mlp"]
    x = x + C.swiglu(prec, C.rms_norm(x, p["norm2"], cfg["norm_eps"]),
                     m["w_gate"], m["w_up"], m["w_down"])
    return x, torch.cat([c_kv, k_rope[:, :, 0]], dim=-1)


@torch.no_grad()
def prefill(cfg: Dict, params: Dict, tokens: torch.Tensor,
            prec: Optional[C.Precision] = None, layer_params=None):
    """Last position's logits (B, vocab_padded) and the state a decode
    would go on from, f32, as a tree of the program's leaf names: "len"
    (B,), and per layer {"attn": {"latent": (B, S, kv_rank + rope_dim)}}.
    ``layer_params(i)`` may hand the layers one at a time."""
    prec = prec or C.Precision()
    get = layer_params or (lambda i: params["layers"][i])
    x = params["embed"][tokens.long()]
    states = []
    for i in range(cfg["n_layers"]):
        x, lat = layer(prec, cfg, get(i), x)
        states.append({"attn": {"latent": lat}})
    lg = C.logits(prec, x[:, -1], params["final_norm"], params["lm_head"],
                  cfg["norm_eps"])
    return lg, C.decode_state(tokens, states)
