"""Plain float32 building blocks shared by the references.

Written from the architectures' published equations, not from the
program: no import of the program, no kernel, no cache.  Every product
goes through ``Precision.mm`` / ``Precision.einsum`` so that the control
(the same reference with its products' operands in float8 e4m3, per
tensor scaled, float32 accumulation) runs the same code.  TF32 is off for
as long as a reference runs (``exact_float32``).
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

F32 = torch.float32
E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """Float32 products without TF32, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


class _Fp8(torch.autograd.Function):
    """x rounded to float8 e4m3 under a per-tensor scale (amax / 448);
    the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = amax / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


class Precision:
    """The products of a reference: float32 (``fp8=False``), or with both
    operands rounded to float8 e4m3 first (the control)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(x) if self.fp8 else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.q(x) @ self.q(w)

    def einsum(self, spec: str, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
        return torch.einsum(spec, self.q(a), self.q(b))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding of x (B, S, H, D) at ``positions`` (S,): the first
    and second halves of the last axis rotate as pairs."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=F32, device=x.device) / half)
    ang = positions.to(F32)[:, None] * freqs
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(prec: Precision, q, k, v, window: int = 0,
              block: int = 1024) -> torch.Tensor:
    """Causal softmax attention, f32, in blocks of query rows, each
    against the keys it may see.
    q (B, S, Hq, D), k (B, S, Hkv, D), v (B, S, Hkv, Dv), query head h
    reading KV head h // (Hq / Hkv); ``window`` > 0 keeps the keys fewer
    than ``window`` positions older than the query.  Scale D^-0.5."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    pos = torch.arange(s, device=q.device)
    outs = []
    for lo in range(0, s, block):
        hi = min(lo + block, s)
        k0 = max(0, lo - window + 1) if window else 0
        qp = pos[lo:hi, None]
        kp = pos[None, k0:hi]
        keep = kp <= qp
        if window:
            keep = keep & (qp - kp < window)
        sc = prec.einsum("bqhd,bkhd->bhqk", q[:, lo:hi], k[:, k0:hi])
        sc = (sc * d ** -0.5).masked_fill(~keep, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        outs.append(prec.einsum("bhqk,bkhd->bqhd", p, v[:, k0:hi]))
    return torch.cat(outs, dim=1)


def swiglu(prec: Precision, x, w_gate, w_up, w_down):
    return prec.mm(F.silu(prec.mm(x, w_gate)) * prec.mm(x, w_up), w_down)


def logits(prec: Precision, x, final_norm, lm_head, eps: float):
    return prec.mm(rms_norm(x, final_norm, eps), lm_head)


def next_token_loss(lg: torch.Tensor, tokens: torch.Tensor,
                    vocab: int) -> torch.Tensor:
    """Mean cross entropy of position t predicting token t + 1 over the
    real vocabulary (columns past ``vocab`` are padding)."""
    pred = lg[:, :-1, :vocab]
    return F.cross_entropy(pred.reshape(-1, vocab),
                           tokens[:, 1:].reshape(-1).long())


def decode_state(tokens: torch.Tensor, layers: List) -> dict:
    """A prefill's state: each row's length (every prompt whole) and the
    layers' states."""
    b, s = tokens.shape
    return {"len": torch.full((b,), s, dtype=torch.int32,
                              device=tokens.device), "layers": layers}


# ---------------------------------------------------------------------------
# AdamW as the configurations state it
# ---------------------------------------------------------------------------


def flat(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) of a params tree in a fixed order: dict keys sorted,
    list items in order (a layer's path is ``layers.<i>.<name>``)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in
                flat(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [kv for i, t in enumerate(tree) for kv in
                flat(t, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def decayed(path: str, leaf: torch.Tensor) -> bool:
    """Weight decay applies to a leaf of rank above 1, counting a layer's
    leaf one rank more (the layers stacked on a leading axis)."""
    stacked = 1 if path.startswith(("layers.", "enc_layers.")) else 0
    return leaf.dim() + stacked > 1


class AdamW:
    """Clip by the global norm of the gradients, then AdamW with the
    decay added to the Adam direction; linear warm-up, then a cosine to a
    tenth of ``lr``.  ``params`` is a list of (path, f32 tensor), updated
    in place."""

    def __init__(self, params, lr, b1, b2, eps, weight_decay, grad_clip,
                 warmup_steps, total_steps):
        self.params = params
        self.h = dict(lr=lr, b1=b1, b2=b2, eps=eps, wd=weight_decay,
                      clip=grad_clip, warm=warmup_steps, total=total_steps)
        self.mu = [torch.zeros_like(p) for _, p in params]
        self.nu = [torch.zeros_like(p) for _, p in params]
        self.step = 0

    def lr(self, t: float) -> float:
        h = self.h
        warm = min(t / max(h["warm"], 1), 1.0)
        frac = min(max((t - h["warm"]) / max(h["total"] - h["warm"], 1),
                       0.0), 1.0)
        return h["lr"] * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(
            math.pi * frac)))

    def update(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """One step; returns the clipped gradients as Adam took them."""
        h = self.h
        self.step += 1
        t = float(self.step)
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        scale = torch.clamp(h["clip"] / torch.clamp(norm, min=1e-12),
                            max=1.0)
        lr, bc1, bc2 = self.lr(t), 1 - h["b1"] ** t, 1 - h["b2"] ** t
        taken = []
        for (path, p), g, m, v in zip(self.params, grads, self.mu, self.nu):
            g = g * scale
            taken.append(g)
            m.mul_(h["b1"]).add_((1 - h["b1"]) * g)
            v.mul_(h["b2"]).add_((1 - h["b2"]) * g.square())
            direction = (m / bc1) / (torch.sqrt(v / bc2) + h["eps"])
            if decayed(path, p):
                direction = direction + h["wd"] * p
            p.sub_(lr * direction)
        return taken


def norm_of(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.to(F32)))

