"""Architecture + shape configuration, copied as data from the JAX
package (the port keeps its own copy and imports nothing of it).

Every architecture is an ``ArchConfig`` instance; ``registry.get(name)``
resolves them (each also has its module ``repro_torch/configs/<id>.py``,
as in the reference).  The four shape cells are
global (``SHAPES``); per-arch applicability is
``ArchConfig.applicable_shapes()``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["MoESpec", "MLASpec", "SSMSpec", "EncDecSpec", "VLMSpec",
           "ArchConfig", "ShapeSpec", "SHAPES", "round_up"]


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN width
    n_shared: int = 0             # always-active shared experts
    capacity_factor: float = 1.25

    @property
    def n_experts_padded(self) -> int:
        """Experts padded to a power-of-two-ish multiple of 16 for mesh
        divisibility; padding experts carry zero weights and -inf router
        logits (never routed)."""
        return round_up(self.n_experts, 16)


@dataclasses.dataclass(frozen=True)
class MLASpec:
    q_rank: int = 768
    kv_rank: int = 256
    rope_dim: int = 32
    nope_dim: int = 64
    v_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    state_dim: int = 16           # per-channel state (hymba)
    conv_dim: int = 4             # depthwise conv width (stubbed as shift)
    expand: int = 2               # d_inner = expand * d_model


@dataclasses.dataclass(frozen=True)
class EncDecSpec:
    n_enc_layers: int = 4
    n_frames: int = 1500          # whisper 30s @ 50Hz (frontend stub)


@dataclasses.dataclass(frozen=True)
class VLMSpec:
    n_patches: int = 576          # anyres base tile (frontend stub)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    attn_type: str = "gqa"        # gqa | mla | none
    qk_norm: bool = False
    sliding_window: int = 0       # >0: SWA width on local layers
    global_attn_every: int = 0    # >0: layer i is global iff i % this == 0
    moe: Optional[MoESpec] = None
    mla: Optional[MLASpec] = None
    ssm: Optional[SSMSpec] = None
    encdec: Optional[EncDecSpec] = None
    vlm: Optional[VLMSpec] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    source: str = ""              # provenance [source; verified-tier]

    def __post_init__(self):
        if self.head_dim is None and self.attn_type == "gqa":
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Pad vocab to a multiple of 128 (MXU lanes + mesh divisibility)."""
        return round_up(self.vocab_size, 128)

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can serve 500k-token contexts (SSM / hybrid
        with bounded attention)."""
        return self.family in ("ssm", "hybrid")

    def applicable_shapes(self) -> Tuple[str, ...]:
        out = ["train_4k", "prefill_32k", "decode_32k"]
        if self.sub_quadratic:
            out.append("long_500k")
        return tuple(out)

    def n_params(self) -> int:
        """Total parameter count (counts all experts)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hq = self.n_heads * (self.head_dim or d // self.n_heads)
        hkv = self.n_kv_heads * (self.head_dim or d // self.n_heads)
        embed = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.attn_type == "gqa":
            per_layer += d * hq * 2 + d * hkv * 2      # q,o + k,v
        elif self.attn_type == "mla":
            m = self.mla
            per_layer += d * m.q_rank
            per_layer += m.q_rank * self.n_heads * (m.nope_dim + m.rope_dim)
            per_layer += d * (m.kv_rank + m.rope_dim)
            per_layer += m.kv_rank * self.n_heads * (m.nope_dim + m.v_dim)
            per_layer += self.n_heads * m.v_dim * d
        if self.family == "ssm":  # rwkv6: r,k,v,g,w,o + channel mix
            per_layer += d * d * 5 + d * d
            per_layer += d * f + f * d                  # channel mix
        elif self.moe is not None:
            e = self.moe
            per_layer += d * e.n_experts                # router
            per_layer += e.n_experts * d * e.d_expert * 3
            if e.n_shared:
                per_layer += d * e.d_expert * e.n_shared * 3
        else:
            per_layer += d * f * 3                      # SwiGLU
        if self.ssm is not None and self.family == "hybrid":
            di = self.ssm.expand * d
            per_layer += d * di * 2 + di * d + di * self.ssm.state_dim * 2
        per_layer += 2 * d                              # norms
        total = embed + L * per_layer
        if self.encdec is not None:
            total += self.encdec.n_enc_layers * per_layer
            total += L * (d * hq + d * hkv * 2 + hq * d)  # cross-attn
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed + shared experts)."""
        if self.moe is None:
            return self.n_params()
        e = self.moe
        d, L = self.d_model, self.n_layers
        inactive = (e.n_experts - e.top_k) * d * e.d_expert * 3 * L
        return int(self.n_params() - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
