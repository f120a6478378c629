"""Roofline report: three terms per (arch x shape) from the dry-run
records (``launch.dryrun``), the dominant bottleneck, and the
MODEL_FLOPS ratio — the reference's ``roofline/report.py`` over the
port's configs and the H100's peaks.

    compute term    = flops_per_device / peak_flops          [s]
    memory term     = hbm_bytes_per_device / hbm_bw          [s]
    collective term = coll_bytes_per_device / link_bw        [s]

The numerators come from ``roofline.analyze_step`` over one eager step
on ``meta`` (a train step: one microbatch times ``n_micro``), divided by
the device count (``launch.dryrun``), so dividing by per-card peaks
gives the same seconds as global / (cards x peak).  The roofline
fraction is MFU-like:

    fraction = ideal_compute_time / max(three terms)
    ideal_compute_time = MODEL_FLOPS_per_device / peak_flops

MODEL_FLOPS convention: train = 6*N_active*tokens; prefill =
2*N_active*tokens; decode = 2*N_active*batch + attention cache reads
(2*2*L*ctx*kv_dim*d_head-ish, folded into n_active for SSM).  Embedding
lookup excluded, lm_head matmul included (it is in n_params).

Peaks: NVIDIA's H100 data sheet, SXM part, dense (no sparsity), at its
700 W power limit — bf16 tensor cores 989 TFLOP/s (67 TFLOP/s float32
for a record whose ``dtype`` is float32), HBM3 3.35 TB/s, NVLink 450 GB/s
each way.  A card run below 700 W is slower under load; the peaks are
not derated for it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

from ..configs import SHAPES, get

PEAK_FLOPS = 989e12       # bf16 dense tensor-core FLOP/s, H100 SXM
PEAK_FLOPS_F32 = 67e12    # float32 FLOP/s, H100 SXM
HBM_BW = 3.35e12          # B/s, H100 SXM HBM3
NVLINK_BW = 450e9         # B/s each way, H100 SXM NVLink

__all__ = ["model_flops", "cell_report", "load_records", "make_table"]


def model_flops(arch: str, shape_name: str) -> float:
    """Global useful FLOPs per step (see module docstring)."""
    return model_flops_of(get(arch), SHAPES[shape_name])


def model_flops_of(cfg, shape) -> float:
    """``model_flops`` of a config and a ``ShapeSpec`` that need not be
    in the registry (a step run at another batch or length)."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        base = 6.0 * n * shape.tokens
        attn = _attn_flops(cfg, shape.seq_len, shape.global_batch,
                           causal=True) * 3  # fwd + bwd(2x)
        return base + attn
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens + _attn_flops(
            cfg, shape.seq_len, shape.global_batch, causal=True)
    # decode: one token per sequence + attention over the live cache
    base = 2.0 * n * shape.global_batch
    attn = _decode_attn_flops(cfg, shape.seq_len, shape.global_batch)
    return base + attn


def _attn_flops(cfg, s, b, causal=True) -> float:
    if cfg.attn_type == "none":
        # linear recurrence: ~2 * d_head per (token, head) state update
        h, dh = cfg.n_heads, cfg.head_dim or 64
        return 4.0 * cfg.n_layers * b * s * h * dh * dh
    dh = cfg.head_dim or cfg.d_model // cfg.n_heads
    full = 4.0 * cfg.n_layers * b * s * s * cfg.n_heads * dh
    return full / 2 if causal else full


def _decode_attn_flops(cfg, ctx, b) -> float:
    if cfg.attn_type == "none":
        h, dh = cfg.n_heads, cfg.head_dim or 64
        return 4.0 * cfg.n_layers * b * h * dh * dh
    dh = cfg.head_dim or cfg.d_model // cfg.n_heads
    window = ctx
    if cfg.sliding_window and cfg.global_attn_every:
        n_glob = len(range(0, cfg.n_layers, cfg.global_attn_every)) + 1
        frac = n_glob / cfg.n_layers
        window = ctx * frac + cfg.sliding_window * (1 - frac)
    return 4.0 * cfg.n_layers * b * window * cfg.n_heads * dh


def load_records(dirpath: str) -> List[Dict]:
    out = []
    for p in sorted(Path(dirpath).glob("*.json")):
        out.append(json.loads(p.read_text()))
    return out


def cell_report(rec: Dict) -> Optional[Dict]:
    if rec.get("status") != "OK":
        return None
    arch, shape = rec["arch"], rec["shape"]
    chips = rec["n_devices"]
    flops_dev = rec.get("flops_loop_aware", rec.get("hlo_flops", 0.0))
    hbm_dev = rec.get("hbm_bytes_loop_aware", rec.get("hlo_bytes", 0.0))
    coll_dev = rec.get("collectives", {}).get("total", 0.0)

    peak = PEAK_FLOPS_F32 if rec.get("dtype") == "float32" else PEAK_FLOPS
    t_compute = flops_dev / peak
    t_memory = hbm_dev / HBM_BW
    t_coll = coll_dev / NVLINK_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)

    mf = model_flops(arch, shape)
    mf_dev = mf / chips
    ideal = mf_dev / peak
    bound = max(terms.values())
    return {
        "arch": arch, "shape": shape, "mesh": rec["mesh"],
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops_global": mf,
        "useful_ratio": (mf_dev / flops_dev) if flops_dev else 0.0,
        "roofline_fraction": (ideal / bound) if bound else 0.0,
        "peak_bytes": (rec.get("memory") or {}).get("peak_bytes"),
        "temp_bytes": (rec.get("memory") or {}).get("temp_bytes"),
        "n_micro": rec.get("n_micro"),
    }


def make_table(dirpath: str, mesh: str = "16x16") -> str:
    """Markdown roofline table over all OK records of one mesh."""
    rows = []
    skips = []
    for rec in load_records(dirpath):
        if rec["mesh"] != mesh:
            continue
        if rec.get("status") == "SKIP":
            skips.append((rec["arch"], rec["shape"], rec["reason"]))
            continue
        r = cell_report(rec)
        if r:
            rows.append(r)
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    hdr = ("| arch | shape | compute s | memory s | collective s | "
           "dominant | useful ratio | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|\n")
    body = ""
    for r in rows:
        body += (f"| {r['arch']} | {r['shape']} | "
                 f"{r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} | "
                 f"{r['t_collective_s']:.3e} | {r['dominant']} | "
                 f"{r['useful_ratio']:.3f} | "
                 f"{r['roofline_fraction']:.3f} |\n")
    if skips:
        body += "\nSkipped cells (documented):\n"
        for a, s, why in skips:
            body += f"- {a} x {s}: {why}\n"
    return hdr + body


if __name__ == "__main__":
    import sys

    d = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_torch"
    print(make_table(d))
