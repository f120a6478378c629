"""Multi-pod dry run: every (arch x shape x mesh) cell's step built from
shapes only, placed by the sharding rules, and counted — the roofline
inputs of ``roofline.report``.

The reference lowers and compiles each cell for 512 virtual XLA devices
and reads the compiled HLO.  The port has no compiler to ask: it builds
the params, the optimizer state, the batch and the decode cache on the
``meta`` device (shapes and dtypes, no storage), takes their specs from
``distributed.sharding`` (``param_pspecs``, ``batch_pspec``,
``cache_pspecs``) over a production ``Mesh`` of 256 or 512 ``meta``
entries (``launch.mesh.make_production_mesh(device="meta")``; no
environment flag, no cards), and runs one step on ``meta`` under
``roofline.analyze_step``.  Everything runs on the host, in seconds per
cell; importing this module touches no device.

Record conventions (the reference's keys; ``null`` where eager torch has
no counterpart, with the reason in ``notes``):

  * ``memory.argument_bytes`` — what one device holds of the step's
    arguments under their specs (``sharding.per_device_bytes``): the
    train state and the batch for train, the params and the batch for
    prefill, the params, the cache and the token for decode;
  * ``flops_loop_aware`` / ``hbm_bytes_loop_aware`` / ``collectives`` —
    the counted step divided by the device count (per device, as the
    reference's post-SPMD numbers are).  A train step is one microbatch's
    forward and backward counted once and multiplied by ``n_micro`` (the
    reference's loop multiplier), plus one AdamW update.  The eager count
    runs every loop, so ``loops`` / ``unknown_loops`` are empty; the
    bytes are eager torch's op-by-op traffic (see
    ``roofline.trace_analyzer``), and on ``meta`` no copy crosses
    devices, so the collectives are 0;
  * ``temp_bytes``, ``peak_bytes``, ``output_bytes``, ``hlo_flops``,
    ``hlo_bytes``, ``lower_s``, ``compile_s``, ``hlo_lines``,
    ``hlo_parse_s`` — XLA's memory and cost analyses and compile times:
    null;
  * added: ``dtype`` (the step's compute dtype, which picks the peak in
    ``roofline.report``), ``count_s`` (the count's seconds) and
    ``kernels`` (the hand-written kernels' cost records in the step).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape decode_32k [--multi-pod] [--out results/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --out results/dryrun_torch
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from ..configs import ARCHS, SHAPES, get
from ..distributed import runtime
from ..distributed.fault import tree_map
from ..distributed.sharding import (PartitionSpec as P, batch_pspec,
                                    cache_pspecs, device_put,
                                    named_shardings, param_pspecs,
                                    per_device_bytes)
from ..models import (decode_step, forward_prefill, init_decode_state,
                      init_params, model_input_spec)
from ..roofline import StepCost, StepCounter
from ..train.optimizer import AdamWConfig, TrainState, adamw_init, \
    adamw_update
from ..train.steps import default_n_micro, loss_and_grads
from .mesh import make_production_mesh

__all__ = ["dryrun_cell", "count_train_step", "main"]

META = torch.device("meta")
NOTES = ("eager torch has no compiler: temp_bytes, peak_bytes, "
         "output_bytes, hlo_flops, hlo_bytes, lower_s, compile_s, "
         "hlo_lines and hlo_parse_s (XLA's memory and cost analyses) are "
         "null; argument_bytes is the per-device bytes of the arguments "
         "under their specs; flops and bytes are one eager step on meta "
         "(roofline.analyze_step; train: one microbatch x n_micro + the "
         "update) divided by the device count")


def _meta_batch(spec):
    return {k: torch.empty(shape, dtype=dtype, device=META)
            for k, (shape, dtype) in spec.items()}


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _count(fn):
    with StepCounter() as counter:
        out = fn()
    return counter.result(), out


# (config, shape) -> its step's count: the same on every mesh (the specs
# place the step's tensors, they do not change its work), so ``--all``
# and ``--both-meshes`` count each step once
_COSTS = {}


def _count_once(cfg, shape, count, n_micro=1):
    key = (repr(cfg), repr(shape), n_micro)
    if key not in _COSTS:
        _COSTS[key] = count()
    return _COSTS[key]


def count_train_step(cfg, state: TrainState, batch, n_micro: int,
                     opt_cfg: Optional[AdamWConfig] = None,
                     dtype=torch.bfloat16) -> StepCost:
    """The count of one ``build_train_step`` step from one microbatch:
    its forward and backward counted once and multiplied by ``n_micro``
    (every microbatch has the same shape, so the same count), plus one
    AdamW update over the f32 accumulated gradients.  The step runs
    where ``state`` lies (``meta`` in the dry run)."""
    mb = next(iter(batch.values())).shape[0] // n_micro
    micro = {k: v[:mb] for k, v in batch.items()}
    grads_cost, (_, grads) = _count(lambda: loss_and_grads(
        cfg, state.params, micro, 1, dtype))
    if n_micro > 1:
        # the step accumulates the microbatches' gradients in f32
        grads = tree_map(lambda g: g.to(torch.float32), grads)
    update_cost, _ = _count(lambda: adamw_update(
        state, grads, opt_cfg or AdamWConfig()))
    return StepCost(
        flops=grads_cost.flops * n_micro + update_cost.flops,
        hbm_bytes=grads_cost.hbm_bytes * n_micro + update_cost.hbm_bytes,
        collectives={k: v * n_micro + update_cost.collectives[k]
                     for k, v in grads_cost.collectives.items()},
        loops=[], unknown_loops=[],
        kernels={k: {f: v * n_micro for f, v in rec.items()}
                 for k, rec in grads_cost.kernels.items()})


def _train(cfg, shape, params, p_specs, mesh, record):
    n_micro = default_n_micro(cfg, shape)
    record["n_micro"] = n_micro
    state = adamw_init(params)
    # optimizer state shards like the params (ZeRO-3)
    s_specs = TrainState(step=P(), params=p_specs, mu=p_specs, nu=p_specs,
                         compress_err=tree_map(lambda _: P(),
                                               state.compress_err))
    batch = _meta_batch(model_input_spec(cfg, shape))
    arg_bytes = per_device_bytes((state, batch),
                                 (s_specs, batch_pspec(batch, mesh)), mesh)
    return arg_bytes, _count_once(cfg, shape, lambda: count_train_step(
        cfg, state, batch, n_micro), n_micro)


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool,
                strategy: str = "auto", sharded_decode: bool = False,
                overrides=None):
    """Build one cell's step on ``meta`` and count it; return the
    roofline record (see the module docstring)."""
    cfg = get(arch)
    shape = SHAPES[shape_name]
    if shape_name not in cfg.applicable_shapes():
        return {"arch": arch, "shape": shape_name,
                "mesh": _mesh_name(multi_pod), "status": "SKIP",
                "reason": "quadratic attention at 500k context "
                          "(DESIGN.md §4 applicability)"}

    mesh = make_production_mesh(multi_pod=multi_pod, device=META)
    n_dev = mesh.devices.size
    t0 = time.time()
    params = init_params(cfg, torch.Generator(), dtype=torch.bfloat16,
                         device=META)
    p_specs = param_pspecs(cfg, params, mesh, overrides=overrides,
                           strategy=strategy)
    record = {"arch": arch, "shape": shape_name,
              "mesh": _mesh_name(multi_pod), "n_devices": n_dev,
              "strategy": strategy, "sharded_decode": sharded_decode,
              "dtype": "bfloat16"}
    with runtime.use_mesh(mesh if (sharded_decode and shape.kind == "decode")
                          else None):
        if shape.kind == "train":
            arg_bytes, cost = _train(cfg, shape, params, p_specs, mesh,
                                     record)
        elif shape.kind == "prefill":
            batch = _meta_batch(model_input_spec(cfg, shape))
            arg_bytes = per_device_bytes(
                (params, batch), (p_specs, batch_pspec(batch, mesh)), mesh)
            cost = _count_once(cfg, shape, lambda: _count(
                lambda: forward_prefill(cfg, params, batch,
                                        cache_capacity=shape.seq_len))[0])
        else:
            cache = init_decode_state(cfg, shape.global_batch,
                                      shape.seq_len, device=META)
            tok = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                              device=META)
            c_specs = cache_pspecs(cfg, cache, mesh)
            arg_bytes = per_device_bytes(
                (params, cache, tok),
                (p_specs, c_specs, batch_pspec(tok, mesh)), mesh)
            if sharded_decode:
                # the cache in pieces before the step, as the reference's
                # in_shardings place it (no placement inside the count)
                cache = device_put(cache, named_shardings(c_specs, mesh))

            def count():
                return _count(lambda: decode_step(cfg, params, cache,
                                                  tok))[0]
            # a sequence-sharded decode's count depends on the mesh
            cost = count() if sharded_decode else \
                _count_once(cfg, shape, count)

    record["memory"] = {"argument_bytes": arg_bytes, "output_bytes": None,
                        "temp_bytes": None, "peak_bytes": None}
    record.update({
        "hlo_flops": None, "hlo_bytes": None, "lower_s": None,
        "compile_s": None,
        "collectives": {k: v / n_dev for k, v in cost.collectives.items()},
        "flops_loop_aware": cost.flops / n_dev,
        "hbm_bytes_loop_aware": cost.hbm_bytes / n_dev,
        "loops": [], "unknown_loops": [], "hlo_parse_s": None,
        "hlo_lines": None, "kernels": cost.kernels,
        "count_s": round(time.time() - t0, 1), "notes": NOTES,
        "status": "OK"})
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--sharding", default="auto",
                    choices=["auto", "megatron", "megatron_zero",
                             "embed_fix"])
    ap.add_argument("--sharded-decode", action="store_true")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    n_fail = 0
    for arch, shape, mp in cells:
        tag = f"{arch}__{shape}__{_mesh_name(mp)}"
        path = outdir / f"{tag}.json"
        if path.exists():
            print(f"[skip existing] {tag}")
            continue
        print(f"[dryrun] {tag} ...", flush=True)
        try:
            rec = dryrun_cell(arch, shape, mp, strategy=args.sharding,
                              sharded_decode=args.sharded_decode)
        except Exception as e:  # noqa: BLE001 — record and continue
            rec = {"arch": arch, "shape": shape, "mesh": _mesh_name(mp),
                   "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            n_fail += 1
        path.write_text(json.dumps(rec, indent=2))
        status = rec["status"]
        extra = ""
        if status == "OK":
            gb = rec["memory"]["argument_bytes"] / 1e9
            extra = (f" flops/dev={rec['flops_loop_aware']:.3e} "
                     f"bytes/dev={rec['hbm_bytes_loop_aware']:.3e} "
                     f"args/dev={gb:.2f}GB ({rec['count_s']}s count)")
        print(f"[{status}] {tag}{extra}", flush=True)
    print(f"done; {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
