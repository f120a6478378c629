"""Offline mode end-to-end on the PyTorch port: feature computation ->
LM training (the port's counterpart of ``offline_training.py``).

The offline engine computes features over history (the same compiled
script the online engine serves), and the training substrate runs a
real multi-step LM training loop (the microbatched train step) with
checkpointing, gradient compression, and a restore.  Runs on the card
unless ``--device cpu``; checkpoints go to ``--ckpt-dir``.

Run:  PYTHONPATH=src python examples/torch_offline_training.py \
          [--steps N] [--device cpu] [--ckpt-dir DIR]
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import reduced
from repro_torch.core import compile_script, parse
from repro_torch.data.pipeline import FeatureDataPipeline, TokenPipeline
from repro_torch.data.synthetic import make_action_tables
from repro_torch.distributed.compression import int8_compress
from repro_torch.distributed.fault import CheckpointManager, tree_flatten
from repro_torch.models import init_params
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.steps import build_train_step

SQL = """
SELECT
  sum(price) OVER w AS f_spend,
  avg(price) OVER w AS f_avg,
  count(price) OVER w AS f_n,
  max(price) OVER w AS f_max,
  distinct_count(category) OVER w AS f_cats
FROM actions
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 60s PRECEDING AND CURRENT ROW)
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="checkpoints/torch_offline_demo")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    print(f"== 1. offline feature computation (training-side driver) on "
          f"{dev}")
    tables = make_action_tables(n_actions=2000, n_orders=0, n_users=16,
                                with_profile=False)
    cs = compile_script(parse(SQL), tables=tables)
    pipe = FeatureDataPipeline(cs, tables, batch_size=args.batch,
                               device=dev)
    mat = pipe.feature_matrix()
    print(f"   features: {mat.shape} (finite={np.isfinite(mat).all()})")

    print("== 2. LM training loop (checkpoint/restart + compression)")
    base = reduced("llama3-8b")
    cfg = dataclasses.replace(
        base, name="demo-lm", n_layers=args.layers,
        d_model=args.d_model, n_heads=max(4, args.d_model // 32),
        n_kv_heads=max(2, args.d_model // 64),
        head_dim=32, d_ff=args.d_model * 4)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
    n_params = sum(p.numel() for p in tree_flatten(params)[0])
    print(f"   model: {cfg.n_layers}L d={cfg.d_model} "
          f"({n_params / 1e6:.1f}M params)")

    state = adamw_init(params, with_compression=args.compress)
    step_fn = build_train_step(
        cfg, AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=args.steps,
                         weight_decay=0.0),
        n_micro=2, compress=int8_compress if args.compress else None,
        compute_dtype=torch.float32)
    tokens = TokenPipeline(cfg.vocab_size, args.batch, args.seq)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)

    def batch_of(b):
        return {"tokens": torch.from_numpy(b["tokens"]).to(dev)}

    losses = []
    t0 = time.time()
    for batch in tokens.batches(args.steps):
        state, metrics = step_fn(state, batch_of(batch))
        losses.append(float(metrics["loss"]))
        step = int(metrics["step"])
        if step % 10 == 0:
            mgr.save(step, state)
            print(f"   step {step:4d} loss={losses[-1]:.4f} "
                  f"({(time.time() - t0) / step:.2f}s/step)")

    print(f"== 3. loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(drop {losses[0] - losses[-1]:.3f})")
    assert losses[-1] < losses[0]

    print("== 4. simulated failure: restore from checkpoint and continue")
    state2 = mgr.restore(state)
    state2, metrics = step_fn(state2, batch_of(tokens.batch_at(0)))
    print(f"   resumed at step {int(metrics['step'])} "
          f"loss={float(metrics['loss']):.4f}")
    return losses


if __name__ == "__main__":
    main()
