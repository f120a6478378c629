"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs real steps of the microbatched train step (``train.steps``) on the
card unless ``--device cpu``: random f32 weights from seed 0
(``reduced(arch)`` unless ``--full``), ``TokenPipeline`` batches, f32
compute as the reference's driver, checkpoint/restart through
``CheckpointManager`` and straggler bookkeeping.  As in the reference's
launcher, the token stream starts at batch 0 in every run: a run resumed
from step ``k`` trains steps ``k+1 ..`` on batches 0, 1, ...  The
reference builds a mesh over the visible devices; here
``--data-parallel N`` trains on an (N, 1) ("data", "model") mesh: each
microbatch's rows in N blocks, one on each of the first N visible cards
(or, with fewer cards visible, on ``--device`` repeated N times, which
it says), the update on ``--device`` (``train.steps``); an MoE model's
blocks keep the (token, expert) pairs the whole microbatch keeps.
"""

# lint: module-ok J002 — host-eager driver: the training loop deliberately
# syncs step counters/metrics to the host between steps.
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get, reduced
from ..data.pipeline import TokenPipeline
from ..distributed.compression import int8_compress
from ..distributed.fault import CheckpointManager, StragglerMitigator
from ..distributed.sharding import Mesh, cuda_devices
from ..kernels.dispatch import resolve_device
from ..models import init_params
from ..train.optimizer import AdamWConfig, adamw_init
from ..train.steps import build_train_step


def main(argv=None):
    """Train; returns the final ``TrainState``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-parallel", type=int, default=1)
    args = ap.parse_args(argv)

    cfg = reduced(args.arch) if args.reduced else get(args.arch)
    dev = resolve_device(args.device)
    print(f"[train] arch={cfg.name} params={cfg.n_params():,} "
          f"device={dev}")
    dp = {}
    if args.data_parallel > 1:
        n = args.data_parallel
        cards = cuda_devices() if dev.type == "cuda" else []
        if len(cards) >= n:
            devs = cards[:n]
        else:
            devs = [dev] * n
            print(f"[train] {len(cards)} cards visible for "
                  f"--data-parallel {n}: the {n} data blocks all run on "
                  f"{dev}")
        mesh = Mesh(np.array([[d] for d in devs], dtype=object),
                    ("data", "model"))
        dp = dict(dp_axes=("data",), mesh=mesh)
        print(f"[train] data parallel over {[str(d) for d in devs]}")

    gen = torch.Generator(device=dev).manual_seed(0)
    state = adamw_init(init_params(cfg, gen, dtype=torch.float32,
                                   device=dev),
                       with_compression=args.compress)
    mgr = CheckpointManager(args.ckpt_dir)
    if args.resume and mgr.latest_step() is not None:
        state = mgr.restore(state)
        print(f"[train] resumed from step {int(state.step)}")

    step_fn = build_train_step(
        cfg, AdamWConfig(lr=args.lr, warmup_steps=10,
                         total_steps=args.steps, weight_decay=0.0),
        n_micro=args.n_micro,
        compress=int8_compress if args.compress else None,
        compute_dtype=torch.float32, **dp)
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq)
    strag = StragglerMitigator(n_hosts=1)

    for batch in pipe.batches(args.steps - int(state.step)):
        tokens = torch.from_numpy(batch["tokens"]).to(dev)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, {"tokens": tokens})
        step = int(metrics["step"])           # waits for the step
        dt = time.perf_counter() - t0
        strag.observe({0: dt})
        if step % 10 == 0 or step == args.steps:
            print(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} {dt:.2f}s")
        if step % args.ckpt_every == 0:
            mgr.save(step, state)
    mgr.save(int(state.step), state)
    print(f"[train] done at step {int(state.step)}; "
          f"stragglers={strag.stragglers()}")
    return state


if __name__ == "__main__":
    main()
