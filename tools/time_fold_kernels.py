"""Time one checkout's unit-fold and batched-window-fold CUDA kernels at
the main paths' shapes, through that checkout's own ``chip_smoke.py``.

    python3 tools/time_fold_kernels.py [--root DIR] [--reps N] [--json PATH]

``DIR`` is the root of a checkout: this one (the default) or an unpacked
earlier commit.  Its ``chip_smoke.py`` and ``src`` are imported, and its
own ``fold_block`` and ``check_unit_fold`` build, check (bitwise against
the plain version, two runs equal) and time every fold, so two designs
with different wrapper contracts can be timed in turns on one card in
one call, one process per checkout.  Needs a CUDA card; prints one line
per shape and, with ``--json``, writes every number there.

Shapes: the unit fold of ``SMOKE_SQL``'s two window groups (``w``: 513
rows per unit, ``wr``: 257) at one query per unit for B = 256 units
(serving) and U = 1 (the consistency replay), and at Q = rp for offline
units of 2,048 (U = 64), 8,192 (U = 8), 16,384 (U = 4) and 32,768
(U = 2) rows; ``batch_windowfold_cuda`` over a store of 1,495,648 live
rows (capacity 1.6 M, 100 keys sorted by (key, ts), F = 2) at B = 1, 64,
256 requests of a 60 s frame near the end of the horizon, with a digest
of the result bits so two checkouts' results can be compared.  Inputs
come from fixed seeds; times are ``chip_smoke.cuda_ms`` device times.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import pathlib
import sys

import numpy as np
import torch

FOLD_SHAPES = (("serving", 256, None, 1), ("replay", 1, None, 1),
               ("offline", 64, 2048, None), ("offline", 8, 8192, None),
               ("offline", 4, 16384, None), ("offline", 2, 32768, None))
STORE_ROWS, CAPACITY, N_KEYS, HORIZON_MS = 1_495_648, 1_600_000, 100, \
    36_000_000


def time_unit_fold(smoke, dev, reps):
    from repro_torch.core import compile_script
    from repro_torch.core.lowering.windows import group_windows
    from repro_torch.data.synthetic import make_action_tables

    small = make_action_tables(n_actions=64, n_orders=32, n_users=4,
                               horizon_ms=60_000, seed=0,
                               with_profile=False)
    cs = compile_script(smoke.SMOKE_SQL, tables=small)
    groups = {g[0].node.spec.name: g for g in group_windows(cs.windows)}
    out = {}
    for kind, u, rows, nq in FOLD_SHAPES:
        for gname, seed in (("w", 1), ("wr", 2)):
            members = groups[gname]
            r = rows or len(members[0].sources) * max(
                m.online_buffer for m in members) + 1
            q = nq or r
            name = f"{kind}/{gname}/U{u}/R{r}/Q{q}"
            n = reps if u * r * q < 1 << 22 else max(3, reps // 10)
            block = smoke.fold_block(members, u, r, q, seed + r, dev)
            res = smoke.check_unit_fold(name, block, n)
            out[name] = {k: res[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "variant")}
            print(f"unit_fold {name}: ms {res['ms']:.5f} "
                  f"({res['variant']})", flush=True)
            del block
    return out


def store_inputs(dev):
    """A sorted serving store (capacity rows, the live prefix sorted by
    (key, ts)), its (price, 1) lanes and the live count."""
    rng = np.random.default_rng(11)
    keys = np.sort(rng.integers(0, N_KEYS, STORE_ROWS)).astype(np.int32)
    ts = rng.integers(0, HORIZON_MS, STORE_ROWS).astype(np.int32)
    order = np.lexsort((ts, keys))
    keys, ts = keys[order], ts[order]
    pad = CAPACITY - STORE_ROWS
    keys = np.concatenate([keys, np.zeros(pad, np.int32)])
    ts = np.concatenate([ts, np.zeros(pad, np.int32)])
    price = rng.uniform(1, 100, CAPACITY).astype(np.float32)
    vals = np.stack([price, np.ones_like(price)], 1)
    return ([torch.from_numpy(x).to(dev) for x in (keys, ts, vals)],
            torch.tensor(STORE_ROWS, dtype=torch.int32, device=dev))


def time_batch_windowfold(smoke, dev, reps):
    from repro_torch.kernels.batch_windowfold.kernel import \
        batch_windowfold_cuda
    from repro_torch.kernels.batch_windowfold.ref import \
        batch_windowfold_ref

    (keys, ts, vals), count = store_inputs(dev)
    live = torch.arange(CAPACITY, device=dev) < count
    plain_vals = torch.where(live[:, None], vals, 0.0)
    rng = np.random.default_rng(12)
    out = {}
    for b in (1, 64, 256):
        qkey = torch.tensor(rng.integers(0, N_KEYS, b), dtype=torch.int32,
                            device=dev)
        qt1 = torch.tensor(HORIZON_MS - rng.integers(0, 600_000, b),
                           dtype=torch.int32, device=dev)
        args = (keys, ts, vals, qkey, qt1 - smoke.WINDOW_MS, qt1)

        def call():
            return batch_windowfold_cuda(*args, count=count)

        got, again = call(), call()
        name = f"batch_windowfold[B={b}]"
        smoke.same_bits(name, got, again)
        smoke.compare(name, got, batch_windowfold_ref(
            keys, ts, plain_vals, *args[3:]), rtol=1e-5, atol=1e-5)
        ms = smoke.cuda_ms(call, reps)
        passes = smoke.kernel_times(call, 20, ms)
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
        out[f"B{b}"] = {"ms": ms, "kernel_ms": passes,
                        "bits_sha256": digest}
        print(f"batch_windowfold B={b} C={CAPACITY} F=2: ms {ms:.5f}; "
              f"passes (ms) {passes}; bits {digest[:16]}", flush=True)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(
        pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_fold_kernels: no CUDA device available")
    root = pathlib.Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    smoke = importlib.import_module("chip_smoke")
    if pathlib.Path(smoke.__file__).resolve().parent != root:
        raise SystemExit(f"time_fold_kernels: imported {smoke.__file__}, "
                         f"not {root}/chip_smoke.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"== {root} on {torch.cuda.get_device_name(0)}", flush=True)
    res = {"root": str(root),
           "unit_fold": time_unit_fold(smoke, dev, args.reps),
           "batch_windowfold": time_batch_windowfold(smoke, dev, args.reps)}
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
