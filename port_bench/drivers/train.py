"""Traffic kind ``train``: whole steps of the program's microbatched
train step (``train.steps.build_train_step``, driven as
``launch/train.py`` drives it: a host batch of token ids moved to the
card, the step called, its step counter read back).

Set-up draws the f32 master weights from the seed, builds the optimizer
state (``train.optimizer.adamw_init``) and runs the first two steps,
which are the warm-up and the steps that are checked: after the first,
each leaf's gradient norm as AdamW took it (its first moment over
1 - b1); after the second, each leaf's change from the drawn weights.
The window runs steps 3, 4, ... until ``--seconds`` have passed.  After
the window and the program's state are gone, the plain reference follows
the same two steps from the same weights and tokens (two and not three,
so that it takes less time than the window).

Every step's tokens are drawn from (seed, step): uniform ids of the real
vocabulary, so every row of every step differs.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict

import numpy as np
import torch

from .. import judge, weights
from ..faults import plant
from ..counts import flops
from ..reference import common as C

CHECKED_STEPS = 2


def tokens(cell, step: int) -> np.ndarray:
    t = cell.traffic
    rng = np.random.default_rng([cell.seed % (1 << 64), 7, step])
    return rng.integers(0, cell.cfg["vocab_size"],
                        size=(t["batch"], t["seq_len"]), dtype=np.int32)


def opt_kwargs(cell) -> Dict:
    return dict(cell.cfg["optimizer"])


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


class Program:
    """The system under test: the program's train step and its state."""

    def __init__(self, cell):
        from repro_torch.train.optimizer import AdamWConfig, adamw_init
        from repro_torch.train.steps import build_train_step

        self.cell = cell
        t = cell.traffic
        dtype = getattr(torch, cell.cfg["compute_dtype"])
        self.step_fn = build_train_step(
            cell.arch, AdamWConfig(**opt_kwargs(cell)),
            n_micro=t["n_micro"], compute_dtype=dtype)
        params = weights.draw(cell.layout, cell.seed, torch.float32,
                              cell.device)
        self.state = adamw_init(params)
        del params
        self.restore = []
        if cell.trace:
            self._span_calls()

    def _span_calls(self):
        """Spans around the step's two calls into the program's layers
        below it, the forward and backward and the optimizer, for as long
        as this program lives (traced runs only)."""
        import repro_torch.train.steps as steps

        for name, span in (("loss_and_grads", "forward_backward"),
                           ("adamw_update", "optimizer")):
            orig = getattr(steps, name)

            def spanned(*a, _orig=orig, _span=span, **k):
                with self.cell.span(_span):
                    return _orig(*a, **k)

            self.restore.append((steps, name, orig))
            setattr(steps, name, spanned)

    def step(self, tok: np.ndarray):
        with self.cell.span("feed"):
            batch = {"tokens": torch.from_numpy(tok).to(self.cell.device)}
        with self.cell.span("train_step"):
            self.state, metrics = self.step_fn(self.state, batch)
        with self.cell.span("step_counter"):
            int(metrics["step"])                    # waits for the step
        return metrics

    def close(self):
        for mod, name, orig in self.restore:
            setattr(mod, name, orig)
        self.restore = []
        self.state = None
        self.step_fn = None


def program_readings(cell, prog: Program) -> Dict:
    """The checked steps through the program."""
    b1 = cell.cfg["optimizer"]["b1"]
    losses, grad1 = [], {}
    for s in range(1, CHECKED_STEPS + 1):
        m = prog.step(tokens(cell, s))
        losses.append(float(m["loss"]))
        if s == 1:
            grad1 = {p: C.norm_of(t) / (1 - b1) for p, t in
                     C.flat(prog.state.mu)}
    params = dict(C.flat(prog.state.params))
    change = {}
    for g in weights.groups(cell.layout):
        p0 = weights.draw_group(cell.layout, cell.seed, g, torch.float32,
                                cell.device)
        for path, t0 in C.flat(p0, ".".join(map(str, g)) + "."):
            change[path] = C.norm_of(params[path] - t0)
        del p0
    return {"loss": losses, "grad1": grad1, "change": change}


# ---------------------------------------------------------------------------
# the reference (and the control: the reference in float8)
# ---------------------------------------------------------------------------


def reference_readings(cell, fp8: bool = False) -> Dict:
    """The same steps through the plain reference, f32 (or its
    products in float8 e4m3: the control)."""
    prec = C.Precision(fp8=fp8)
    t = cell.traffic
    n_micro, rows = t["n_micro"], t["batch"] // t["n_micro"]
    with C.exact_float32():
        params = weights.draw(cell.layout, cell.seed, torch.float32,
                              cell.device)
        leaves = C.flat(params)
        for _, p in leaves:
            p.requires_grad_(True)
        opt = C.AdamW([(k, p.data) for k, p in leaves], **opt_kwargs(cell))
        losses, grad1 = [], {}
        for s in range(1, CHECKED_STEPS + 1):
            tok = torch.from_numpy(tokens(cell, s)).to(cell.device)
            total = 0.0
            for i in range(n_micro):
                loss = cell.ref.loss(cell.cfg, params,
                                     tok[i * rows:(i + 1) * rows], prec)
                (loss / n_micro).backward()
                total += float(loss.detach()) / n_micro
            losses.append(total)
            grads = [p.grad for _, p in leaves]
            for _, p in leaves:
                p.grad = None
            taken = opt.update(grads)
            del grads
            if s == 1:
                grad1 = {k: C.norm_of(g) for (k, _), g in zip(leaves, taken)}
            del taken
        change, current = {}, dict(leaves)
        for g in weights.groups(cell.layout):
            p0 = weights.draw_group(cell.layout, cell.seed, g,
                                    torch.float32, cell.device)
            for path, t0 in C.flat(p0, ".".join(map(str, g)) + "."):
                change[path] = C.norm_of(current[path].detach() - t0)
            del p0
    return {"loss": losses, "grad1": grad1, "change": change}


def compare(cell, got: Dict, ref: Dict) -> Dict[str, float]:
    """The readings of the checked steps against the reference's: the
    worst step's relative loss gap; the gap between the two norms of each
    leaf's first gradient and of its change after the checked steps, each
    over the larger of the reference's norm of that leaf and of the median
    leaf, taken by the worst leaf; and the median leaf's first-gradient
    gap.  Leaves whose reference gradient is under a thousandth of the
    median leaf's are left out.  Leaves of one element (hymba's mix
    scalars) have a first-gradient number of their own, the median of
    their gaps: each is one sum over every activation of its layer, whose
    cancellation leaves the bf16 program's rounding at a tenth of the sum
    or more (PERF.md has the f32 program's readings beside it).  The
    workload file's limits name the ones that decide ``correct``."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))
    g_med = float(np.median(list(ref["grad1"].values())))
    kept = [k for k, v in ref["grad1"].items() if v >= 1e-3 * g_med]
    sizes = weights.numels(cell.layout)
    wide = [k for k in kept if sizes[k] > 1]
    scalar = [k for k in kept if sizes[k] == 1]
    gaps = dict(zip(kept, judge.leaf_gaps(got["grad1"], ref["grad1"], kept)))
    out = {"loss_gap": loss,
           "grad1_gap": max(gaps[k] for k in wide),
           "grad1_median_gap": judge.median_leaf_gap(
               got["grad1"], ref["grad1"], wide),
           "change_gap": judge.worst_leaf_gap(got["change"], ref["change"],
                                              kept)}
    if scalar:
        out["grad1_scalar_gap"] = float(np.median([gaps[k] for k in scalar]))
    return out


# ---------------------------------------------------------------------------
# faults, and the readings that set the limits (control.py)
# ---------------------------------------------------------------------------


def _state_unchanged():
    """AdamW writes nothing: the step returns its state as it came."""
    import repro_torch.train.steps as steps
    return [(steps, "adamw_update",
             lambda state, grads, cfg, compress=None: state)]


def _half_batch():
    """The step sees the first half of its rows, the mean over them."""
    import repro_torch.train.steps as steps
    orig = steps.loss_and_grads

    def half(cfg, params, batch, n_micro=1, *a, **k):
        rows = batch["tokens"].shape[0] // 2
        return orig(cfg, params, {n: v[:rows] for n, v in batch.items()},
                    max(1, n_micro // 2), *a, **k)
    return [(steps, "loss_and_grads", half)]


def _answer_altered():
    """The update of one leaf written twice."""
    import repro_torch.train.steps as steps
    orig = steps.adamw_update

    def twice(state, grads, cfg, compress=None):
        leaf = state.params
        for k in DOUBLED_LEAF:
            leaf = leaf[k]
        before = leaf.clone()
        out = orig(state, grads, cfg, compress=compress)
        leaf.add_(leaf - before)
        return out
    return [(steps, "adamw_update", twice)]


DOUBLED_LEAF = ("layers", 0, "mlp", "w_down")
FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


def control_reference(cell) -> Dict:
    """The reference's readings that every variant is held against."""
    return reference_readings(cell)


def control_numbers(cell, variant: str, ref: Dict):
    """(numbers, per-leaf readings) of ``variant``: ``program``, the
    ``control`` (the reference in float8) or a fault of ``FAULTS``."""
    if variant == "control":
        got = reference_readings(cell, fp8=True)
    else:
        with (plant(sys.modules[__name__], variant)
              if variant != "program" else contextlib.nullcontext()):
            prog = Program(cell)
            got = program_readings(cell, prog)
            prog.close()
            del prog
        cell.free()
    return compare(cell, got, ref), got


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------


def run(cell) -> Dict:
    prog = Program(cell)
    readings = program_readings(cell, prog)
    out: Dict = {"setup_end": time.perf_counter()}
    t = cell.traffic
    step_tokens = t["batch"] * t["seq_len"]
    nxt = CHECKED_STEPS + 1

    def steps(n_max: int, seconds: float) -> int:
        nonlocal nxt
        t0 = time.perf_counter()
        n = 0
        while n < n_max:
            prog.step(tokens(cell, nxt))
            nxt += 1
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        return n

    if cell.trace:
        from ..profiling import profiled
        n, tr = profiled(lambda: steps(t["trace_steps"], float("inf")))
        out["trace"] = tr
        out["work"] = {"steps": n, "tokens": n * step_tokens,
                       "flops": n * flops.train_flops(cell.cfg, t["batch"],
                                                      t["seq_len"]),
                       "scan_rows": t["batch"] // t["n_micro"],
                       "seq_len": t["seq_len"]}
        out["attempted"] = n
    else:
        t0 = time.perf_counter()
        n = steps(1 << 30, cell.seconds)
        elapsed = time.perf_counter() - t0
        out["e2e"] = {"train_tokens_per_s": n * step_tokens / elapsed}
        out["attempted"] = n
    out["failed"] = 0
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated() \
        if cell.device.type == "cuda" else 0
    prog.close()
    del prog
    cell.free()
    ref = reference_readings(cell)
    out["numbers"] = compare(cell, readings, ref)
    out["readings"] = {"program": readings, "reference": ref}
    return out
