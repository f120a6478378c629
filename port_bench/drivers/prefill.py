"""Traffic kind ``prefill``: a closed loop of one client scoring prompts
through the program's serving engine (``serve.engine.ServingEngine``,
its ``prefill``), each request's answer the last position's logits.

A batch holds prompts of one length class; the traffic file gives each
class's prompt length, rows per batch and batches per cycle.  Each cycle
runs every class's batches in an order the seed shuffles; the window runs
whole cycles until ``--seconds`` have passed (the traced run, the
traffic's ``trace_cycles``).  One engine per class, its cache capacity the
class's length, all on the same weights.  A request's latency runs from
its batch's submission to its logits on the host.  Prompts are uniform
ids of the real vocabulary, drawn from (seed, batch).

After the window: the state that each class's engine keeps from its last
batch (every leaf of it) and the logits of those batches and of
``check_extra`` more requests drawn from the seed are held against the
plain reference, run once the program is freed.  The reference's
``prefill`` returns the state as a tree of the program's leaf names; a
leaf that one side has and the other lacks is an error, never left
uncompared.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from .. import weights
from ..counts import flops
from ..faults import plant
from ..reference import common as C


WARM, SERVED, CONTROL = 13, 11, 14


def prompts(cell, key: int, rows: int, seq: int,
            tag: int = SERVED) -> np.ndarray:
    """The prompts of batch ``key`` (``tag`` WARM: of the warm-up)."""
    rng = np.random.default_rng([cell.seed % (1 << 64), tag, key])
    return rng.integers(0, cell.cfg["vocab_size"], size=(rows, seq),
                        dtype=np.int32)


def cycle(cell, c: int) -> List[int]:
    """Class indices of cycle ``c``'s batches, in the seed's order."""
    order = [i for i, k in enumerate(cell.traffic["classes"])
             for _ in range(k["per_cycle"])]
    rng = np.random.default_rng([cell.seed % (1 << 64), 12, c])
    return [order[i] for i in rng.permutation(len(order))]


class Program:
    """The system under test: one serving engine per length class."""

    def __init__(self, cell):
        from repro_torch.serve.engine import ServingEngine

        self.cell = cell
        dtype = getattr(torch, cell.cfg["compute_dtype"])
        params = weights.draw(cell.layout, cell.seed, dtype, cell.device)
        self.engines = [ServingEngine(cell.arch, params, max_len=k["seq"],
                                      dtype=dtype, device=cell.device)
                        for k in cell.traffic["classes"]]

    def prefill(self, cls: int, tok: np.ndarray) -> np.ndarray:
        with self.cell.span("engine.prefill"):
            return self.engines[cls].prefill({"tokens": tok})

    def state_of(self, cls: int) -> Dict[str, torch.Tensor]:
        """Every leaf of the state that class ``cls``'s engine keeps from
        its last batch, by path, on the host."""
        return {k: t.to("cpu") for k, t in
                C.flat(self.engines[cls].state)}

    def close(self):
        self.engines = None


def run(cell) -> Dict:
    t = cell.traffic
    classes = t["classes"]
    prog = Program(cell)
    for i, k in enumerate(classes):                      # warm-up
        prog.prefill(i, prompts(cell, i, k["rows"], k["seq"], WARM))
    torch.cuda.synchronize() if cell.device.type == "cuda" else None
    out: Dict = {"setup_end": time.perf_counter()}

    done = []            # (batch key, class, seconds, logits)
    key = 0

    def cycles(n_max: int, seconds: float) -> int:
        nonlocal key
        t0 = time.perf_counter()
        c = 0
        while c < n_max:
            for cls in cycle(cell, c):
                k = classes[cls]
                tok = prompts(cell, key, k["rows"], k["seq"])
                b0 = time.perf_counter()
                lg = prog.prefill(cls, tok)
                done.append((key, cls, time.perf_counter() - b0, lg))
                key += 1
            c += 1
            if time.perf_counter() - t0 >= seconds:
                break
        return c

    if cell.trace:
        from ..profiling import profiled
        n, tr = profiled(lambda: cycles(t["trace_cycles"], float("inf")))
        out["trace"] = tr
    else:
        t0 = time.perf_counter()
        n = cycles(1 << 30, cell.seconds)
        elapsed = time.perf_counter() - t0
        lat = [s for _, cls, s, _ in done
               for _ in range(classes[cls]["rows"])]
        n_tok = sum(classes[cls]["rows"] * classes[cls]["seq"]
                    for _, cls, _, _ in done)
        out["e2e"] = {"prefill_tokens_per_s": n_tok / elapsed,
                      "request_p95_ms": float(np.percentile(lat, 95)) * 1e3}
    out["work"] = {
        "batches": len(done),
        "tokens": sum(classes[c]["rows"] * classes[c]["seq"]
                      for _, c, _, _ in done),
        "flops": sum(flops.prefill_flops(cell.cfg, classes[c]["rows"],
                                         classes[c]["seq"])
                     for _, c, _, _ in done)}
    out["attempted"] = sum(classes[c]["rows"] for _, c, _, _ in done)
    out["failed"] = 0
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated() \
        if cell.device.type == "cuda" else 0
    states = [prog.state_of(i) for i in range(len(classes))]
    prog.close()
    del prog
    cell.free()
    out["numbers"] = check(cell, done, states)
    return out


def check(cell, done, states) -> Dict[str, float]:
    """The served answers against the plain reference: each class's last
    batch (logits and every layer's cache) and ``check_extra`` more
    requests drawn from the seed (logits)."""
    classes = cell.traffic["classes"]
    last = {}
    for key, cls, _, lg in done:
        last[cls] = (key, lg)
    rest = [(key, cls, r) for key, cls, _, lg in done
            for r in range(classes[cls]["rows"]) if last[cls][0] != key]
    rng = np.random.default_rng([cell.seed % (1 << 64), 17])
    pick = rng.permutation(len(rest))[:cell.traffic["check_extra"]]
    extra: Dict[tuple, List[int]] = {}
    logits_of = {key: lg for key, _, _, lg in done}
    for i in sorted(pick):
        key, cls, r = rest[i]
        extra.setdefault((key, cls), []).append(r)
    ref_params = reference_weights(cell)
    nums = new_numbers()
    jobs = [(key, cls, list(range(classes[cls]["rows"])), True)
            for cls, (key, _) in sorted(last.items())]
    jobs += [(key, cls, rows, False) for (key, cls), rows in extra.items()]
    with C.exact_float32():
        for key, cls, rows, with_state in jobs:
            k = classes[cls]
            tok = prompts(cell, key, k["rows"], k["seq"])[rows]
            ref_lg, ref_st = cell.ref.prefill(
                cell.cfg, ref_params,
                torch.from_numpy(tok).to(cell.device))
            fold(nums, cell.cfg["vocab_size"],
                 torch.from_numpy(logits_of[key][rows]).to(cell.device),
                 ref_lg, states[cls] if with_state else None, ref_st)
            del ref_st
    return nums


def fold(nums: Dict, vocab: int, got_lg: torch.Tensor, ref_lg: torch.Tensor,
         got_st=None, ref_st=None) -> None:
    """Fold one batch's answers, and its state where ``got_st`` is given
    (leaf path -> tensor; ``ref_st`` the reference's state tree), into
    ``nums``."""
    answer_gaps(nums, vocab, got_lg.to(ref_lg.device), ref_lg)
    if got_st is None:
        return
    ref = dict(C.flat(ref_st))
    if set(got_st) != set(ref):
        raise ValueError("state leaves left uncompared: "
                         f"{sorted(set(got_st) ^ set(ref))}")
    for name, t in got_st.items():
        nums["state_err"] = max(nums["state_err"],
                                rel_err(t.to(ref[name].device), ref[name]))


def new_numbers() -> Dict[str, float]:
    return {"token_gap": 0.0, "logit_err": 0.0, "state_err": 0.0}


def reference_weights(cell) -> Dict:
    """The weights as served (drawn in the compute dtype), in f32."""
    dtype = getattr(torch, cell.cfg["compute_dtype"])
    params = weights.draw(cell.layout, cell.seed, dtype, cell.device)

    def up(t):
        if isinstance(t, dict):
            return {k: up(v) for k, v in t.items()}
        if isinstance(t, list):
            return [up(v) for v in t]
        return t.to(torch.float32)

    return up(params)


def answer_gaps(nums: Dict, vocab: int, got: torch.Tensor,
                ref: torch.Tensor) -> None:
    """Fold one batch of answers (rows, vocab_padded) into ``nums``: the
    widest gap by which the served top token's reference logit lies below
    the reference's best, and the largest logit error over the row's
    reference RMS."""
    got, ref = got[:, :vocab].to(torch.float32), ref[:, :vocab]
    top = got.argmax(dim=-1)
    gap = ref.amax(dim=-1) - ref.gather(1, top[:, None])[:, 0]
    err = (got - ref).abs().amax(dim=-1) / ref.square().mean(-1).sqrt()
    nums["token_gap"] = max(nums["token_gap"], float(gap.max()))
    nums["logit_err"] = max(nums["logit_err"], float(err.max()))


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref|| over one state leaf of a batch (a cache
    cut to the reference's positions)."""
    got = got[tuple(slice(0, n) for n in ref.shape)].to(torch.float32)
    ref = ref.to(torch.float32)
    return float(torch.linalg.vector_norm(got - ref)
                 / torch.linalg.vector_norm(ref))


# ---------------------------------------------------------------------------
# faults, and the readings that set the limits (control.py)
# ---------------------------------------------------------------------------


def _state_unchanged():
    """No layer's state written."""
    import repro_torch.models.model as model
    return [(model, "_write_layer", lambda *a, **k: None)]


def _half_batch():
    """The first half of a batch's rows computed, the others answered
    with their copies."""
    import repro_torch.serve.engine as engine
    orig = engine.forward_prefill

    def half(cfg, params, batch, *a, **k):
        tok = batch["tokens"]
        keep = -(-tok.shape[0] // 2)
        idx = np.arange(tok.shape[0]) % keep
        return orig(cfg, params, dict(batch, tokens=tok[idx]), *a, **k)
    return [(engine, "forward_prefill", half)]


def _answer_altered():
    """The first request of a batch served another token."""
    import repro_torch.serve.engine as engine
    orig = engine._host

    def altered(logits):
        out = orig(logits)
        served = 1 if int(out[0].argmax()) == 0 else 0
        out[0, served] = out[0].max() + 1.0
        return out
    return [(engine, "_host", altered)]


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


def control_reference(cell):
    """One batch of every class, and the reference's answers and states."""
    batches = [prompts(cell, i, k["rows"], k["seq"], CONTROL)
               for i, k in enumerate(cell.traffic["classes"])]
    params = reference_weights(cell)
    with C.exact_float32():
        ref = [cell.ref.prefill(cell.cfg, params,
                                torch.from_numpy(t).to(cell.device))
               for t in batches]
    del params
    cell.free()
    return batches, ref


def control_numbers(cell, variant: str, ref):
    """(numbers, None) of ``variant``: ``program``, the ``control`` (the
    reference in float8) or a fault of ``FAULTS``."""
    batches, refs = ref
    if variant == "control":
        params = reference_weights(cell)
        with C.exact_float32():
            outs = [cell.ref.prefill(cell.cfg, params,
                                     torch.from_numpy(t).to(cell.device),
                                     C.Precision(fp8=True))
                    for t in batches]
        outs = [(lg, dict(C.flat(st))) for lg, st in outs]
        del params
    else:
        with (plant(sys.modules[__name__], variant)
              if variant != "program" else contextlib.nullcontext()):
            prog = Program(cell)
            outs = [(torch.from_numpy(prog.prefill(i, t)), prog.state_of(i))
                    for i, t in enumerate(batches)]
            prog.close()
            del prog
    cell.free()
    nums = new_numbers()
    for (lg, st), (rl, rs) in zip(outs, refs):
        fold(nums, cell.cfg["vocab_size"], lg, rl, st, rs)
    return nums, None
