"""The traced window: spans from the benchmark's own calls into the
program, and a summary of the profiler's raw records (no chrome trace).

``span(name)`` marks a call into a layer of the program with
``torch.profiler.record_function`` when a run traces, and costs nothing
otherwise.  ``profiled(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and
CUDA activity) and reduces the raw kineto records to a ``Trace``: the
window's length, the union of the device's busy intervals, kernel counts
and times by name, the spans' total and self times, and the longest idle
gaps of the device, each named by what the host was doing when it began.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

WINDOW = "pb.window"
SPAN_PREFIX = "pb."


class Spans:
    """Named spans around the benchmark's calls into the program."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(SPAN_PREFIX + name)


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: int
    by_name: Dict[str, Tuple[int, float]]     # name -> (count, seconds)
    spans: Dict[str, Tuple[int, float, float]]  # name -> (n, total, self)
    gaps: List[Tuple[str, float]]             # longest idle gaps

    def kernel_stats(self, part: str) -> Tuple[int, float]:
        """(launches, seconds) of the kernels whose name holds ``part``."""
        n = t = 0
        for name, (c, s) in self.by_name.items():
            if part in name:
                n += c
                t += s
        return n, t

    def breakdown(self) -> Dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:10]
        return {"device_ops": [[k[:120], v[1]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in self.gaps[:10]]}

    def summary(self) -> Dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:40]
        return {"window_s": self.window_s, "busy_s": self.busy_s,
                "kernels": self.kernels,
                "device_ops": [[k[:200], c, s] for k, (c, s) in ops],
                "spans": {k: {"n": n, "total_s": t, "self_s": s}
                          for k, (n, t, s) in self.spans.items()},
                "idle_gaps": self.gaps}


def _union(iv: np.ndarray) -> np.ndarray:
    """Sorted, merged [start, end) rows of (n, 2) intervals."""
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    stops = ends[np.r_[idx[1:] - 1, len(iv) - 1]]
    return np.stack([starts, stops], axis=1)


def _host_label(cpu_names, cpu_iv, t) -> str:
    """The innermost benchmark span and the innermost other host record
    running at time ``t``."""
    live = np.flatnonzero((cpu_iv[:, 0] <= t) & (cpu_iv[:, 1] >= t))
    span = op = None
    for i in live[np.argsort(cpu_iv[live, 0], kind="stable")]:
        name = cpu_names[i]
        if name.startswith(SPAN_PREFIX):
            if name != WINDOW:
                span = name[len(SPAN_PREFIX):]
        else:
            op = name
    return f"{span or 'harness'}/{op or 'python'}"[:120]


def profiled(fn: Callable[[], object]) -> Tuple[object, Trace]:
    """Run ``fn`` under the profiler; returns (its result, the Trace)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_names, dev_iv, cpu_names, cpu_iv = [], [], [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        row = (e.start_ns(), e.end_ns())
        if e.device_type() == cuda:
            if e.name().startswith(SPAN_PREFIX):
                continue          # a span's annotation on the device's line
            dev_names.append(e.name())
            dev_iv.append(row)
        else:
            cpu_names.append(e.name())
            cpu_iv.append(row)
    dev_iv = np.array(dev_iv, dtype=np.int64).reshape(-1, 2)
    cpu_iv = np.array(cpu_iv, dtype=np.int64).reshape(-1, 2)
    win = [i for i, n in enumerate(cpu_names) if n == WINDOW]
    w0, w1 = (cpu_iv[win[0]] if win else
              (dev_iv[:, 0].min(), dev_iv[:, 1].max()))
    keep = (dev_iv[:, 1] > w0) & (dev_iv[:, 0] < w1)
    dev_iv = np.clip(dev_iv[keep], w0, w1)
    dev_names = [n for n, k in zip(dev_names, keep) if k]
    busy = _union(dev_iv)
    by_name: Dict[str, List] = {}
    kernels = 0
    for name, (a, b) in zip(dev_names, dev_iv):
        c = by_name.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += (b - a) / 1e9
        if not name.startswith(("Memcpy", "Memset")):
            kernels += 1
    # idle gaps inside the window, longest first
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    lengths = edges[:, 1] - edges[:, 0]
    order = np.argsort(-lengths, kind="stable")[:10]
    gaps = [(_host_label(cpu_names, cpu_iv, edges[i, 0]), lengths[i] / 1e9)
            for i in order if lengths[i] > 0]
    spans = _span_times(cpu_names, cpu_iv)
    window_s = (w1 - w0) / 1e9 if win else wall
    return out, Trace(window_s=float(window_s),
                      busy_s=float((busy[:, 1] - busy[:, 0]).sum() / 1e9),
                      kernels=kernels,
                      by_name={k: (v[0], v[1]) for k, v in by_name.items()},
                      spans=spans, gaps=gaps)


def _span_times(names, iv) -> Dict[str, Tuple[int, float, float]]:
    """Total and self seconds of each benchmark span: self is the span's
    time less that of the benchmark spans directly inside it."""
    idx = [i for i, n in enumerate(names)
           if n.startswith(SPAN_PREFIX) and n != WINDOW]
    idx.sort(key=lambda i: (iv[i, 0], -iv[i, 1]))
    out: Dict[str, List] = {}
    stack: List[List] = []                    # [index, child seconds]
    for i in idx + [None]:
        while stack and (i is None or iv[stack[-1][0], 1] <= iv[i, 0]):
            j, child = stack.pop()
            dur = (iv[j, 1] - iv[j, 0]) / 1e9
            rec = out.setdefault(names[j][len(SPAN_PREFIX):], [0, 0.0, 0.0])
            rec[0] += 1
            rec[1] += dur
            rec[2] += dur - child
            if stack:
                stack[-1][1] += dur
        if i is not None:
            stack.append([i, 0.0])
    return {k: (v[0], v[1], v[2]) for k, v in out.items()}
