"""The traced window's counted model FLOPs (``counts.flops``) over the
window's length times the H100's dense bf16 peak, in percent."""

from port_bench.counts.flops import PEAK_BF16_FLOPS


def read(run):
    if run.trace is None or not run.work.get("flops") \
            or run.trace.window_s <= 0:
        return None
    return 100.0 * run.work["flops"] / (run.trace.window_s * PEAK_BF16_FLOPS)
