"""``linear_scan_bwd`` against its byte bound: the least bytes of one call
(``counts.flops.scan_bytes``: a, y and the gradient read, da and db
written, f32) at 3.35 TB/s over the kernel's mean device time, in
percent.  Nothing to read where the kernel did not run."""

from port_bench.counts.flops import HBM_BYTES_PER_S, scan_bytes, scan_elements


def read(run):
    if run.trace is None or "scan_rows" not in run.work:
        return None
    n, seconds = run.trace.kernel_stats("linear_scan_bwd")
    if not n or seconds <= 0:
        return None
    elements = scan_elements(run.cfg, run.work["scan_rows"],
                             run.work["seq_len"])
    bound = scan_bytes(elements, backward=True) / HBM_BYTES_PER_S
    return 100.0 * bound / (seconds / n)
