"""Kernels the profiler records per traced train step (memory copies and
sets not counted)."""


def read(run):
    if run.trace is None or not run.work.get("steps"):
        return None
    return run.trace.kernels / run.work["steps"]
