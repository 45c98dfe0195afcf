"""CUDA kernels launched inside the traced batches' decode spans, per
scanned decode step (device trace)."""

from portbench.bench.readers import done


def read(run):
    if run.trace is None:
        return None
    steps = sum(r["steps"] for r in done(run, traced=True))
    return run.trace["kernels_in_decode"] / steps if steps else None
