"""CUDA kernels launched inside the traced batches' decode spans, per
scanned decode step (device trace)."""

from portbench.bench.readers import done, kernels_in


def read(run):
    n = kernels_in(run, "decode")
    steps = sum(r["steps"] for r in done(run, traced=True))
    return n / steps if n is not None and steps else None
