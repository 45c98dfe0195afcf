"""Milliseconds a scanned decode step of a batch: the decode spans over the
steps."""

from portbench.bench.readers import per_step


def read(run):
    return per_step(run, "decode")
