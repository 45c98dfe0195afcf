"""Milliseconds a decode step of a B=1 request (the decode-step kernel and
the host's read of its token): the decode spans over the decode steps."""

from portbench.bench.readers import per_step


def read(run):
    return per_step(run, "decode")
