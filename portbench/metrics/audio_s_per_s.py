"""Seconds of useful 24 kHz audio completed over the seconds measured: a
request's audio counts up to its own target length only."""

from portbench.bench.readers import done


def read(run):
    return sum(r["useful_s"] for r in done(run)) / run.window_s if run.window_s > 0 else None
