"""Mean milliseconds a request of the token LM's prefill span, from
``Engine.last_timings["prefill"]`` (requests the profiler did not cover)."""

from portbench.bench.readers import mean_span


def read(run):
    return mean_span(run, "prefill")
