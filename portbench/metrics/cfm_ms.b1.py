"""Mean milliseconds a request of the CFM span (flow conditioning and the Euler solve), from
``Engine.last_timings["cfm"]`` (requests the profiler did not cover)."""

from portbench.bench.readers import mean_span


def read(run):
    return mean_span(run, "cfm")
