"""Mean milliseconds a request of the vocoder span (and the fetch of the wav), from
``Engine.last_timings["vocoder"]`` (requests the profiler did not cover)."""

from portbench.bench.readers import mean_span


def read(run):
    return mean_span(run, "vocoder")
