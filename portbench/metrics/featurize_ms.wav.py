"""Mean milliseconds a request of the engine's featurize span (prompt wavs to speech tokens, speaker embedding and prompt mel), from
``Engine.last_timings["featurize"]`` (requests the profiler did not cover)."""

from portbench.bench.readers import mean_span


def read(run):
    return mean_span(run, "featurize")
