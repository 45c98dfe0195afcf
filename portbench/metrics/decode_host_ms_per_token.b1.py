"""Host milliseconds a decode step of a B=1 request (the launch, the loop and
the token's handling): the decode spans less their token reads' waits, over
their steps, from the program's span log (requests the profiler did not
cover)."""

from portbench.bench.spans import host_ms_per_step


def read(run):
    return host_ms_per_step(run, "decode")
