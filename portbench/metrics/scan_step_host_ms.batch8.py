"""Host milliseconds a scanned decode step of a batch (its launches and the
loop): the decode spans less their token reads' waits, over their steps,
from the program's span log (requests the profiler did not cover)."""

from portbench.bench.spans import host_ms_per_step


def read(run):
    return host_ms_per_step(run, "decode")
