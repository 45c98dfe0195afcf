"""Mean host milliseconds of the ``prefill`` span: its length less its wait on
the device (the explicit wait it ends on), from the program's span log
(requests the profiler did not cover)."""

from portbench.bench.spans import mean_host_ms


def read(run):
    return mean_host_ms(run, "prefill")
