"""Mean host milliseconds of the ``featurize`` span: its length less its wait
on the device (the features' fetch), from the program's span log (requests
the profiler did not cover)."""

from portbench.bench.spans import mean_host_ms


def read(run):
    return mean_host_ms(run, "featurize")
