"""Mean milliseconds of the program's own ``db_search`` span
(``StyleStore.search``: the top-k and its fetch), from the program's span
log (requests the profiler did not cover)."""

from portbench.bench.spans import mean_ms


def read(run):
    return mean_ms(run, "db_search")
