"""Share (%) of the scanned decode steps that a CUDA-graph replay served:
the decode spans' counter ``graph_replays`` over their counter ``steps``,
from the program's span log (requests the profiler did not cover). A
program whose decode spans count no replays gives nothing."""

from portbench.bench.spans import logged


def read(run):
    got = [s for s in logged(run, "decode") or () if "graph_replays" in s.counters]
    steps = sum(s.counters.get("steps", 0) for s in got)
    return 100.0 * sum(s.counters["graph_replays"] for s in got) / steps if steps else None
