"""Share (%) of a stream's windows whose CFM a CUDA-graph replay served:
Σ the counter ``graph_replays`` over the ``cfm`` spans that carry it,
over their number, from the program's span log (requests the profiler did
not cover). Only a stream window's ``cfm`` span counts replays (one a
window, 0 or 1); a whole utterance's does not and is left out. A program
whose ``cfm`` spans count no replays gives nothing."""

from portbench.bench.spans import logged


def read(run):
    got = [s for s in logged(run, "cfm") or () if "graph_replays" in s.counters]
    return 100.0 * sum(s.counters["graph_replays"] for s in got) / len(got) if got else None
