"""Mean milliseconds a stream's window takes to render (the engine's
``last_chunk_ms``: window CFM, vocoder and the chunk's fetch), over the
windows of the requests the profiler did not cover."""

import numpy as np

from portbench.bench.readers import done


def read(run):
    windows = [ms for r in done(run, traced=False) for ms in r.get("chunk_ms", ())]
    return float(np.mean(windows)) if windows else None
