"""Mean milliseconds of the benchmark's span around ``StyleStore.search``."""

import numpy as np

from portbench.bench.readers import done


def read(run):
    vals = [r["search_ms"] for r in done(run, traced=False) if r.get("search_ms") is not None]
    return float(np.mean(vals)) if vals else None
