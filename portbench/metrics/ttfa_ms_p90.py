"""90th percentile of a streamed request's time to first audio (the
client's call, DB search included, to the first chunk's samples on the
host) over every request of the window; a failed request counts as
missing (infinitely late)."""

import numpy as np


def read(run):
    firsts = [float("inf") if r.get("failed") else r["ttfa_ms"] for r in run.records]
    return float(np.percentile(firsts, 90)) if firsts else None
