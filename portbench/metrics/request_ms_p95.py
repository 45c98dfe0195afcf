"""95th percentile of the request wall (the client's call to the wav on
the host) over every request of the window; a failed request counts as
missing (infinitely late)."""

import numpy as np


def read(run):
    walls = [float("inf") if r.get("failed") else r["wall_ms"] for r in run.records]
    return float(np.percentile(walls, 95)) if walls else None
