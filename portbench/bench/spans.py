"""What the readers of the program's own spans share: the finished spans
of the program's recorder (its module's ``span_log()``) that lie inside
the records the profiler did not cover, matched on the records' ``t0`` /
``t1`` (the recorder stamps on the same ``time.perf_counter``). A program
without that log gives nothing."""

from __future__ import annotations

import bisect
from typing import List, Optional

import numpy as np

from .readers import done


def logged(run, name: str) -> Optional[List]:
    """The program's finished spans called ``name`` inside the records the
    profiler did not cover, or None where the program keeps no log."""
    log = run.program.span_log()
    if log is None:
        return None
    recs = sorted((r["t0"], r["t1"]) for r in done(run, traced=False))
    starts = [t0 for t0, _ in recs]
    out = []
    for s in log:
        if s.name != name:
            continue
        i = bisect.bisect_right(starts, s.t0) - 1
        if i >= 0 and s.t1 <= recs[i][1]:
            out.append(s)
    return out


def mean_ms(run, name: str) -> Optional[float]:
    """Mean milliseconds of the spans called ``name``."""
    got = logged(run, name)
    return float(np.mean([s.ms for s in got])) if got else None


def mean_host_ms(run, name: str) -> Optional[float]:
    """Mean host milliseconds (length less the waits on the device) of the
    spans called ``name``."""
    got = logged(run, name)
    return float(np.mean([s.host_ms for s in got])) if got else None


def host_ms_per_step(run, name: str) -> Optional[float]:
    """The host milliseconds of the spans called ``name`` (length less
    their waits) over their counter ``steps``."""
    got = logged(run, name)
    steps = sum(s.counters.get("steps", 0) for s in got or ())
    return sum(s.host_ms for s in got) / steps if steps else None
