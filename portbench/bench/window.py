"""The measured window: a closed loop of B=1 requests, or a backlog served a
batch at a time. It ends at the first boundary at or after ``seconds``
between blocks of ``window_units`` requests (or batches) of the mix (1 by
default): where a block of the mix holds batches of different sizes, the
window holds whole blocks, so how many fit does not change the work's
composition. Its rates divide by the time measured.

With ``trace`` the profiler covers a steady run of whole requests inside
the window (``trace`` in the mix: after ``skip`` of them, until every
target length of the mix has been seen and at least ``min_requests``, at
most ``max_requests``; for batches, ``batches`` whole batches).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from . import host
from ..traffic.generator import lengths
from .trace import Tracer


class Run:
    """What one run measured, for the metric readers."""

    def __init__(self, session, records: List[Dict], t_start: float, t_end: float, setup_s: float,
                 failures: List[str], trace: Optional[Dict], traced: List[int], host_window: Dict,
                 launches: Dict[str, int]):
        self.cfg, self.mix = session.cfg, session.mix
        self.records, self.failures = records, failures
        self.window_s = t_end - t_start
        self.setup_s = setup_s
        self.trace, self.traced = trace, traced
        self.host = host_window       # host.over: the machine around the window
        self.launches = launches      # the decode-step kernel's launches in the window, by weight width


def measure(session, seconds: float, t_process: float, trace: bool) -> Run:
    mix = session.mix
    B = mix["batch"]
    tc = mix["trace"]
    tracer = Tracer() if trace else None
    records, failures, traced = [], [], []
    lengths_all = lengths(mix)
    units = int(mix.get("window_units", 1))
    seen: set = set()
    tracing, trace_out = False, None
    reqs = session.traffic.requests(session.pool)
    session.taps.on = True
    launches0 = session.launches()
    h0 = host.snapshot()
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    j = 0
    while True:
        if B == 1:
            req = next(reqs)
            unit = req
        else:
            unit = [next(reqs) for _ in range(B)]
        if tracer is not None and not tracing and j == tc["skip"]:
            session.spans.on = True
            tracer.start()
            tracing = True
        try:
            rec = session.serve_one(unit) if B == 1 else session.serve_batch(unit, j)
            records.append(rec)
        except Exception as exc:      # a failed request counts as missing; the run goes on
            failures.append(f"{type(exc).__name__}: {exc}")
            records.append(dict(i=j, failed=True, t1=time.perf_counter()))
        if tracing:
            traced.append(j)
            seen |= {unit.target} if B == 1 else {r.target for r in unit}
            n = len(traced)
            done = (n >= tc.get("batches", 0)) if B > 1 else \
                (n >= tc["max_requests"] or (n >= tc["min_requests"] and seen >= lengths_all))
            if done:
                trace_out = tracer.stop(session.spans.spans)
                session.spans.on = False
                tracing, tracer = False, None
        j += 1
        if time.perf_counter() - t_start >= seconds and not tracing and j % units == 0:
            break
    t_end = records[-1]["t1"]
    h1 = host.snapshot()
    launches1 = session.launches()
    session.taps.on = False
    return Run(session, records, t_start, t_end, setup_s, failures, trace_out, traced, host.over(h0, h1),
               {k: launches1[k] - launches0[k] for k in launches1})
