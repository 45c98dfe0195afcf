"""The measured window: the cell's loop (``loops/<kind>.py``, named by the
mix's ``"loop"``) serves unit after unit. It ends at the first boundary at
or after ``seconds`` between blocks of ``window_units`` units of the mix
(1 by default): where a block of the mix holds units of different sizes,
the window holds whole blocks, so how many fit does not change the work's
composition. Its rates divide by the time measured.

With ``trace`` the profiler covers a steady run of whole units inside the
window: from unit ``trace.skip`` of the mix until the loop says the traced
part is complete.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from . import host
from .spec import loop_of
from .trace import Tracer


class Run:
    """What one run measured, for the metric readers."""

    def __init__(self, session, records: List[Dict], t_start: float, t_end: float, setup_s: float,
                 failures: List[str], trace: Optional[Dict], traced: List[int], host_window: Dict,
                 counters: Dict[str, int]):
        self.cfg, self.mix = session.cfg, session.mix
        self.program = None           # the program module (set by the harness): FLOPs, span log
        self.records, self.failures = records, failures
        self.window_s = t_end - t_start
        self.setup_s = setup_s
        self.trace, self.traced = trace, traced
        self.host = host_window       # host.over: the machine around the window
        self.counters = counters      # the change of the program's own counters over the window


def measure(session, seconds: float, t_process: float, trace: bool) -> Run:
    mix = session.mix
    loop = loop_of(mix)
    serve = getattr(session, loop.SERVES)
    tracer = Tracer() if trace else None
    records, failures, traced, traced_units = [], [], [], []
    per_block = int(mix.get("window_units", 1))
    tracing, trace_out = False, None
    units = loop.units(session)
    session.taps.on = True
    counters0 = session.counters()
    h0 = host.snapshot()
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    j = 0
    while True:
        unit = next(units)
        if tracer is not None and not tracing and j == mix["trace"]["skip"]:
            session.spans.on = True
            tracer.start()
            tracing = True
        try:
            records.append(serve(unit, j))
        except Exception as exc:      # a failed unit counts as missing; the run goes on
            failures.append(f"{type(exc).__name__}: {exc}")
            records.append(dict(i=j, failed=True, t1=time.perf_counter()))
        if tracing:
            traced.append(j)
            traced_units.append(unit)
            if loop.traced_enough(mix, traced_units):
                trace_out = tracer.stop(session.spans.spans)
                session.spans.on = False
                tracing, tracer = False, None
        j += 1
        if time.perf_counter() - t_start >= seconds and not tracing and j % per_block == 0:
            break
    t_end = records[-1]["t1"]
    h1 = host.snapshot()
    counters1 = session.counters()
    session.taps.on = False
    return Run(session, records, t_start, t_end, setup_s, failures, trace_out, traced, host.over(h0, h1),
               {k: counters1[k] - counters0[k] for k in counters1})
