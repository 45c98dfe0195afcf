"""The device trace of the traced part of a window (``torch.profiler``,
CUDA activity only) reduced to what the per-layer metrics read.

The host clock and the trace's clock are tied by a marker: a spin kernel
launched right after a synchronize, at a known host time. Device events
are placed on the host clock through it (to within a launch latency), so
an idle gap can be named by the span the host was in. The reduction keeps
the device events on the host clock and the traced part's spans, for
readers that count events inside spans of a name.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch


def _events(prof) -> List[Tuple[str, float, float]]:
    """(name, start s, duration s) of every device event, in start order."""
    res = getattr(prof.profiler, "kineto_results", None)
    raw = res.events() if res is not None else []
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in raw:
        if e.device_type() != cuda:
            continue
        if hasattr(e, "start_ns"):
            t0, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        else:
            t0, d = e.start_us() * 1e-6, e.duration_us() * 1e-6
        out.append((e.name(), t0, d))
    out.sort(key=lambda x: x[1])
    return out


def short(name: str) -> str:
    return name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0][:60]


class Tracer:
    def __init__(self):
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()
        torch.cuda._sleep(1000)

    def stop(self, spans: List[Tuple[str, float, float]]) -> Dict:
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        self.prof.__exit__(None, None, None)
        evs = _events(self.prof)
        marks = [i for i, (n, _, _) in enumerate(evs) if "spin" in n.lower() or "sleep" in n.lower()]
        if not marks:
            raise RuntimeError("the trace holds no marker kernel: no device event was recorded")
        d0 = evs[marks[0]][1]
        # device events on the host clock, from the marker on
        ev = [(short(n), self.t_mark + (t - d0), d) for n, t, d in evs[marks[0] + 1:]]
        window = t_end - self.t_mark
        busy, gaps, last = 0.0, [], self.t_mark
        for _, t, d in ev:
            if t > last:
                gaps.append((last, t))
            busy += max(0.0, t + d - max(t, last))
            last = max(last, t + d)
        if t_end > last:
            gaps.append((last, t_end))
        by_name: Dict[str, float] = {}
        for n, _, d in ev:
            by_name[n] = by_name.get(n, 0.0) + d
        idle: Dict[str, float] = {}
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            where = [s for s in spans if s[1] <= mid <= s[2]]
            name = where[-1][0] if where else "host between spans"
            idle[name] = idle.get(name, 0.0) + (g1 - g0)
        return {
            "window_s": window, "busy_s": busy, "kernel_s": by_name,
            "events": ev, "spans": list(spans),
            "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(([n, s] for n, s in idle.items()), key=lambda x: -x[1])[:10],
        }
