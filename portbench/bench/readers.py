"""What the metric readers (``metrics/<name>.py``) share: means over the
window's records, the program's FLOPs over their seconds, kernels and
device time from the trace, and loading a reader by name."""

from __future__ import annotations

import importlib.util
from typing import Callable, Dict, List, Optional

import numpy as np

from .. import counts
from .spec import BENCH_DIR


def reader(name: str) -> Callable:
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def done(run, traced: Optional[bool] = None) -> List[Dict]:
    """Finished records; ``traced`` False: those the profiler did not cover
    (host spans read without its cost), True: only those it covered."""
    recs = [r for r in run.records if not r.get("failed")]
    if traced is None:
        return recs
    return [r for r in recs if (r["i"] in run.traced) == traced]


def mean_span(run, name: str) -> Optional[float]:
    """Mean of the records' ``timings[name]`` (records the profiler did not cover)."""
    vals = [r["timings"][name] for r in done(run, traced=False) if name in r["timings"]]
    return float(np.mean(vals)) if vals else None


def per_step(run, name: str) -> Optional[float]:
    """The records' ``timings[name]`` over their ``steps`` (records the
    profiler did not cover)."""
    recs = [r for r in done(run, traced=False) if r["steps"] > 0]
    steps = sum(r["steps"] for r in recs)
    return sum(r["timings"][name] for r in recs) / steps if steps else None


def mfu(run, peak: float = counts.BF16_FLOP_PER_S) -> Optional[float]:
    """100 x the model FLOPs (the program's ``flops`` of each record) of
    the records the profiler did not cover over their seconds (the closed
    loop's requests, or the batches, follow one another) times the peak."""
    recs = done(run, traced=False)
    seconds = sum(r["t1"] - r["t0"] for r in recs)
    if not recs or seconds <= 0:
        return None
    return 100.0 * sum(run.program.flops(run.cfg, r) for r in recs) / (seconds * peak)


def device_share(run, part: str, bound_of: Callable[[Dict], float]) -> Optional[float]:
    """100 x the benchmark's least time over the traced records' launches
    of a kernel / the kernel's device time in the trace."""
    if run.trace is None:
        return None
    t = sum(s for n, s in run.trace["kernel_s"].items() if part in n)
    if t <= 0:
        return None
    return 100.0 * sum(bound_of(r) for r in done(run, traced=True)) / t


def kernels_in(run, span: str) -> Optional[int]:
    """Device kernels (copies and sets left out) that start inside the
    traced part's spans called ``span``."""
    if run.trace is None:
        return None
    inside = [(a, b) for n, a, b in run.trace["spans"] if n == span]
    return sum(1 for n, t, _ in run.trace["events"] if not n.startswith(("Memcpy", "Memset"))
               and any(a <= t <= b for a, b in inside))
