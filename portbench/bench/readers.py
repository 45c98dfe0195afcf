"""What the metric readers (``metrics/<name>.py``) share: a record's real
lengths, means over the window's requests, and loading a reader by name."""

from __future__ import annotations

import importlib.util
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import counts
from ..reference.tts import encode_text
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
    vals = [r["timings"][name] for r in done(run, traced=False) if name in r["timings"]]
    return float(np.mean(vals)) if vals else None


def per_step(run, name: str = "decode") -> Optional[float]:
    recs = [r for r in done(run, traced=False) if r["steps"] > 0]
    steps = sum(r["steps"] for r in recs)
    return sum(r["timings"][name] for r in recs) / steps if steps else None


def rows(rec: Dict) -> List[Tuple[int, int, int, int]]:
    """(prefix length, tokens generated, flow-prompt tokens, decode steps)
    of each row of a record, at their real lengths."""
    k = rec["kept"]
    if "texts" in k:       # a batch
        out = []
        for b, (sty, tim) in enumerate(k["feats"]):
            n_pre = _prefix_len(k["texts"][b], k["style_texts"][b], len(sty.tokens))
            g = rec["gen_lens"][b]
            out.append((n_pre, g, len(tim.tokens), g))
        return out
    sty, tim = k["feats"] if "feats" in k else k["feat_out"][0]
    return [(_prefix_len(k["text"], k["style_text"], len(sty.tokens)), rec["gen_len"], len(tim.tokens), rec["steps"])]


def _prefix_len(text: str, style_text: str, n_style: int) -> int:
    full = (style_text + " " + text).strip() if style_text else text
    return 2 + len(encode_text(full)) + min(n_style, 256)


def mfu(run, peak: float = counts.BF16_FLOP_PER_S) -> Optional[float]:
    """100 x the model FLOPs of the requests the profiler did not cover
    over their seconds (the closed loop's requests, or the batches, follow
    one another) times the peak."""
    recs = done(run, traced=False)
    seconds = sum(r["t1"] - r["t0"] for r in recs)
    if not recs or seconds <= 0:
        return None
    flops = sum(counts.request_flops(run.cfg, n_pre, g, n_p) for r in recs for n_pre, g, n_p, _ in rows(r))
    return 100.0 * flops / (seconds * peak)


def device_share(run, part: str, bound_of: Callable[[Dict], float]) -> Optional[float]:
    """100 x the benchmark's least time over the traced records' launches
    of a kernel / the kernel's device time in the trace."""
    if run.trace is None:
        return None
    t = sum(s for n, s in run.trace["kernel_s"].items() if part in n)
    if t <= 0:
        return None
    return 100.0 * sum(bound_of(r) for r in done(run, traced=True)) / t
