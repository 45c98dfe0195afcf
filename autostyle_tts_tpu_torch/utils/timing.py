"""The port's span recorder: one ``Stopwatch`` is one request's trace.

A span records its name, the request's id (shared by all of that request's
spans), its parent, its host start and end on ``time.perf_counter``, its
counters and ``wait_ms``, the host time blocked on the device inside it.
Opening or closing a span never synchronizes: the host blocks only where it
reads the device (``Stopwatch.read``) or waits for it (``Stopwatch.wait``),
and both stamp the time blocked on every span of the request open at the
time. A span's host time is its length less ``wait_ms``; its self time its
length less what its children cover.

``span(name)`` is a phase of the request: its milliseconds add up in
``ms[name]`` (``Engine.last_timings``). ``open(name)`` is any other span: the
request's root, a phase's children, a DB search. Finished spans go to the
request's ``spans`` and to one bounded log of the process (``spans()``).
While ``torch.profiler`` records, each span also opens a ``record_function``
range of its name, so a CPU + CUDA trace shows the spans on the device's
timeline.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Callable, Dict, List, Optional, TypeVar

import torch
from torch.autograd import profiler as _profiler

LOG_SPANS = 65536     # finished spans kept: a B=1 request closes ~10, a 30 s window of requests a few thousand
_LOG: deque = deque(maxlen=LOG_SPANS)
_OPEN: List["Span"] = []        # the open spans of the process, innermost last
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
T = TypeVar("T")


def spans() -> List["Span"]:
    """The finished spans of the process, oldest first (the last ``LOG_SPANS``)."""
    return list(_LOG)


def tally(**counters: float) -> None:
    """Add ``counters`` to the innermost open span of the process (a
    collective's count and host ms); dropped where no span is open."""
    if _OPEN:
        c = _OPEN[-1].counters
        for k, v in counters.items():
            c[k] = c.get(k, 0) + v


class Span:
    """One span of a request's trace; a context manager that records it."""

    __slots__ = ("name", "id", "request", "parent", "t0", "t1", "wait_ms", "child_ms", "counters", "attrs",
                 "_clock", "_phase", "_up", "_range")

    def __init__(self, clock: "Stopwatch", name: str, phase: bool):
        self.name, self.request = name, clock.request
        self.id, self.parent = next(_span_ids), None
        self.t0 = self.t1 = 0.0
        self.wait_ms = self.child_ms = 0.0
        self.counters: Dict[str, float] = {}
        self.attrs: Dict[str, object] = {}
        self._clock, self._phase, self._up, self._range = clock, phase, None, None

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e3

    @property
    def host_ms(self) -> float:
        return self.ms - self.wait_ms

    @property
    def self_ms(self) -> float:
        return self.ms - self.child_ms

    def __enter__(self) -> "Span":
        stack = self._clock._open
        if stack:
            self._up = stack[-1]
            self.parent = self._up.id
        stack.append(self)
        _OPEN.append(self)
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        clock = self._clock
        for stack in (clock._open, _OPEN):
            if stack[-1] is self:
                stack.pop()
            else:          # spans of interleaved streams close out of order
                stack.remove(self)
        ms = (self.t1 - self.t0) * 1e3
        if self._up is not None:
            self._up.child_ms += ms
        if self._phase:
            clock.ms[self.name] = clock.ms.get(self.name, 0.0) + ms
        clock.spans.append(self)
        _LOG.append(self)
        self._clock = self._up = None


class Stopwatch:
    """One request's trace on ``device``: its spans and, per phase name,
    the milliseconds of its ``span``s (``ms``)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.ms: Dict[str, float] = {}
        self.request = next(_request_ids)
        self.spans: List[Span] = []       # this request's finished spans, in the order they closed
        self._open: List[Span] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str) -> Span:
        """A phase of the request (``with clock.span("cfm"):``), timed into
        ``ms[name]``. It does not synchronize: a phase that reads nothing
        back ends on ``wait()``."""
        return Span(self, name, True)

    def open(self, name: str) -> Span:
        """Any other span (the request's root, a phase's children): recorded
        in the trace, not in ``ms``."""
        return Span(self, name, False)

    def read(self, fetch: Callable[[], T], counter: str = "reads") -> T:
        """``fetch()``, a host read of device data (``t.item``, ``t.tolist``,
        ``t.cpu``); the time blocked is a wait of every open span of the
        request, which also count one ``counter``."""
        t0 = time.perf_counter()
        out = fetch()
        self._waited(t0, counter)
        return out

    def wait(self) -> None:
        """Block until the device has finished the work enqueued so far; the
        time blocked is a wait of every open span of the request."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._waited(t0, "waits")

    def _waited(self, t0: float, counter: str) -> None:
        ms = (time.perf_counter() - t0) * 1e3
        for s in self._open:
            s.wait_ms += ms
            s.counters[counter] = s.counters.get(counter, 0) + 1

    def count(self, name: str, n: float = 1, attrs: Optional[Dict[str, object]] = None) -> None:
        """Add ``n`` to counter ``name`` of the request's innermost open
        span and set ``attrs`` on it (nothing where none is open)."""
        if self._open:
            s = self._open[-1]
            s.counters[name] = s.counters.get(name, 0) + n
            if attrs:
                s.attrs.update(attrs)


def format_tree(trace: List[Span]) -> str:
    """A request's spans as an indented tree, parents before children in
    start order: name, ms, self ms, host ms, wait ms, then counters and
    attributes."""
    kids: Dict[Optional[int], List[Span]] = {}
    ids = {s.id for s in trace}
    for s in sorted(trace, key=lambda s: s.t0):
        kids.setdefault(s.parent if s.parent in ids else None, []).append(s)
    lines = [f"{'span':<28} {'ms':>10} {'self':>10} {'host':>10} {'wait':>10}"]

    def walk(parent: Optional[int], depth: int) -> None:
        for s in kids.get(parent, []):
            extra = " ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                             for k, v in {**s.counters, **s.attrs}.items())
            lines.append(f"{'  ' * depth + s.name:<28} {s.ms:>10.3f} {s.self_ms:>10.3f} {s.host_ms:>10.3f} "
                         f"{s.wait_ms:>10.3f}  {extra}".rstrip())
            walk(s.id, depth + 1)

    walk(None, 0)
    return "\n".join(lines)
