"""Per-stage wall-clock spans that end in a device synchronize."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

import torch


class Stopwatch:
    """Accumulates milliseconds per span name for one request. On a CUDA
    device each span synchronizes at its end, so a span holds the device
    time of the work enqueued inside it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.ms: Dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def span(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
