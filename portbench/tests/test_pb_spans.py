"""The readers of the program's own spans on the tiny cells, on the CPU:
each reads a finite value where its cell has the span, each host share is
at most the span metric it splits, and a program without the span log
gives nothing."""

from __future__ import annotations

import math

import pytest
import torch

from portbench.bench.harness import run_cell
from portbench.bench.readers import reader
from portbench.tests.tiny import TinyCell

SEED = 2 ** 31 + 33
B1_SPLITS = {"prefill_host_ms.b1": "prefill_ms.b1", "cfm_host_ms.b1": "cfm_ms.b1",
             "vocoder_host_ms.b1": "vocoder_ms.b1", "decode_host_ms_per_token.b1": "decode_ms_per_token.b1"}
SPLITS = {
    "b1-db": dict(B1_SPLITS, **{"db_search_span_ms.b1": "db_search_ms.b1"}),
    "b1-wav": dict(B1_SPLITS, **{"featurize_host_ms.wav": "featurize_ms.wav"}),
    "batch8": {"scan_step_host_ms.batch8": "scan_step_ms.batch8"},
}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    return {}


def _run(runs, traffic):
    if traffic not in runs:
        runs[traffic] = run_cell(TinyCell(traffic), SEED, 1.5, False, 0.0, device="cpu")["_run"]
    return runs[traffic]


@pytest.mark.parametrize("traffic", sorted(SPLITS))
def test_span_readers_read_within_their_span_metrics(runs, traffic):
    run = _run(runs, traffic)
    for name, whole in SPLITS[traffic].items():
        part, total = reader(name)(run), reader(whole)(run)
        assert part is not None and math.isfinite(part) and part > 0, (name, part)
        assert part <= total, (name, part, whole, total)


def test_span_readers_read_nothing_without_the_log(runs, monkeypatch):
    from autostyle_tts_tpu_torch.utils import timing

    run = _run(runs, "b1-db")
    monkeypatch.delattr(timing, "spans")
    for name in sorted({n for s in SPLITS.values() for n in s}):
        assert reader(name)(run) is None, name
