"""The reader of ``scan_graph_share.batch8`` on a synthetic span log: the
decode spans inside the records the profiler did not cover give the share
of their steps that a graph replay served; a log whose decode spans count
no replays (a program without the captured step), or no log at all, gives
nothing and raises nothing."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench.bench.readers import reader
from portbench.programs import tts

NAME = "scan_graph_share.batch8"


def _run():
    """Two batches outside the traced part and one inside it."""
    recs = [dict(i=0, t0=0.0, t1=10.0), dict(i=1, t0=10.0, t1=20.0), dict(i=2, t0=20.0, t1=30.0)]
    return SimpleNamespace(records=recs, traced={1}, program=tts)


def _span(t0, t1, name="decode", **counters):
    return SimpleNamespace(name=name, t0=t0, t1=t1, counters=counters)


@pytest.fixture
def log(monkeypatch):
    from autostyle_tts_tpu_torch.utils import timing

    spans = []
    monkeypatch.setattr(timing, "spans", lambda: list(spans))
    return spans


def test_share_of_replayed_steps(log):
    log += [_span(1.0, 5.0, steps=255, graph_replays=254, graph_captures=1, token_reads=256),
            _span(11.0, 15.0, steps=511, graph_replays=0, graph_captures=1),     # traced: left out
            _span(21.0, 29.0, steps=511, graph_replays=511, graph_captures=0),
            _span(21.0, 22.0, name="prefill", steps=7, graph_replays=0),          # not a decode span
            _span(29.5, 31.0, steps=9, graph_replays=0)]                          # outside every record
    assert reader(NAME)(_run()) == pytest.approx(100.0 * (254 + 511) / (255 + 511))


def test_eager_steps_read_zero(log):
    log += [_span(1.0, 5.0, steps=255, graph_replays=0, graph_captures=0)]
    assert reader(NAME)(_run()) == 0.0


@pytest.mark.parametrize("spans", [[], [_span(1.0, 5.0, steps=255, token_reads=256)]])
def test_nothing_without_replay_counters(log, spans):
    log += spans
    assert reader(NAME)(_run()) is None


def test_nothing_without_the_log(monkeypatch):
    from autostyle_tts_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "spans")
    assert reader(NAME)(_run()) is None
