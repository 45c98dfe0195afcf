"""The reader of ``window_graph_share.stream`` on a synthetic span log: the
``cfm`` spans of stream windows inside the records the profiler did not
cover give the share that a graph replay served; ``cfm`` spans without the
counter (a whole utterance's) are left out; a log with none of them, or no
log at all, gives nothing and raises nothing."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench.bench.readers import reader
from portbench.programs import tts

NAME = "window_graph_share.stream"


def _run():
    """Two requests outside the traced part and one inside it."""
    recs = [dict(i=0, t0=0.0, t1=10.0), dict(i=1, t0=10.0, t1=20.0), dict(i=2, t0=20.0, t1=30.0)]
    return SimpleNamespace(records=recs, traced={1}, program=tts)


def _span(t0, t1, name="cfm", **counters):
    return SimpleNamespace(name=name, t0=t0, t1=t1, counters=counters)


@pytest.fixture
def log(monkeypatch):
    from autostyle_tts_tpu_torch.utils import timing

    spans = []
    monkeypatch.setattr(timing, "spans", lambda: list(spans))
    return spans


def test_share_of_replayed_windows(log):
    log += [_span(1.0, 1.5, graph_replays=0, graph_captures=1, euler_steps=2, frames=192),
            _span(2.0, 2.5, graph_replays=1, graph_captures=0),
            _span(3.0, 3.5, graph_replays=1, graph_captures=0),
            _span(11.0, 11.5, graph_replays=0, graph_captures=1),            # traced: left out
            _span(21.0, 21.5, graph_replays=1, graph_captures=0),
            _span(22.0, 22.5, name="vocoder", graph_replays=0),              # not a cfm span
            _span(29.5, 31.0, graph_replays=0)]                              # outside every record
    assert reader(NAME)(_run()) == pytest.approx(100.0 * 3 / 4)


def test_whole_utterance_cfm_spans_are_left_out(log):
    log += [_span(1.0, 3.0, waits=1), _span(4.0, 4.5, graph_replays=1, graph_captures=0),
            _span(21.0, 25.0, waits=1)]
    assert reader(NAME)(_run()) == 100.0


def test_eager_windows_read_zero(log):
    log += [_span(1.0, 1.5, graph_replays=0, graph_captures=0), _span(2.0, 2.5, graph_replays=0)]
    assert reader(NAME)(_run()) == 0.0


@pytest.mark.parametrize("spans", [[], [_span(1.0, 5.0, waits=1), _span(21.0, 22.0, waits=1)]])
def test_nothing_without_replay_counters(log, spans):
    log += spans
    assert reader(NAME)(_run()) is None


def test_nothing_without_the_log(monkeypatch):
    from autostyle_tts_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "spans")
    assert reader(NAME)(_run()) is None
