"""The port's span recorder (``utils/timing.py``) on the CPU at tiny
geometry: a request's span tree (one request id, parents, children inside
their parents, self time, the decode's steps, token reads and path), no
synchronize in ``span()``, a subclass shaped like the benchmark's that
syncs after the body without entering the body's waits, the DB search's
span, and the log's bound. On the card (marked ``gpu``): the phases whose
host time a metric reports block the host only through the clock."""

from __future__ import annotations

import dataclasses
import time
import traceback
import warnings
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from autostyle_tts_tpu_torch.models import token_lm
from autostyle_tts_tpu_torch.pipeline import rag
from autostyle_tts_tpu_torch.pipeline.engine import Engine, PromptFeatures
from autostyle_tts_tpu_torch.retrieval.store import StyleStore
from autostyle_tts_tpu_torch.utils import timing
from autostyle_tts_tpu_torch.utils.config import tiny_config
from autostyle_tts_tpu_torch.utils.timing import Stopwatch
from autostyle_tts_tpu_torch.weights import quantize_tree

from torch_one_thread import one_thread  # noqa: F401  (autouse)

PHASES = {"prefill", "decode", "cfm", "vocoder"}


def _cfg(int4: bool = False):
    cfg = tiny_config()
    cfg.quantize_lm_int8 = True
    cfg.quantize_lm_kv_int8 = True
    cfg.quantize_lm_int4 = int4
    return cfg


def _wav(cfg, hz: float, seconds: float = 1.0) -> np.ndarray:
    sr = cfg.audio.prompt_sample_rate
    t = np.arange(int(sr * seconds)) / sr
    return (0.3 * np.sin(2 * np.pi * hz * t)).astype(np.float32)


@pytest.fixture
def drawn(monkeypatch):
    """Every step's tokens the decode loops yield to ``finish``."""
    out = []

    def finish(loop):
        while True:
            try:
                out.append(next(loop))
            except StopIteration as stop:
                return stop.value

    monkeypatch.setattr(token_lm, "finish", finish)
    return out


def _check_tree(trace):
    by_id = {s.id: s for s in trace}
    assert len({s.request for s in trace}) == 1
    roots = [s for s in trace if s.parent is None]
    assert [r.name for r in roots] == ["request"]
    for s in trace:
        assert s.self_ms >= -1e-9 and s.wait_ms >= 0 and s.host_ms >= -1e-9, (s.name, s.ms, s.wait_ms)
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.t0 <= s.t0 <= s.t1 <= up.t1, (up.name, s.name)
    names = {s.name: s for s in trace}
    for phase in PHASES:
        assert names[phase].parent == roots[0].id
    for child in ("cfm.cond", "cfm.solve"):
        assert names[child].parent == names["cfm"].id
    assert names["cfm.solve"].counters["euler_steps"] >= 1 and names["cfm.solve"].counters["frames"] > 0
    # the phases end on their reads or waits: one each beside the token reads
    for phase in ("prefill", "cfm"):
        assert names[phase].counters["waits"] == 1
    assert names["vocoder"].counters["reads"] == 1
    return names


def test_db_request_span_tree(drawn):
    cfg = _cfg()
    eng = Engine(cfg, device="cpu", seed=1)
    store = StyleStore(dim=8, capacity=16, device="cpu")
    r = np.random.default_rng(0)
    store.insert(r.standard_normal((4, 8)).astype(np.float32), [{"file_id": f"s{i}", "text": f"style {i}"}
                                                                 for i in range(4)])
    store.artifacts = rag.prompt_artifacts(eng, [_wav(cfg, 200 + 40 * i) for i in range(4)])
    t_mark = time.perf_counter()
    hits = store.search(r.standard_normal((1, 8)).astype(np.float32), k=2)[0]
    sty, tim = eng.prompt_features_from_store(store, [hits[0].index, hits[1].index])
    wav = next(eng.inference_tts_with_st("hello there", hits[0].text, sty, tim, max_seconds=2))["tts_speech"]
    assert wav.shape[1] > 0
    trace = eng.last_trace
    names = _check_tree(trace)
    assert set(eng.last_timings) == PHASES
    for phase in PHASES:
        assert eng.last_timings[phase] == pytest.approx(names[phase].ms)
    dec = names["decode"]
    assert dec.counters["steps"] == eng.last_decode_steps > 0
    assert dec.counters["token_reads"] == len(drawn) == eng.last_decode_steps + 1
    assert dec.attrs == {"path": "int8", "kv_int8": False}
    assert names["prefill"].counters["rows"] > 0
    # the search is a trace of its own, logged before the request's spans
    new = [s for s in timing.spans() if s.t0 >= t_mark]
    search = [s for s in new if s.name == "db_search"]
    assert len(search) == 1 and search[0].parent is None and search[0].request != trace[0].request
    assert new[-len(trace):] == trace


def test_batch_span_tree(drawn):
    cfg = _cfg()
    eng = Engine(cfg, device="cpu", seed=2)
    w1, w2 = _wav(cfg, 210), _wav(cfg, 330, 1.5)
    wavs = eng.synthesize_batch(["a b c", "d e"], ["s1", "s2"], [w1, w2], [w2, w1], max_seconds=2)
    assert len(wavs) == 2
    names = _check_tree(eng.last_trace)
    assert set(eng.last_timings) == PHASES | {"featurize"}
    assert names["featurize"].counters["reads"] == 1
    dec = names["decode"]
    assert dec.counters["steps"] == eng.last_decode_steps > 0
    assert dec.counters["token_reads"] == len(drawn) and all(len(d) == 2 for d in drawn)
    assert dec.attrs == {"path": "scanned", "kv_int8": True, "graph": False}
    assert dec.counters["graph_replays"] == dec.counters["graph_captures"] == 0
    # the request holds its phases' waits and its own read, the LM's seed
    req = names["request"]
    assert req.wait_ms >= sum(names[p].wait_ms for p in PHASES | {"featurize"})
    assert req.counters == {"reads": 3, "waits": 3, "token_reads": dec.counters["token_reads"]}


@pytest.mark.parametrize("path", ["int8", "int4", "layers", "scanned"])
def test_decode_path_attribute(path, drawn):
    cfg = _cfg()
    tl = cfg.token_lm
    lm = quantize_tree(token_lm.init_params(tl, torch.Generator().manual_seed(0)))
    mp = token_lm.mega_decode_params(lm, tl)
    decode_params = {"int8": mp, "int4": token_lm.requantize_int4(mp) if path == "int4" else None,
                     "layers": token_lm.unstack_decode_params(lm, tl), "scanned": None}[path]
    r = np.random.default_rng(1)
    ids = (torch.from_numpy(r.integers(16, 200, (1, 10)).astype(np.int32)), torch.tensor([10], dtype=torch.int32),
           torch.from_numpy(r.integers(0, 64, (1, 6)).astype(np.int32)), torch.tensor([6], dtype=torch.int32),
           torch.from_numpy(r.standard_normal((1, tl.spk_dim)).astype(np.float32)))
    clock = Stopwatch(torch.device("cpu"))
    with clock.open("request"):
        gen = token_lm.generate_speech_from_ids(lm, tl, *ids, torch.Generator().manual_seed(3), max_new_tokens=24,
                                                decode_params=decode_params, kv_int8=path == "scanned", clock=clock)
    dec = [s for s in clock.spans if s.name == "decode"]
    assert len(dec) == 1
    want = {"path": path, "kv_int8": path == "scanned"}
    assert dec[0].attrs == (dict(want, graph=False) if path == "scanned" else want)
    assert dec[0].counters["steps"] == gen.decode_steps > 0
    assert dec[0].counters["token_reads"] == len(drawn)


def test_span_does_not_synchronize(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append(1))
    clock = Stopwatch(torch.device("cuda"))
    with clock.open("request"), clock.span("prefill"), clock.open("child"):
        pass
    assert calls == []
    with clock.span("cfm"):
        clock.wait()
    assert calls == [1]
    assert clock.spans[-1].counters == {"waits": 1}


class BenchLike(Stopwatch):
    """Shaped like the benchmark's traced-run subclass: ``super().span``,
    then a sync of its own after the body."""

    SYNC_S = 0.05

    def __init__(self, device):
        super().__init__(device)
        self.sync_s = []

    @contextmanager
    def span(self, name):
        with super().span(name):
            try:
                yield
            finally:
                self._sync()

    def _sync(self):
        t0 = time.perf_counter()
        time.sleep(self.SYNC_S)
        self.sync_s.append(time.perf_counter() - t0)


def test_benchmark_subclass_sync_stays_out_of_the_waits(monkeypatch):
    body_wait_s = 0.02
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: time.sleep(body_wait_s))
    clock = BenchLike(torch.device("cuda"))
    with clock.open("request"):
        with clock.span("cfm"):
            with clock.open("cfm.solve"):
                pass
            t0 = time.perf_counter()
            clock.wait()
            waited_ms = (time.perf_counter() - t0) * 1e3
    cfm = next(s for s in clock.spans if s.name == "cfm")
    assert len(clock.sync_s) == 1
    assert waited_ms - 1.0 <= cfm.wait_ms <= waited_ms
    assert cfm.wait_ms < BenchLike.SYNC_S * 1e3
    # the subclass's own sync adds to the host time no more than it took
    assert cfm.host_ms <= clock.sync_s[0] * 1e3 + 5.0
    assert clock.ms["cfm"] == pytest.approx(cfm.ms)
    assert "cfm.solve" not in clock.ms and "request" not in clock.ms


def test_store_search_logs_one_span():
    store = StyleStore(dim=4, capacity=8, device="cpu")
    store.insert(np.eye(4, dtype=np.float32), [{"file_id": str(i)} for i in range(4)])
    t_mark = time.perf_counter()
    hits = store.search(np.eye(4, dtype=np.float32)[:3], k=2)
    assert [h[0].index for h in hits] == [0, 1, 2]
    new = [s for s in timing.spans() if s.t0 >= t_mark]
    assert [s.name for s in new] == ["db_search"]
    s = new[0]
    assert s.parent is None and s.counters == {"rows": 8, "k": 2, "queries": 3, "reads": 1}
    assert 0 <= s.wait_ms <= s.ms


def test_log_stays_at_its_bound():
    clock = Stopwatch(torch.device("cpu"))
    for _ in range(timing.LOG_SPANS + 10):
        with clock.open("x"):
            pass
    log = timing.spans()
    assert len(log) == timing.LOG_SPANS
    assert log[-1] is clock.spans[-1] and log[0] is clock.spans[10]


def test_tally_counts_on_the_innermost_open_span():
    timing.tally(collectives=1)      # no span open: dropped
    clock = Stopwatch(torch.device("cpu"))
    with clock.open("request"), clock.span("vocoder"):
        timing.tally(collectives=1, collective_ms=0.5)
        timing.tally(collectives=1, collective_ms=0.25)
    voc, req = clock.spans
    assert voc.counters == {"collectives": 2, "collective_ms": 0.75} and req.counters == {}


REPORTED = PHASES | {"featurize"}     # the phases whose host ms a per-layer metric reads


@pytest.mark.gpu
@pytest.mark.parametrize("int4,vocoder", [(False, "hifigan"), (False, "istft"), (True, "istft")])
def test_reported_phases_block_only_through_the_clock(int4, vocoder, monkeypatch):
    """On the card, under torch's sync debug mode: in a B=1 DB-served
    request through the decode kernel, a B=1 wav-prompt request and a B=2
    batch, no synchronizing call inside a phase whose host ms a metric
    reads, other than the clock's own ``read`` / ``wait`` (a hidden one
    would count the device's time as the host's). The serving
    configurations' vocoder is the iSTFT head."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = _cfg(int4)
    if vocoder == "istft":
        cfg.vocoder = dataclasses.replace(cfg.vocoder, kind="istft", istft_hop=cfg.audio.hop_length,
                                          istft_n_fft=4 * cfg.audio.hop_length, istft_channels=32, istft_blocks=2)
    eng = Engine(cfg, seed=4, device=dev)
    assert eng._mega_params is not None
    r = np.random.default_rng(5)
    feat = PromptFeatures(tokens=r.integers(0, 64, 40).astype(np.int32),
                          spk=r.standard_normal(cfg.speaker.emb_dim).astype(np.float32),
                          mel24=r.standard_normal((80, cfg.cfm.n_mels)).astype(np.float32))
    wav = _wav(cfg, 220)

    def requests():
        next(eng.inference_tts_with_st("a stored prompt", "style", feat, feat, max_seconds=2.0))
        next(eng.inference_tts_with_st("a prompt wav", "style", wav, wav, max_seconds=2.0))
        eng.synthesize_batch(["one row", "two rows"], ["s1", "s2"], [feat, feat], [feat, feat], max_seconds=2.0)

    requests()     # builds the kernels and warms every shape

    def quiet(f):
        def run(*a, **k):
            torch.cuda.set_sync_debug_mode(0)
            try:
                return f(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("warn")
        return run

    monkeypatch.setattr(Stopwatch, "read", quiet(Stopwatch.read))
    monkeypatch.setattr(Stopwatch, "wait", quiet(Stopwatch.wait))
    found = []

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):     # where: the innermost frame of the package, else the caller's
            ours = [f for f in traceback.extract_stack() if "autostyle_tts_tpu_torch" in f.filename]
            at = f"{ours[-1].filename}:{ours[-1].lineno}" if ours else f"{filename}:{lineno}"
            found.append((tuple(s.name for s in timing._OPEN), at))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            requests()
            torch.ones(1, device=dev).item()     # a hidden sync outside every span: seen
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert found and found[-1][0] == () and found[-1][1].rsplit(":", 1)[0] == __file__
    hidden = sorted({(names[-1], at) for names, at in found if REPORTED & set(names)})
    assert not hidden, "hidden syncs (innermost span, call site):\n" + "\n".join(f"{n} {at}" for n, at in hidden)
