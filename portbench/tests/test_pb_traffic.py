"""The traffic generator: the same requests for the same seed, the mix's
shares of lengths as stated, the same multiset of sizes for every seed."""

from __future__ import annotations

import json
from collections import Counter
from itertools import islice

import numpy as np
import pytest

from portbench.bench.spec import BENCH_DIR
from portbench.traffic.generator import Traffic


def mix(name):
    return json.loads((BENCH_DIR / "workloads" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["b1-db", "batch8"])
def test_deterministic_per_seed(name):
    a = list(islice(Traffic(mix(name), 2 ** 31 + 3).requests(), 40))
    b = list(islice(Traffic(mix(name), 2 ** 31 + 3).requests(), 40))
    c = list(islice(Traffic(mix(name), 2 ** 31 + 4).requests(), 40))
    assert [(r.target, r.text) for r in a] == [(r.target, r.text) for r in b]
    assert all(np.array_equal(x.query, y.query) for x, y in zip(a, b))
    assert [r.text for r in a] != [r.text for r in c]


def test_wav_requests_deterministic_and_distinct():
    m = mix("b1-wav")
    t = Traffic(m, 77)
    pool = t.wav_pool()
    a = list(islice(t.requests(pool), 6))
    b = list(islice(Traffic(m, 77).requests(Traffic(m, 77).wav_pool()), 6))
    for x, y in zip(a, b):
        assert x.wav_ids == y.wav_ids and all(np.array_equal(p, q) for p, q in zip(x.wavs, y.wavs))
    assert len(pool) == 64
    lens = sorted(len(w) / 16000 for w in pool)
    assert abs(lens[0] - 2.0) < 1e-3 and abs(lens[-1] - 8.0) < 1e-3
    assert not np.array_equal(a[0].wavs[0], a[1].wavs[0])


def test_b1_shares_and_same_sizes_for_every_seed():
    m = mix("b1-db")
    counts = [Counter(islice(Traffic(m, s).targets(), 100)) for s in (1, 2 ** 31 + 17)]
    assert counts[0] == counts[1] == Counter({64: 25, 128: 45, 256: 22, 512: 8})
    t = list(islice(Traffic(m, 1).targets(), 100))
    assert t != list(islice(Traffic(m, 2).targets(), 100))
    mean_s = np.mean(t) / m["token_rate"]
    assert 6.7 < mean_s < 6.9


def test_batch8_batches_hold_the_same_sizes_for_every_seed():
    m = mix("batch8")
    want = [sorted(int(n) for n, c in g.items() for _ in range(c)) for g in m["lengths"]["blocks"][0]]
    assert len(want) == m["window_units"] == 4 and all(len(b) == m["batch"] for b in want)
    for s in (5, 2 ** 31 + 1):
        t = list(islice(Traffic(m, s).targets(), 64))
        batches = [sorted(t[i:i + 8]) for i in range(0, 64, 8)]
        assert batches == want + want
    assert t != list(islice(Traffic(m, 6).targets(), 64))


def test_batch8_blocks_keep_the_shares_and_the_steps():
    m = mix("batch8")
    t = list(islice(Traffic(m, 3).targets(), 32))
    assert Counter(t) == Counter({64: 8, 128: 14, 256: 7, 512: 3})       # 25 / 44 / 22 / 9 %
    assert sorted(max(t[i:i + 8]) for i in range(0, 32, 8)) == [256, 256, 512, 512]


def test_texts_fit_the_text_bucket():
    m = mix("b1-db")
    t = Traffic(m, 9)
    reqs = list(islice(t.requests(), 200))
    words = [len(r.text.split()) for r in reqs if r.target == 512]
    assert words and max(len(r.text) for r in reqs) <= 341
    assert 40 <= np.mean(words) <= 52


def test_db_rows_cycle_the_prompt_wavs():
    m = dict(mix("b1-db"))
    m["db"] = dict(m["db"], rows=140, dim=16)
    db = Traffic(m, 3).db_rows()
    assert db["vectors"].shape == (140, 16) and len(db["wavs"]) == 128
    assert list(db["wav_of_row"][:130]) == list(range(128)) + [0, 1]
    assert db["transcripts"][0] == db["transcripts"][128]


class _Batches:
    """A stand-in for a session serving batches that take ``seconds`` each."""

    def __init__(self, m, seconds):
        from portbench.programs.tts import SpanLog

        self.mix, self.cfg, self.pool = m, {}, None
        self.traffic = Traffic(m, 4)
        self.seconds, self.served = seconds, []
        self.taps, self.spans = SpanLog(), SpanLog()

    def requests(self):
        return self.traffic.requests(self.pool)

    @staticmethod
    def counters():
        return {"8": 0, "4": 0}

    def serve_batch(self, reqs, j):
        import time

        t0 = time.perf_counter()
        time.sleep(self.seconds)
        self.served.append(max(r.target for r in reqs))
        return dict(i=j, t0=t0, t1=time.perf_counter())


@pytest.mark.parametrize("seconds,blocks", [(0.01, 1), (0.2, 1), (0.45, 2)])
def test_a_batch_window_holds_whole_blocks(seconds, blocks):
    from portbench.bench.window import measure

    m = mix("batch8")
    sess = _Batches(m, 0.1)
    run = measure(sess, seconds, 0.0, trace=False)
    assert len(run.records) == blocks * m["window_units"]
    assert sorted(sess.served) == sorted([512, 512, 256, 256] * blocks)
    assert run.window_s >= seconds and run.counters == {"8": 0, "4": 0} and "proc_cores" in run.host
