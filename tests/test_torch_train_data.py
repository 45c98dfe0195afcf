"""Port parity for the acoustic training data: ``train/synthcorpus.py``
bitwise against the JAX package's (arrays, wav files, labels, manifest),
``train/data.py``'s manifest loader equal, and ``make_acoustic_batches``
over the port's engine against the JAX package's over the same weights:
integer fields (text ids, lengths, masks, phoneme labels) equal, the
speech tokens equal, float fields (mel, speaker embedding, wav crops)
within 1e-4 of the largest magnitude (featurization in f32 on both sides,
sums in another order); the feature cache featurizes each item once."""

import json

import jax
import numpy as np
import pytest

from autostyle_tts_tpu.pipeline.engine import Engine as JEngine
from autostyle_tts_tpu.pipeline.engine import EngineParams as JParams
from autostyle_tts_tpu.train import data as jdata
from autostyle_tts_tpu.train import synthcorpus as jsc
from autostyle_tts_tpu.utils.config import tiny_config as jtiny
from autostyle_tts_tpu_torch.pipeline.engine import Engine as TEngine
from autostyle_tts_tpu_torch.pipeline.engine import EngineParams as TParams
from autostyle_tts_tpu_torch.train import data as tdata
from autostyle_tts_tpu_torch.train import synthcorpus as tsc
from autostyle_tts_tpu_torch.utils.config import tiny_config as ttiny
from autostyle_tts_tpu_torch.weights import from_jax_tree

from torch_one_thread import one_thread  # noqa: F401


def test_synth_utterance_and_speakers_bitwise():
    for seed in (0, 7):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        assert [s.__dict__ for s in jsc.make_speakers(3, rj)] == [s.__dict__ for s in tsc.make_speakers(3, rt)]
        wj, pj = jsc.synth_utterance(jsc.random_words(rj, 3), jsc.make_speakers(1, rj)[0], rj)
        wt, pt = tsc.synth_utterance(tsc.random_words(rt, 3), tsc.make_speakers(1, rt)[0], rt)
        assert wj.tobytes() == wt.tobytes() and pj.tobytes() == pt.tobytes()
    assert tsc.PHONE_ID == jsc.PHONE_ID and tsc.N_PHONEME_CLASSES == jsc.N_PHONEME_CLASSES


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpora")
    mj = jsc.generate_corpus(d / "j", n_utts=6, n_speakers=2, seed=3)
    mt = tsc.generate_corpus(d / "t", n_utts=6, n_speakers=2, seed=3)
    return d, mj, mt


def test_generate_corpus_files_bitwise(corpora):
    d, mj, mt = corpora
    files_j = sorted(p.relative_to(d / "j") for p in (d / "j").rglob("*") if p.is_file())
    files_t = sorted(p.relative_to(d / "t") for p in (d / "t").rglob("*") if p.is_file())
    assert files_j == files_t and len(files_j) == 6 * 2 + 2
    for rel in files_j:
        assert (d / "j" / rel).read_bytes() == (d / "t" / rel).read_bytes(), rel
    assert tdata.load_acoustic_manifest(mt, str(d / "t")) == [
        tdata.AcousticItem(**it.__dict__) for it in jdata.load_acoustic_manifest(mt, str(d / "t"))]


def test_manifest_variants_load_alike(tmp_path):
    rows = {"a": {"file_id": "x1", "zh_text": "你好"}, "b": {"wav_path": "y.wav", "text": "hi", "speaker": 3}}
    (tmp_path / "m.json").write_text(json.dumps(rows))
    (tmp_path / "m.jsonl").write_text("\n".join(json.dumps(r) for r in rows.values()))
    for name in ("m.json", "m.jsonl"):
        for wav_dir in ("", "/w"):
            want = jdata.load_acoustic_manifest(str(tmp_path / name), wav_dir)
            assert [it.__dict__ for it in tdata.load_acoustic_manifest(str(tmp_path / name), wav_dir)] == [
                it.__dict__ for it in want]


@pytest.fixture(scope="module")
def engines():
    jp = JParams.init(jax.random.PRNGKey(0), jtiny())
    tree = jax.tree_util.tree_map(np.asarray, jp.tree())
    cfg = ttiny()
    return JEngine(jtiny(), params=jp), TEngine(cfg, params=TParams.from_tree(from_jax_tree(tree, cfg)),
                                                device="cpu")


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    if a.dtype.kind in "iub":
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert float(np.abs(a - b).max(initial=0)) <= 1e-4 * max(float(np.abs(b).max(initial=0)), 1.0), what


def test_acoustic_batches_match_jax(corpora, engines):
    d, mj, mt = corpora
    jeng, teng = engines
    items = tdata.load_acoustic_manifest(mt, str(d / "t"))
    jitems = jdata.load_acoustic_manifest(mt, str(d / "t"))
    kw = dict(batch_size=2, prompt_seconds=0.4, seed=1, stages=("tokenizer", "token_lm", "cfm", "vocoder"))
    cache = {}
    tb = list(tdata.make_acoustic_batches(teng, items, cache=cache, **kw))
    jb = list(jdata.make_acoustic_batches(jeng, jitems, **kw))
    assert len(tb) == len(jb) == 3
    for t, j in zip(tb, jb):
        assert t.keys() == j.keys()
        for stage in t:
            assert t[stage].keys() == j[stage].keys()
            for k in t[stage]:
                assert str(t[stage][k].device) == "cpu"
                _close(t[stage][k].numpy(), j[stage][k], f"{stage}/{k}")
    # a second epoch reads every item from the cache: no featurization
    calls = []
    orig = teng.prompt_features
    teng.prompt_features = lambda wavs, *a: calls.append(len(wavs)) or orig(wavs, *a)
    try:
        assert len(list(tdata.make_acoustic_batches(teng, items, cache=cache, **dict(kw, seed=2)))) == 3
    finally:
        del teng.prompt_features
    assert calls == [] and len(cache) == 6


def test_tokenizer_stage_batches_never_featurize(corpora, engines):
    d, _, mt = corpora
    _, teng = engines
    items = tdata.load_acoustic_manifest(mt, str(d / "t"))
    calls = []
    teng.prompt_features = lambda wavs, *a: calls.append(1)
    try:
        b = next(tdata.make_acoustic_batches(teng, items, 3, shuffle=False, stages=("tokenizer",)))
    finally:
        del teng.prompt_features
    assert calls == [] and set(b) == {"tokenizer"}
    labels = np.load(items[0].phn_path)
    n = min(len(labels), b["tokenizer"]["phn"].shape[1])
    np.testing.assert_array_equal(b["tokenizer"]["phn"][0, :n].numpy(), labels[:n])
