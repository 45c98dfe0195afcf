"""The port's phoneme evaluation (``pipeline/simeval.py``) against the JAX
package's, after ``tests/test_simeval.py``'s cases.

- ``levenshtein``, ``collapse_phoneme_frames`` and ``text_to_phoneme_ids``:
  the JAX test's cases, and equal outputs on seeded random sequences and
  the corpus sample's texts.
- ``PhonemeRecognizer`` with a drawn head on an untrained tiny engine (the
  JAX test's setup: ``Engine(tiny_config(), seed=0)``, head
  ``jax.random.normal(PRNGKey(0), (D, N_PHONEME_CLASSES))``), the port's
  engine on the JAX engine's weights: the same frame ids, transcripts and
  PER.
- On the trained demo engine (``tests/fixtures/demo_engine.npz``):
  ``fit_code_map`` over the six corpus-sample utterances gives the same map,
  and the recognizer with it the same transcripts and PER.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autostyle_tts_tpu.pipeline import engine as jengine
from autostyle_tts_tpu.pipeline import simeval as jsim
from autostyle_tts_tpu.train.synthcorpus import N_PHONEME_CLASSES
from autostyle_tts_tpu.utils import config as jconfig
from autostyle_tts_tpu_torch.ops.resample import resample_poly_np
from autostyle_tts_tpu_torch.pipeline import engine as tengine
from autostyle_tts_tpu_torch.pipeline import simeval as tsim
from autostyle_tts_tpu_torch.train.synthcorpus import PHONE_ID
from autostyle_tts_tpu_torch.utils import config as tconfig
from autostyle_tts_tpu_torch.utils.audio_io import read_wav
from autostyle_tts_tpu_torch.weights import from_jax_tree, load_npz
from torch_one_thread import one_thread  # noqa: F401  (autouse)

FIXTURES = Path(__file__).parent / "fixtures"
SAMPLE = FIXTURES / "demo_corpus_sample"
ROWS = json.loads((SAMPLE / "manifest.json").read_text())


def test_levenshtein_and_collapse():
    L, C = tsim.levenshtein, tsim.collapse_phoneme_frames
    assert L([], []) == 0
    assert L([1, 2, 3], [1, 2, 3]) == 0
    assert L([1, 2, 3], [1, 3]) == 1          # delete
    assert L([1, 2, 3], [1, 2, 4, 3]) == 1    # insert
    assert L([1, 2, 3], [1, 9, 3]) == 1       # substitute
    assert L("kitten", "sitting") == 3        # classic
    assert C([0, 0, 5, 5, 5, 0, 3, 3, 5]) == [5, 3, 5]
    assert C([]) == [] and C([0, 0]) == []
    ids = tsim.text_to_phoneme_ids("ma pa")
    assert ids == [PHONE_ID["m"], PHONE_ID["a"], PHONE_ID["p"], PHONE_ID["a"]]


@pytest.mark.parametrize("seed", range(4))
def test_sequences_match_jax(seed):
    r = np.random.default_rng(seed)
    a, b = r.integers(0, 6, r.integers(0, 30)).tolist(), r.integers(0, 6, r.integers(0, 30)).tolist()
    assert tsim.levenshtein(a, b) == jsim.levenshtein(a, b) == tsim.levenshtein(b, a)
    frames = r.integers(0, 4, 60)
    assert tsim.collapse_phoneme_frames(frames) == jsim.collapse_phoneme_frames(frames)
    for row in ROWS:
        assert tsim.text_to_phoneme_ids(row["text"]) == jsim.text_to_phoneme_ids(row["text"])


def _engines(jcfg, tcfg, tree):
    jeng = jengine.Engine(jcfg, params=jengine.EngineParams.from_tree(
        jax.tree_util.tree_map(jnp.asarray, tree)), seed=0)
    teng = tengine.Engine(tcfg, params=tengine.EngineParams.from_tree(from_jax_tree(tree, tcfg)), seed=0,
                          device="cpu")
    return jeng, teng


def test_phoneme_recognizer_head_on_random_engine():
    jcfg = jconfig.tiny_config()
    tree = jax.tree_util.tree_map(np.asarray, jengine.Engine(jcfg, seed=0).params.tree())
    jeng, teng = _engines(jcfg, tconfig.tiny_config(), tree)
    head = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (jcfg.speech_tokenizer.dim, N_PHONEME_CLASSES)))
    jrec, trec = jsim.PhonemeRecognizer(jeng, head), tsim.PhonemeRecognizer(teng, head)
    sr = jcfg.audio.sample_rate
    t = np.arange(sr) / sr
    for wav in ((0.2 * np.sin(2 * np.pi * 220 * t)).astype(np.float32),
                (0.3 * np.sin(2 * np.pi * 90 * t) + 0.05 * np.random.default_rng(1).standard_normal(sr))
                .astype(np.float32)):
        seq = trec.transcribe(wav)
        assert isinstance(seq, list) and seq == jrec.transcribe(wav)
        per = tsim.phoneme_error_rate(trec, wav, "ma pa ta")
        assert np.isfinite(per) and per >= 0.0 and per == jsim.phoneme_error_rate(jrec, wav, "ma pa ta")
    with pytest.raises(ValueError, match="need head and/or code_map"):
        tsim.PhonemeRecognizer(teng)
    with pytest.raises(ValueError, match="encodes no corpus phonemes"):
        tsim.phoneme_error_rate(trec, wav, "123")


def test_frame_ids_mask_padding_to_silence():
    """Frames past a wav's length are silence (0), whatever the map says."""
    jcfg = jconfig.tiny_config()
    tree = jax.tree_util.tree_map(np.asarray, jengine.Engine(jcfg, seed=0).params.tree())
    _, teng = _engines(jcfg, tconfig.tiny_config(), tree)
    rec = tsim.PhonemeRecognizer(teng, code_map=np.full(jcfg.speech_tokenizer.codebook_size, 3, np.int32))
    T = jcfg.audio.prompt_sample_rate
    ids = rec.frame_ids(torch.zeros(1, T), torch.tensor([T // 4]))[0]
    assert (ids[:2] == 3).all() and (ids[-4:] == 0).all()


@pytest.fixture(scope="module")
def demo_engines():
    return _engines(jconfig.demo_config(), tconfig.demo_config(),
                    load_npz(FIXTURES / "demo_engine.npz"))


def test_fit_code_map_and_per_on_demo_engine(demo_engines):
    jeng, teng = demo_engines
    wavs = [read_wav(SAMPLE / r["wav"])[0] for r in ROWS]
    phns = [np.load(SAMPLE / r["phn"]) for r in ROWS]
    got = tsim.fit_code_map(teng, wavs, phns, batch=4)
    want = jsim.fit_code_map(jeng, wavs, phns, batch=4)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (tconfig.demo_config().speech_tokenizer.codebook_size,) and got.dtype == np.int32
    trec, jrec = tsim.PhonemeRecognizer(teng, code_map=got), jsim.PhonemeRecognizer(jeng, code_map=want)
    rate = tconfig.demo_config().audio.prompt_sample_rate
    for wav, row in zip(wavs, ROWS):
        assert trec.transcribe(wav, rate) == jrec.transcribe(wav, rate)
        # at the output rate, through the resampler
        out_rate = tconfig.demo_config().audio.sample_rate
        w24 = resample_poly_np(wav, rate, out_rate)
        assert tsim.phoneme_error_rate(trec, w24, row["text"]) == jsim.phoneme_error_rate(jrec, w24, row["text"])
