"""The trained demo engine through the port, on the CPU, held to the JAX
package's own quality gates (``tests/test_trained_demo.py``).

Fixture: ``tests/fixtures/demo_engine.npz``, ``demo_config()`` trained on
the formant corpus (a dense 256-wide, 4-layer token LM and a HiFi-GAN
vocoder at base 192; f16 leaves, loaded as f32), with six held-out 16 kHz
utterances in ``demo_corpus_sample/`` and the golden per-mel-bin statistics
in ``golden_quality.json``.

Both gates run voice conversion (``inference_vc``: featurize, CFM, HiFi-GAN;
no LM) on ``rows[:3]``. The port is handed the CFM noise a fresh JAX
``Engine(seed=0)`` draws on that path (its key split once, then
``jax.random.normal``), so the comparison with the golden statistics is like
for like and a miss is the port's, not the random stream's. The same draws
are recorded in ``demo_vc_noise.npz`` (``scripts/make_demo_vc_noise.py``)
for ``chip_smoke.py``, which has no JAX; they are checked here against a
fresh draw. Thresholds are the JAX package's: sample count exact; rms
within 0.3 g + 1e-3; mean |delta mel mean| and mean |delta mel std| each
below 0.3; the token round trip over 10 tokens a row with a mean agreement
above 0.85. On the same noise those thresholds prove little, so two
like-for-like bounds stand beside them: the golden statistics (the JAX
engine's, rounded to 1e-5) within rms 1e-4 and mel 1e-3 (measured: rms
within 5e-6, mel 2.5e-5 to 2.8e-5), and the port's wav against the JAX
engine's own wav at atol 2e-4 (measured: at most 6.1e-5; f32 on both sides
through the CFM and a HiFi-GAN, in another summation order).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autostyle_tts_tpu.pipeline import engine as jengine
from autostyle_tts_tpu.utils import config as jconfig
from autostyle_tts_tpu_torch.ops import stft
from autostyle_tts_tpu_torch.pipeline import engine as tengine
from autostyle_tts_tpu_torch.pipeline.simeval import token_round_trip
from autostyle_tts_tpu_torch.utils.audio_io import read_wav
from autostyle_tts_tpu_torch.utils.config import demo_config
from autostyle_tts_tpu_torch.weights import QTensor, from_jax_tree, load_npz, tree_map

FIXTURES = Path(__file__).parent / "fixtures"
FIXTURE = FIXTURES / "demo_engine.npz"
SAMPLE = FIXTURES / "demo_corpus_sample"
GOLDEN = FIXTURES / "golden_quality.json"
NOISE = FIXTURES / "demo_vc_noise.npz"
ROWS = json.loads((SAMPLE / "manifest.json").read_text())[:3]


@pytest.fixture(scope="module")
def engine():
    cfg = demo_config()
    params = tengine.EngineParams.from_tree(from_jax_tree(load_npz(FIXTURE), cfg))
    return tengine.Engine(cfg, params=params, device="cpu")


def _src(engine, row):
    wav, sr = read_wav(SAMPLE / row["wav"])
    assert sr == engine.cfg.audio.prompt_sample_rate
    return wav


def _jax_vc_noise(engine, feats):
    """The CFM noise of a fresh JAX ``Engine(seed=0)``'s first
    ``inference_vc``: its key PRNGKey(0 + 17) split once."""
    cfg = engine.cfg
    fp_w = tengine._bucket(len(feats.tokens), tengine.TOKEN_BUCKETS)
    max_new = tengine._bucket(len(feats.tokens), tengine.GEN_BUCKETS)
    _, sub = jax.random.split(jax.random.PRNGKey(17))
    shape = (1, (fp_w + max_new) * cfg.cfm.upsample, cfg.cfm.n_mels)
    return np.asarray(jax.random.normal(sub, shape, jnp.float32))


@pytest.fixture(scope="module")
def conversions(engine):
    """Each row converted to its own voice: (source tokens, wav)."""
    out = []
    for row in ROWS:
        src = _src(engine, row)
        feats = engine.prompt_features([src])[0]
        wav = next(engine.inference_vc(src, src, cfm_noise=_jax_vc_noise(engine, feats)))["tts_speech"]
        out.append((feats.tokens, np.asarray(wav).ravel()))
    return out


@pytest.fixture(scope="module")
def jax_params():
    return jengine.EngineParams.from_tree(jax.tree_util.tree_map(jnp.asarray, load_npz(FIXTURE)))


@pytest.mark.parametrize("i", range(len(ROWS)))
def test_vc_wav_matches_jax_engine(engine, conversions, jax_params, i):
    """Like for like: the port's conversion against the wav of the fresh JAX
    ``Engine(seed=0)`` whose CFM noise it was handed."""
    jeng = jengine.Engine(jconfig.demo_config(), params=jax_params, seed=0)
    src = _src(engine, ROWS[i])
    want = np.asarray(next(jeng.inference_vc(src, src))["tts_speech"]).ravel()
    _, got = conversions[i]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_recorded_vc_noise_is_the_jax_engines(engine, conversions):
    with np.load(NOISE) as rec:
        assert sorted(rec.files) == sorted(Path(r["wav"]).stem for r in ROWS)
        for row, (tokens, _) in zip(ROWS, conversions):
            feats = tengine.PromptFeatures(tokens=tokens, spk=None, mel24=None)
            np.testing.assert_array_equal(rec[Path(row["wav"]).stem], _jax_vc_noise(engine, feats))


def test_demo_engine_loads_with_every_shape_checked():
    cfg = demo_config()
    tree = load_npz(FIXTURE)
    leaves = []
    tree_map(lambda a: leaves.append(a), tree)
    assert len(leaves) == 293 and all(a.dtype == np.float32 for a in leaves)
    params = from_jax_tree(tree, cfg)
    assert params["vocoder"]["ups"][0]["t"]["w"].shape == (10, 192, 96)
    assert not isinstance(params["token_lm"]["layers"]["wqkv"], QTensor)   # a dense LM
    eng = tengine.Engine(cfg, params=tengine.EngineParams.from_tree(params), device="cpu")
    assert eng._mega_params is None      # dense: the scanned decode
    assert eng.params.token_lm["layers"]["wqkv"].dtype == torch.bfloat16
    bad = load_npz(FIXTURE)
    bad["vocoder"]["ups"][1]["mrf"][2]["layers"].pop()
    with pytest.raises(ValueError, match="vocoder/ups/1/mrf/2"):
        from_jax_tree(bad, cfg)
    bad = load_npz(FIXTURE)
    bad["token_lm"]["tok_emb"] = bad["token_lm"]["tok_emb"][:, :128]
    with pytest.raises(ValueError, match="token_lm/tok_emb"):
        from_jax_tree(bad, cfg)


@pytest.mark.parametrize("i", range(len(ROWS)))
def test_golden_wav_regression(engine, conversions, i):
    g = json.loads(GOLDEN.read_text())[ROWS[i]["wav"]]
    a = engine.cfg.audio
    _, wav = conversions[i]
    assert wav.size == g["n_samples"], (wav.size, g["n_samples"])
    rms = float(np.sqrt((wav ** 2).mean()))
    assert abs(rms - g["rms"]) < 0.3 * g["rms"] + 1e-3, (rms, g["rms"])
    mel = stft.log_mel_spectrogram(torch.from_numpy(wav[None]), a.sample_rate, a.n_fft, a.hop_length,
                                   a.win_length, n_mels=a.n_mels, fmax=a.fmax)[0].numpy()
    dmean = float(np.abs(mel.mean(0) - np.asarray(g["mel_mean"])).mean())
    dstd = float(np.abs(mel.std(0) - np.asarray(g["mel_std"])).mean())
    assert dmean < 0.3 and dstd < 0.3, (dmean, dstd)
    assert abs(rms - g["rms"]) < 1e-4 and dmean < 1e-3 and dstd < 1e-3, (rms, g["rms"], dmean, dstd)


def test_token_round_trip(engine, conversions):
    agrees = []
    for tokens, wav in conversions:
        agree, n = token_round_trip(engine, wav, tokens)
        assert n > 10, n
        agrees.append(agree)
    assert float(np.mean(agrees)) > 0.85, agrees
