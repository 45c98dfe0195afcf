"""The trained demo engine through the port, on the CPU, held to the JAX
package's own quality gates (``tests/test_trained_demo.py``).

Fixture: ``tests/fixtures/demo_engine.npz``, ``demo_config()`` trained on
the formant corpus (a dense 256-wide, 4-layer token LM and a HiFi-GAN
vocoder at base 192; f16 leaves, loaded as f32), with six held-out 16 kHz
utterances in ``demo_corpus_sample/`` and the golden per-mel-bin statistics
in ``golden_quality.json``.

The golden and round-trip gates run voice conversion (``inference_vc``:
featurize, CFM, HiFi-GAN; no LM) on ``rows[:3]``. The port is handed the CFM noise a fresh JAX
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

The other five gates of the JAX file run here at its thresholds:

- the speech tokens' phoneme purity over all six rows above 0.90 (and
  three times chance), the tokens equal to the JAX engine's;
- a zero-shot line (the LM on the port's own draws) speech-like: finite,
  over 0.3 s, rms above 0.01, over 90% of its energy below 4 kHz;
- speaker similarity: a line rendered in speaker A's timbre scores closer
  to A than to speaker B on ``SpeakerScorer``;
- the trained iSTFT vocoder (``demo_vocoder_istft.npz``, loaded by
  ``weights.load_tree``) resynthesizes the six rows below mel-L1 0.40, and
  the JAX vocoder on the same mels lands within 1e-3 of that;
- the distilled 2-step CFM (``demo_cfm_distilled.npz``) tracks the
  10-step CFG teacher: student-to-teacher L1 below 0.6 of the undistilled
  2-step run's, and its ground-truth L1 within 0.10 of the teacher's, on
  the JAX noise of ``PRNGKey(4)``; the four L1 values are also held to the
  JAX package's own on the same inputs, within 1e-3.
"""

import dataclasses
import json
from collections import Counter, defaultdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autostyle_tts_tpu.models import cfm as jcfm
from autostyle_tts_tpu.models import vocoder as jvocoder
from autostyle_tts_tpu.ops import stft as jstft
from autostyle_tts_tpu.pipeline import engine as jengine
from autostyle_tts_tpu.utils import config as jconfig
from autostyle_tts_tpu.utils.checkpoint import load_pytree
from autostyle_tts_tpu_torch.models import cfm, vocoder
from autostyle_tts_tpu_torch.ops import stft
from autostyle_tts_tpu_torch.ops.resample import resample_poly_np
from autostyle_tts_tpu_torch.pipeline import engine as tengine
from autostyle_tts_tpu_torch.pipeline.simeval import SpeakerScorer, token_round_trip
from autostyle_tts_tpu_torch.utils.audio_io import read_wav
from autostyle_tts_tpu_torch.utils.config import demo_config
from autostyle_tts_tpu_torch.weights import QTensor, from_jax_tree, load_npz, load_tree, tree_map

FIXTURES = Path(__file__).parent / "fixtures"
FIXTURE = FIXTURES / "demo_engine.npz"
SAMPLE = FIXTURES / "demo_corpus_sample"
GOLDEN = FIXTURES / "golden_quality.json"
NOISE = FIXTURES / "demo_vc_noise.npz"
ISTFT = FIXTURES / "demo_vocoder_istft.npz"
DISTILLED = FIXTURES / "demo_cfm_distilled.npz"
ALL_ROWS = json.loads((SAMPLE / "manifest.json").read_text())
ROWS = ALL_ROWS[:3]


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


# ----------------------------------------------------------------------- the other five gates


def test_tokenizer_is_phonetic(engine, jax_params):
    """Frames of one phoneme map to few speech codes: the share of frames
    whose code is their phoneme's majority code above 0.90 (JAX: 1.0).
    On this fixture the tokenizer gives every frame the same code (64), on
    the JAX engine as on the port, so the purity is 1.0 by construction;
    the port's tokens are also held equal to the JAX engine's."""
    jeng = jengine.Engine(jconfig.demo_config(), params=jax_params, seed=0)
    votes = defaultdict(Counter)
    total = 0
    for row in ALL_ROWS:
        src = _src(engine, row)
        tokens = engine.prompt_features([src])[0].tokens
        np.testing.assert_array_equal(tokens, jeng.prompt_features([src])[0].tokens)
        phn = np.load(SAMPLE / row["phn"])
        n = min(len(tokens), len(phn))
        for t, p in zip(tokens[:n], phn[:n]):
            votes[int(p)][int(t)] += 1
            total += 1
    purity = sum(c.most_common(1)[0][1] for c in votes.values()) / max(total, 1)
    chance = 3.0 / max(len(votes), 1)
    assert purity > max(0.90, chance), (purity, len(votes))


def _speech_like(wav, sr):
    spec = np.abs(np.fft.rfft(wav * np.hanning(wav.size))) ** 2
    low = spec[np.fft.rfftfreq(wav.size, 1 / sr) < 4000].sum() / max(spec.sum(), 1e-9)
    return float(np.sqrt((wav ** 2).mean())), float(low)


def test_resynthesis_is_speech_like(engine):
    """rows[-1]'s text on rows[0]'s prompt, zero-shot, on the port's own
    draws: finite, over 0.3 s, rms above 0.01, low-band share above 0.90
    (JAX: 0.996)."""
    prompt = _src(engine, ALL_ROWS[0])
    wav = next(engine.inference_zero_shot(ALL_ROWS[-1]["text"], ALL_ROWS[0]["text"], prompt))["tts_speech"]
    wav = np.asarray(wav).ravel()
    sr = engine.cfg.audio.sample_rate
    assert np.isfinite(wav).all() and wav.size > 0.3 * sr, wav.size
    rms, low = _speech_like(wav, sr)
    assert rms > 0.01 and low > 0.90, (rms, low)


def test_speaker_similarity_trained(engine):
    """A line rendered in speaker A's timbre (and style) scores closer to A
    than to speaker B."""
    by_spk = {}
    for r in ALL_ROWS:
        by_spk.setdefault(r["speaker"], r)
    a, b = list(by_spk.values())[:2]
    wav_a, wav_b = _src(engine, a), _src(engine, b)
    wav = next(engine.inference_tts_with_st(ALL_ROWS[-1]["text"], a["text"], wav_a, wav_a))["tts_speech"]
    au = engine.cfg.audio
    wav16 = resample_poly_np(np.asarray(wav).ravel(), au.sample_rate, au.prompt_sample_rate)
    scorer = SpeakerScorer(engine)
    sim_a = scorer.similarity([wav16], [wav_a])[0]
    sim_b = scorer.similarity([wav16], [wav_b])[0]
    assert sim_a > sim_b, (sim_a, sim_b)


def test_trained_istft_vocoder_resynthesis():
    """The trained iSTFT vocoder resynthesizes the six held-out rows (24 kHz,
    256 frames each) below mel-L1 0.40 (JAX: 0.358); the JAX vocoder on
    the same mels gives the same error within 1e-3."""
    demo = demo_config()
    a = demo.audio
    vcfg = dataclasses.replace(demo.vocoder, kind="istft", istft_channels=256, istft_blocks=6)
    like = vocoder.init_params(vcfg, torch.Generator().manual_seed(0))
    params = load_tree(ISTFT, like)
    FB = 256
    wavs = np.zeros((len(ALL_ROWS), FB * a.hop_length), np.float32)
    masks = np.zeros((len(ALL_ROWS), FB), np.float32)
    for i, r in enumerate(ALL_ROWS):
        w16, sr = read_wav(SAMPLE / r["wav"])
        w = resample_poly_np(w16, sr, a.sample_rate)
        F = min(len(w) // a.hop_length, FB)
        wavs[i, : F * a.hop_length] = w[: F * a.hop_length]
        masks[i, :F] = 1

    def mel_of(x):
        return stft.log_mel_spectrogram(x, a.sample_rate, a.n_fft, a.hop_length, a.win_length,
                                        n_mels=a.n_mels, fmax=a.fmax)

    def l1(pred_mel, mels):
        return float((np.abs(pred_mel[:, :FB] - mels) * masks[:, :, None]).sum() / (masks.sum() * a.n_mels))

    mels = mel_of(torch.from_numpy(wavs))[:, :FB]
    pred = vocoder.apply(params, vcfg, mels)
    err = l1(mel_of(pred[:, : FB * a.hop_length]).numpy(), mels.numpy())
    assert err < 0.40, err
    jp = load_pytree(ISTFT, jvocoder.init_params(jax.random.PRNGKey(0), dataclasses.replace(
        jconfig.demo_config().vocoder, kind="istft", istft_channels=256, istft_blocks=6)))
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), jp)
    jpred = jvocoder.apply(jp, dataclasses.replace(jconfig.demo_config().vocoder, kind="istft",
                                                   istft_channels=256, istft_blocks=6), jnp.asarray(mels.numpy()))
    jmel = np.asarray(jstft.log_mel_spectrogram(jpred[:, : FB * a.hop_length], a.sample_rate, a.n_fft,
                                                a.hop_length, a.win_length, n_mels=a.n_mels, fmax=a.fmax))
    assert abs(err - l1(jmel, mels.numpy())) < 1e-3, (err, l1(jmel, mels.numpy()))


def test_load_tree_names_missing_extra_and_misshapen_keys(tmp_path):
    like = {"a": torch.zeros(2, 3), "b": [torch.zeros(4), QTensor(q=torch.zeros(2, 2, dtype=torch.int8),
                                                              s=torch.ones(1, 2))]}
    np.savez(tmp_path / "ok.npz", **{"a": np.ones((2, 3), np.float16), "b/0": np.arange(4, dtype=np.float32),
                                     "b/1/q": np.ones((2, 2), np.int8), "b/1/s": np.ones((1, 2), np.float32)})
    got = load_tree(tmp_path / "ok.npz", like)
    assert got["a"].dtype == torch.float32 and float(got["a"].sum()) == 6.0
    assert torch.equal(got["b"][0], torch.arange(4.0)) and got["b"][1].q.dtype == torch.int8
    np.savez(tmp_path / "bad.npz", **{"a": np.ones((2, 3)), "b/0": np.ones(4), "b/1/q": np.ones((2, 2)),
                                      "c": np.ones(1)})
    with pytest.raises(ValueError, match=r"missing keys \['b/1/s'\], extra keys \['c'\]"):
        load_tree(tmp_path / "bad.npz", like)
    np.savez(tmp_path / "shape.npz", **{"a": np.ones((3, 2)), "b/0": np.ones(4), "b/1/q": np.ones((2, 2)),
                                        "b/1/s": np.ones((1, 2))})
    with pytest.raises(ValueError, match="a has shape"):
        load_tree(tmp_path / "shape.npz", like)


def test_distilled_cfm_few_step_tracks_teacher(engine, jax_params):
    """rows[-1]'s own tokens, speaker and mel (its first quarter as the
    prompt) through the teacher's 10-step CFG solve, the distilled 2-step
    guidance-free student and the teacher at 2 steps, all from the same
    noise (JAX ``PRNGKey(4)``)."""
    feats = engine.prompt_features([_src(engine, ALL_ROWS[-1])])[0]
    c = engine.cfg.cfm
    up = c.upsample
    F = len(feats.tokens) * up
    gt = np.zeros((1, F, c.n_mels), np.float32)
    nm = min(feats.mel24.shape[0], F)
    gt[0, :nm] = feats.mel24[:nm]
    pmask = (np.arange(F)[None, :] < F // 4).astype(np.float32)
    fmask = np.ones((1, F), np.float32)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(4), (1, F, c.n_mels), jnp.float32))
    scfg = dataclasses.replace(c, n_steps=2, use_cfg=False)
    w = (fmask * (1 - pmask))[..., None]

    def l1(x, y):
        return float((w * np.abs(x - y)).sum() / (w.sum() * c.n_mels))

    teacher = engine.params.cfm
    student = load_tree(DISTILLED, teacher)
    tokens = torch.from_numpy(feats.tokens.astype(np.int64))[None]
    spk = torch.from_numpy(feats.spk)[None]

    def mel(params, cc, use_cfg):
        cond = cfm.upsample_tokens(params, tokens, up, c.token_vocab_size)
        return cfm.sample_mel(params, cc, None, cond, spk, torch.from_numpy(gt * pmask[..., None]),
                              torch.from_numpy(pmask), torch.from_numpy(fmask), use_cfg=use_cfg,
                              noise=torch.from_numpy(noise)).numpy()

    m_teacher, m_student, m_fast = mel(teacher, c, True), mel(student, scfg, False), mel(teacher, scfg, False)
    got = dict(d_student=l1(m_student, m_teacher), d_fast=l1(m_fast, m_teacher),
               g_teacher=l1(m_teacher, gt), g_student=l1(m_student, gt))
    assert got["d_student"] < 0.6 * got["d_fast"], got
    assert got["g_student"] < got["g_teacher"] + 0.10, got

    jteacher = jax_params.cfm
    jstudent = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), load_pytree(DISTILLED, jteacher))
    jc = jconfig.demo_config().cfm
    jtok, jspk = jnp.asarray(feats.tokens, jnp.int32)[None], jnp.asarray(feats.spk)[None]

    def jmel(params, cc, use_cfg):
        cond = jcfm.upsample_tokens(params, jtok, up)
        return np.asarray(jcfm.sample_mel(params, cc, jax.random.PRNGKey(4), cond, jspk,
                                          jnp.asarray(gt * pmask[..., None]), jnp.asarray(pmask),
                                          jnp.asarray(fmask), use_cfg=use_cfg))

    jscfg = dataclasses.replace(jc, n_steps=2, use_cfg=False)
    jt, js, jf = jmel(jteacher, jc, True), jmel(jstudent, jscfg, False), jmel(jteacher, jscfg, False)
    want = dict(d_student=l1(js, jt), d_fast=l1(jf, jt), g_teacher=l1(jt, gt), g_student=l1(js, gt))
    for k in got:
        assert abs(got[k] - want[k]) < 1e-3, (k, got, want)
