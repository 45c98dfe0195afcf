"""The plain reference against the port at a tiny configuration on the CPU:
module by module on the same weights and inputs, and through whole runs of
the harness (every compared number small)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.programs import tts_weights as weights
from portbench.reference import tts
from portbench.tests.tiny import TinyCell, tiny_cfg
from portbench.traffic.generator import Traffic, synthetic_wav


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine():
    from autostyle_tts_tpu_torch.pipeline.engine import Engine, EngineParams
    from portbench.programs.tts import port_config

    cfg = tiny_cfg()
    tree = weights.draw(cfg, 11, "cpu")
    return cfg, tree, Engine(port_config(cfg), params=EngineParams(**tree), seed=3, device="cpu")


def test_text_ids_match_the_port():
    from autostyle_tts_tpu_torch.models import frontend

    t = Traffic({"words_per_second": 2.5}, 5)
    rng = t.rng(0)
    for n in (3, 13, 51):
        text = t.text(rng, n, 340)
        want = frontend.encode(text, numbers=True).tolist()
        assert tts.encode_text(text) == want


def test_int_rounding_matches_the_port():
    from autostyle_tts_tpu_torch.models.token_lm import requantize4
    from autostyle_tts_tpu_torch.weights import quantize

    w = torch.randn(3, 64, 48, generator=torch.Generator().manual_seed(1))
    q = quantize(w)
    assert torch.equal(tts.int_round(w, 127), q.q.float() * q.s)
    q4, s4 = requantize4(q.q.transpose(-1, -2), q.s.squeeze(-2))
    assert torch.equal(tts.int_round(q.q.float() * q.s, 7), (q4.float() * s4[..., None]).transpose(-1, -2))


def test_featurize_matches_the_port(engine):
    cfg, tree, eng = engine
    sr = cfg["audio"]["prompt_sample_rate"]
    rng = np.random.default_rng(4)
    wavs = [synthetic_wav(rng, s, sr) for s in (0.7, 1.6)]
    feats = eng.prompt_features(wavs)
    padded = tts.prompt_padded_len([len(w) for w in wavs], sr)
    for w, f in zip(wavs, feats):
        ref = tts.featurize(tree, cfg, tts.Numerics(), w, padded, "cpu")
        assert ref["scores"].argmax(-1).tolist() == f.tokens.tolist()
        assert float((ref["spk"] - torch.tensor(f.spk)).abs().max()) < 1e-4
        assert float((ref["mel24"] - torch.tensor(f.mel24)).abs().max()) < 1e-3


def test_wav_and_tokens_match_the_port(engine):
    cfg, tree, eng = engine
    from portbench.programs.tts import Taps, served_tokens

    sr = cfg["audio"]["prompt_sample_rate"]
    rng = np.random.default_rng(8)
    sty, tim = eng.prompt_features([synthetic_wav(rng, 1.2, sr), synthetic_wav(rng, 0.9, sr)])
    up, M = cfg["cfm"]["upsample"], cfg["cfm"]["n_mels"]
    fp_w = tts.bucket(len(tim.tokens), tts.TOKEN_BUCKETS)
    noise = rng.standard_normal((1, (fp_w + 64) * up, M)).astype(np.float32)
    taps = Taps(eng)
    taps.on = True
    try:
        wav = next(eng.inference_tts_with_st("Quiet river song.", "Morning light.", sty, tim,
                                             max_seconds=64 / 25, cfm_noise=noise))["tts_speech"][0]
    finally:
        taps.remove()
    eos = cfg["token_lm"]["speech_vocab_size"] - 2
    served = served_tokens(taps.gens[0], 0, eos)
    gen = served[:-1] if served[-1] == eos else served
    ref = tts.served_wav(tree, cfg, tts.Numerics(), tim.tokens, tim.mel24, torch.tensor(tim.spk), gen,
                         torch.tensor(noise[0]), fp_w, 64)
    assert ref.shape[0] == wav.shape[0]
    assert float(torch.linalg.norm(ref - torch.tensor(wav)) / torch.linalg.norm(ref)) < 1e-4
    num = tts.Numerics()
    lm, lcfg = tree["token_lm"], cfg["token_lm"]
    prefix = tts.lm_prefix(lm, lcfg, tts.encode_text("Morning light. Quiet river song."), sty.tokens,
                           torch.tensor(tim.spk))
    logits = tts.mask_logits(tts.lm_logits(lm, lcfg, tts.LMWeights(lm, num, 8), num, prefix, served, True), lcfg, 2)
    assert tts.topk_gap(logits, served, 25) < 0.1


@pytest.mark.parametrize("traffic", ["b1-db", "b1-wav", "batch8"])
def test_harness_numbers_are_small(traffic):
    from portbench.bench.harness import run_cell

    res = run_cell(TinyCell(traffic), 2 ** 31 + 9, 2.0, False, 0.0, device="cpu")
    nums = res["_nums"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert nums["lm_gap"] < 0.1 and nums["wav_rel_err"] < 1e-4
    assert nums["tok_mismatch"] == 0.0 and nums["spk_err"] < 1e-4 and nums["mel_err"] < 1e-3
    if traffic != "b1-wav":
        assert nums["search_err"] < 1e-5
