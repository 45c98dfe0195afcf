"""Port parity for the batched and non-int8 serving slice, on the CPU,
against the JAX package on the same numpy-seeded inputs.

Tolerances:
- ``conv_transpose1d`` and the HiFi-GAN ``apply``: atol 1e-5 (f32 on both
  sides, only summation order differs);
- ``quantize_kv``: int8 values equal, scales to 1e-7 relative;
- ``sdpa`` / ``sdpa_quant``: atol 1e-5 (f32);
- the scanned ``generate_speech``, greedy: tokens and lengths equal over 24
  steps for all eight combinations of dense / int8 weights, bf16 / int8 KV
  cache and H = K / GQA. The reference is the JAX scanned decode on its
  flash-prefill route (``flash_ok`` forced on, the Pallas kernel in
  interpret mode), the route it takes on its accelerator and the one the
  port always takes: on a CPU backend the reference's prefill would
  otherwise attend the int8-quantized prefix keys when ``kv_int8`` is on.
  The two sides' logits differ by up to ~5e-2 (on logits of std ~1): XLA:CPU
  rounds bf16 elementwise work inside a fused program other than op by op
  (its bf16 ``silu`` alone is 1/(1+exp(-x)) with every operation rounded to
  bf16, and fusion drops some of those roundings); the reference's own
  jitted and eager prefills differ by ~1e-2. So on random weights a greedy
  run can part from the reference wherever two logits lie that close, and
  each case names its weight seed: ``LM_SEED`` (0), on which seven of the
  eight agree over 24 steps, and seed 2 for dense weights with a bf16 cache
  and GQA, which part from the reference at step 7 on seed 0 (a top-2
  margin below the two sides' difference). That gap is bounded apart:
  both decodes fed the same 24 random tokens a row, on ``LM_SEED`` for all
  eight combinations, every f32 logit the samplers see (prefill and steps,
  logits of std ~1) within 8e-2 of the reference's and 1.2e-2 on average
  (measured: largest 3.9e-2 to 5.4e-2, mean 7.2e-3 to 7.9e-3, about one
  bf16 ulp; flat over the steps, from the prefill's on: no drift through
  the cache);
- top-p masks equal;
- ``synthesize_batch`` and ``inference_vc``: wavs atol 1e-4, with both LMs
  greedy, the generation bucket pinned to 32 tokens (an untrained LM's
  near-tied logits let two correct implementations part after some tens
  of greedy steps) and the port handed the CFM noise the JAX engine draws.
"""

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import io_callback

import autostyle_tts_tpu.models.token_lm as jlm
import autostyle_tts_tpu.models.transformer as jtransformer
import autostyle_tts_tpu_torch.models.token_lm as tlm
from autostyle_tts_tpu.models import vocoder as jvoc
from autostyle_tts_tpu.ops import attention as jatt
from autostyle_tts_tpu.ops import conv as jconv
from autostyle_tts_tpu.ops.quant import quantize_tree as jquantize_tree
from autostyle_tts_tpu.ops.sampling import SamplerConfig as JSampler
from autostyle_tts_tpu.ops.sampling import transform_logits as jtransform
from autostyle_tts_tpu.pipeline import engine as jengine
from autostyle_tts_tpu.utils import config as jconfig
from autostyle_tts_tpu_torch.models import vocoder as tvoc
from autostyle_tts_tpu_torch.ops import attention as tatt
from autostyle_tts_tpu_torch.ops import conv as tconv
from autostyle_tts_tpu_torch.ops.sampling import SamplerConfig, transform_logits
from autostyle_tts_tpu_torch.pipeline import engine as tengine
from autostyle_tts_tpu_torch.utils import config as tconfig
from autostyle_tts_tpu_torch.weights import from_jax_tree, tree_from_numpy

SEED = 5
LM_SEED = 0      # the scanned-decode weights and inputs (see the module docstring)
LOGIT_ATOL, LOGIT_MEAN_ATOL = 8e-2, 1.2e-2    # teacher-forced logits (see the module docstring)


def _t(x):
    return torch.from_numpy(np.array(x))


# ----------------------------------------------------------------------- vocoder


@pytest.mark.parametrize("kernel,stride", [(10, 5), (8, 4), (6, 3), (4, 2)])
def test_conv_transpose1d_matches_jax(kernel, stride):
    rng = np.random.default_rng(kernel)
    x = rng.standard_normal((2, 13, 6)).astype(np.float32)
    p = jax.tree_util.tree_map(np.asarray, jconv.conv_transpose1d_init(jax.random.PRNGKey(kernel), 6, 4, kernel))
    want = np.asarray(jconv.conv_transpose1d(jnp.asarray(x), p, stride=stride, kernel=kernel))
    got = tconv.conv_transpose1d(_t(x), tree_from_numpy(p), stride=stride, kernel=kernel).numpy()
    assert got.shape == want.shape == (2, 13 * stride, 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_hifigan_apply_matches_jax():
    vcfg = jconfig.tiny_config().vocoder
    jp = jax.tree_util.tree_map(np.asarray, jvoc.init_params(jax.random.PRNGKey(SEED), vcfg))
    mel = np.random.default_rng(SEED).standard_normal((2, 11, vcfg.n_mels)).astype(np.float32)
    want = np.asarray(jvoc.apply(jp, vcfg, jnp.asarray(mel)))
    got = tvoc.apply(tree_from_numpy(jp), vcfg, _t(mel)).numpy()
    assert got.shape == want.shape == (2, 11 * jvoc.total_upsample(vcfg))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ----------------------------------------------------------------------- attention


def test_quantize_kv_matches_jax_exactly():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 2, 16)).astype(np.float32) * 3
    x[0, 3] = 0.0                                  # all-zero rows: the 1e-8 scale floor
    x[1, 2, 0, :4] = [127.0, -127.0, 63.5, 0.5]    # exact halves: round half to even
    x = jnp.asarray(x, jnp.bfloat16)
    wq, ws = jatt.quantize_kv(x)
    gq, gs = tatt.quantize_kv(_t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16))
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-7, atol=0)


def _attn_inputs(T, S, H=4, K=2, hd=16, B=2):
    rng = np.random.default_rng(T)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    lens = np.asarray([S - 3, 0])                  # row 1: every key masked
    m = (np.arange(S)[None, :] < lens[:, None])[:, None, None, :]
    m = np.broadcast_to(m & np.tril(np.ones((T, S), bool), S - T)[None, None], (B, 1, T, S))
    return q, k, v, np.ascontiguousarray(m)


@pytest.mark.parametrize("T", [1, 5])
def test_sdpa_matches_jax(T):
    q, k, v, m = _attn_inputs(T, 12)
    want = np.asarray(jatt.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m)))
    got = tatt.sdpa(_t(q), _t(k), _t(v), _t(m)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("T", [1, 5])
def test_sdpa_quant_matches_jax(T):
    q, k, v, m = _attn_inputs(T, 12)
    kq, ks = jatt.quantize_kv(jnp.asarray(k))
    vq, vs = jatt.quantize_kv(jnp.asarray(v))
    want = np.asarray(jatt.sdpa_quant(jnp.asarray(q), kq, ks, vq, vs, jnp.asarray(m)))
    got = tatt.sdpa_quant(_t(q), _t(kq), _t(ks), _t(vq), _t(vs), _t(m)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.isfinite(got).all()
    lens = jnp.asarray([7, 12])
    np.testing.assert_array_equal(tatt.padding_mask(_t(np.asarray(lens)), 12).numpy(),
                                  np.asarray(jatt.padding_mask(lens, 12)))


# ----------------------------------------------------------------------- scanned decode


def _lm(quant: bool, kv_heads: int, seed: int = LM_SEED):
    cfg = dataclasses.replace(jconfig.tiny_config().token_lm, n_kv_heads=kv_heads)
    jp = jlm.init_params(jax.random.PRNGKey(seed), cfg)
    if quant:
        jp = jquantize_tree(jp)
    return cfg, jp, tree_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def _lm_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    text = rng.integers(16, 200, (2, 12)).astype(np.int32)
    sty = rng.integers(0, 64, (2, 8)).astype(np.int32)
    spk = rng.standard_normal((2, cfg.spk_dim)).astype(np.float32)
    return text, np.asarray([12, 7], np.int32), sty, np.asarray([8, 3], np.int32), spk


@pytest.mark.parametrize("quant,kv_int8,kv_heads,seed", [
    (False, False, 4, LM_SEED), (False, False, 2, 2), (False, True, 4, LM_SEED),
    (False, True, 2, LM_SEED), (True, False, 4, LM_SEED), (True, False, 2, LM_SEED),
    (True, True, 4, LM_SEED), (True, True, 2, LM_SEED),
])
def test_scanned_generate_greedy_matches_jax(monkeypatch, quant, kv_int8, kv_heads, seed):
    """B=2 rows of different prefix lengths through the scanned decode:
    dense or int8 weights, a bf16 or int8 KV cache, H = K or GQA."""
    cfg, jp, tp = _lm(quant, kv_heads, seed)
    inputs = _lm_inputs(cfg, seed)
    # traces made with flash_ok forced on must not outlive this test
    traced = (jlm.generate_speech_from_ids, jlm.generate_speech)
    monkeypatch.setattr(jtransformer, "flash_ok", lambda t, hd: True)
    for fn in traced:
        fn.clear_cache()
    try:
        want = jlm.generate_speech_from_ids(
            jp, cfg, *map(jnp.asarray, inputs), jax.random.PRNGKey(0),
            max_new_tokens=24, sampler=JSampler(greedy=True), kv_int8=kv_int8, fused=False)
        want_tokens, want_lens = np.asarray(want.tokens), np.asarray(want.lengths)
    finally:
        for fn in traced:
            fn.clear_cache()
    got = tlm.generate_speech_from_ids(
        tp, dataclasses.replace(tconfig.tiny_config().token_lm, n_kv_heads=kv_heads),
        *map(_t, inputs), None, max_new_tokens=24,
        sampler=SamplerConfig(greedy=True), kv_int8=kv_int8)
    np.testing.assert_array_equal(got.tokens.numpy(), want_tokens)
    np.testing.assert_array_equal(got.lengths.numpy(), want_lens)
    assert got.decode_steps <= 24


@pytest.mark.parametrize("quant,kv_int8,kv_heads", list(itertools.product((False, True), (False, True), (4, 2))))
def test_scanned_step_logits_match_jax_teacher_forced(monkeypatch, quant, kv_int8, kv_heads):
    """Both scanned decodes fed the same 24 tokens a row (drawn at random,
    not their own picks): the f32 logits each sampler is handed (the
    prefill's, then every step's, BOS / pad / early EOS masked) against the
    reference's, on one weight seed for all eight combinations."""
    cfg, jp, tp = _lm(quant, kv_heads)
    inputs = _lm_inputs(cfg, LM_SEED)
    forced = np.random.default_rng(7).integers(0, cfg.speech_bos, (24, 2)).astype(np.int32)
    seen_j, seen_t = [], []

    def host_pick(logits):
        seen_j.append(np.asarray(logits))
        return forced[len(seen_j) - 1]

    def jax_pick(key, logits, sampler):
        return io_callback(host_pick, jax.ShapeDtypeStruct((2,), jnp.int32), logits, ordered=True)

    def torch_pick(logits, sampler, generator):
        seen_t.append(logits.numpy().copy())
        return torch.from_numpy(forced[len(seen_t) - 1])

    traced = (jlm.generate_speech_from_ids, jlm.generate_speech)
    monkeypatch.setattr(jtransformer, "flash_ok", lambda t, hd: True)
    monkeypatch.setattr(jlm, "sample", jax_pick)
    for fn in traced:
        fn.clear_cache()
    try:
        jlm.generate_speech_from_ids(jp, cfg, *map(jnp.asarray, inputs), jax.random.PRNGKey(0),
                                     max_new_tokens=24, kv_int8=kv_int8, fused=False)
    finally:
        for fn in traced:
            fn.clear_cache()
    monkeypatch.setattr(tlm, "sample", torch_pick)
    tlm.generate_speech_from_ids(tp, dataclasses.replace(tconfig.tiny_config().token_lm, n_kv_heads=kv_heads),
                                 *map(_t, inputs), None, max_new_tokens=24, kv_int8=kv_int8)
    assert len(seen_j) == len(seen_t) == 24
    got, want = np.stack(seen_t), np.stack(seen_j)
    masked = want <= -1e29
    np.testing.assert_array_equal(got <= -1e29, masked)
    gap = np.abs(got - want)[~masked]
    assert float(gap.max()) < LOGIT_ATOL and float(gap.mean()) < LOGIT_MEAN_ATOL, (gap.max(), gap.mean())


def test_scanned_generate_stops_when_every_row_is_done(monkeypatch):
    """EOS is masked while i < min_tokens; a row that emitted EOS emits pad
    after it; ``lengths`` counts the tokens before EOS; the loop ends once
    every row is done. Row 0 is scripted to emit EOS at step 3, row 1 at
    step 5."""
    cfg = tconfig.tiny_config().token_lm
    _, _, tp = _lm(False, 4)
    eos_at = {0: 3, 1: 5}
    seen = []

    def scripted(logits, sampler, generator):
        i = len(seen)
        seen.append(bool((logits[:, cfg.speech_eos] <= -1e29).all()))
        return torch.tensor([cfg.speech_eos if i >= eos_at[r] else 7 for r in range(2)],
                            dtype=torch.int32)

    monkeypatch.setattr(tlm, "sample", scripted)
    out = tlm.generate_speech_from_ids(
        tp, cfg, torch.full((2, 6), 20, dtype=torch.int32), torch.tensor([6, 4]),
        torch.zeros((2, 4), dtype=torch.int32), torch.tensor([4, 2]), torch.zeros((2, cfg.spk_dim)),
        None, max_new_tokens=16, min_tokens=2)
    assert seen[:3] == [True, True, False] and len(seen) == 6
    assert out.lengths.tolist() == [3, 5] and out.decode_steps == 5
    toks = out.tokens.tolist()
    assert toks[0][:4] == [7, 7, 7, cfg.speech_eos] and set(toks[0][4:]) == {cfg.speech_pad}
    assert toks[1][:6] == [7] * 5 + [cfg.speech_eos] and set(toks[1][6:]) == {cfg.speech_pad}


@pytest.mark.parametrize("top_p,cap", [(0.9, 256), (0.5, 256), (0.999, 256), (0.8, 0)])
def test_top_p_masks_match_jax(top_p, cap):
    """On a 515-token vocabulary (the demo LM's), where the reference sorts
    only its top ``cap`` logits unless the nucleus is wider (0.999 here)."""
    logits = np.random.default_rng(int(top_p * 1000)).standard_normal((3, 515)).astype(np.float32) * 2
    want = np.asarray(jtransform(jnp.asarray(logits), JSampler(top_p=top_p, top_p_cap=cap)))
    got = transform_logits(_t(logits), SamplerConfig(top_p=top_p)).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    assert 1 <= int((want > -1e29).sum(-1).min())


# ----------------------------------------------------------------------- engine


def _engine_cfg(mod):
    cfg = mod.tiny_config()
    cfg.fetch_dtype = "float32"
    return cfg


def _engines(monkeypatch):
    jcfg, tcfg = _engine_cfg(jconfig), _engine_cfg(tconfig)
    tree = jax.tree_util.tree_map(np.asarray, jengine.EngineParams.init(jax.random.PRNGKey(0), jcfg).tree())
    rng = np.random.default_rng(0)
    c = tree["cfm"]     # fill the zero-initialized modulation and output projection
    c["layers"]["mod"] = (rng.standard_normal(c["layers"]["mod"].shape) * 0.05).astype(np.float32)
    c["out_proj"] = (rng.standard_normal(c["out_proj"].shape) * 0.1).astype(np.float32)
    monkeypatch.setattr(jlm, "generate_speech_from_ids", functools.partial(
        jlm.generate_speech_from_ids, sampler=JSampler(greedy=True)))
    monkeypatch.setattr(tlm, "generate_speech_from_ids", functools.partial(
        tlm.generate_speech_from_ids, sampler=SamplerConfig(greedy=True)))
    monkeypatch.setattr(jengine, "GEN_BUCKETS", (32,))
    monkeypatch.setattr(tengine, "GEN_BUCKETS", (32,))
    jeng = jengine.Engine(jcfg, params=jengine.EngineParams.from_tree(
        jax.tree_util.tree_map(jnp.asarray, tree)), seed=SEED)
    teng = tengine.Engine(tcfg, params=tengine.EngineParams.from_tree(from_jax_tree(tree, tcfg)),
                          seed=SEED, device="cpu")
    return jcfg, jeng, teng


def _wav(seed, seconds, sr=1600):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * rng.uniform(80, 600) * t) + 0.02 * rng.standard_normal(t.shape)
    return x.astype(np.float32)


def _staged_noise(cfg, n_splits, B, fp_w, max_new):
    """The CFM noise of the JAX engine's staged path: the engine key is
    split once per stage (the LM stage, then the CFM)."""
    key = jax.random.PRNGKey(SEED + 17)
    for _ in range(n_splits):
        key, sub = jax.random.split(key)
    shape = (B, (fp_w + max_new) * cfg.cfm.upsample, cfg.cfm.n_mels)
    return np.asarray(jax.random.normal(sub, shape, jnp.float32))


def test_synthesize_batch_matches_jax_engine(monkeypatch):
    """B=3, dense LM (tiny_config), HiFi-GAN: prompts from wavs (one wav
    object in two rows, featurized once), rows of different text and style
    lengths through the scanned decode, the staged CFM and vocoder."""
    jcfg, jeng, teng = _engines(monkeypatch)
    w0, w1, w2 = _wav(1, 1.2), _wav(2, 0.7), _wav(3, 1.5)
    texts = ["Hello there.", "A much longer line of text to speak here.", "Short"]
    stexts = ["style one", "", "third style line"]
    sty, tim = [w0, w1, w0], [w2, w2, w1]
    want = jeng.synthesize_batch(texts, stexts, sty, tim, max_seconds=1.0)
    feats = teng.prompt_features([w0, w1, w2])
    fp_w = tengine._bucket(max(len(feats[i].tokens) for i in (2, 2, 1)), tengine.TOKEN_BUCKETS)
    noise = _staged_noise(jcfg, 2, 3, fp_w, 32)
    got = teng.synthesize_batch(texts, stexts, sty, tim, max_seconds=1.0, cfm_noise=noise)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape and g.size > 0
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    assert set(teng.last_timings) == {"featurize", "prefill", "decode", "cfm", "vocoder"}
    assert teng.last_gen_lens == [len(w) // (jcfg.cfm.upsample * jcfg.audio.hop_length) for w in want]


def test_inference_vc_matches_jax_engine(monkeypatch):
    """Voice conversion through the staged path (no LM): the source's speech
    tokens re-rendered with the prompt's identity."""
    jcfg, jeng, teng = _engines(monkeypatch)
    src, prm = _wav(4, 1.3), _wav(5, 0.9)
    want = next(jeng.inference_vc(src, prm))["tts_speech"]
    fs, fp = teng.prompt_features([src, prm])
    fp_w = tengine._bucket(len(fp.tokens), tengine.TOKEN_BUCKETS)
    max_new = tengine._bucket(len(fs.tokens), tengine.GEN_BUCKETS)
    noise = _staged_noise(jcfg, 1, 1, fp_w, max_new)
    got = next(teng.inference_vc(src, prm, cfm_noise=noise))["tts_speech"]
    assert got.shape == want.shape == (1, len(fs.tokens) * jcfg.cfm.upsample * jcfg.audio.hop_length)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert set(teng.last_timings) == {"featurize", "cfm", "vocoder"} and teng.last_decode_steps == 0
    tok = teng.synthesize_from_tokens([{"tokens": fs.tokens, "flow_feat": fp}], cfm_noise=noise)
    np.testing.assert_allclose(tok[0][None], want, atol=1e-4, rtol=0)
