"""The port's prompt-lookup speculative decoding against the JAX package's
(``tests/test_spec_decode.py``), on the CPU, on weights carried across
from ``jax.random.PRNGKey(0)`` at ``tiny_config()``.

Tolerances:
- the port's greedy speculative tokens equal its own standard greedy decode
  exactly, in every case (tokens, lengths, pad after EOS);
- against the JAX function, greedy tokens, ``n_verify`` and ``n_commit``
  equal, but where the two packages round a top-2 near-tie differently:
  the token LM computes in bf16, and the two sides' logits differ by about
  one bf16 ulp (mean 7.2e-3 to 7.9e-3, ``tests/test_torch_batch.py``). The
  tokens may part only at a step where the port's standard greedy decode
  has its top-2 masked logits within ``NEAR_TIE`` (1.2e-2, that file's
  mean bound); from there the contexts differ and nothing later is
  compared. Of the five cases only ``(2, 6, 16)`` parts, at step 8, on a
  gap of 3.2e-3 (its ``n_verify`` and ``n_commit`` still agree);
- ``_lookup_draft`` equal to the JAX function's on every context;
- the sampled path's joint law of the first two tokens within total
  variation 0.15 of the standard sampled path's over 1200 runs each, the
  JAX file's bound.
"""

import dataclasses
import json
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autostyle_tts_tpu.models import token_lm as jlm
from autostyle_tts_tpu.utils.config import tiny_config as jtiny_config
from autostyle_tts_tpu_torch.models import frontend
from autostyle_tts_tpu_torch.models import token_lm as tlm
from autostyle_tts_tpu_torch.ops.sampling import SamplerConfig
from autostyle_tts_tpu_torch.pipeline import engine as tengine
from autostyle_tts_tpu_torch.utils.audio_io import read_wav
from autostyle_tts_tpu_torch.utils.config import demo_config, tiny_config
from autostyle_tts_tpu_torch.weights import from_jax_tree, load_npz, tree_from_numpy
from torch_one_thread import one_thread  # noqa: F401  (autouse)

FIXTURES = Path(__file__).parent / "fixtures"
NEAR_TIE = 1.2e-2
GREEDY = SamplerConfig(greedy=True)


@pytest.fixture(scope="module")
def lm():
    cfg = jtiny_config().token_lm
    jp = jlm.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jp, tree_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def _prompt(seed, cfg, t_w=8, s_w=12):
    rng = np.random.default_rng(seed)
    text = rng.integers(1, cfg.text_vocab_size, (1, t_w)).astype(np.int32)
    t_len = np.asarray([rng.integers(3, t_w + 1)], np.int32)
    sty = rng.integers(0, cfg.speech_vocab_size - 3, (1, s_w)).astype(np.int32)
    s_len = np.asarray([rng.integers(4, s_w + 1)], np.int32)
    spk = rng.standard_normal((1, cfg.spk_dim)).astype(np.float32) * 0.2
    return text, t_len, sty, s_len, spk


def _t(xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _greedy_with_gaps(params, cfg, inputs, max_new, **kw):
    """The port's standard greedy decode and, at each step, the top-2 gap
    of the masked logits it took its token from."""
    gaps = []
    orig = tlm.sample

    def record(logits, sampler, generator=None):
        top = torch.topk(logits[0].float(), 2).values
        gaps.append(float(top[0] - top[1]))
        return orig(logits, sampler, generator)

    tlm.sample = record
    try:
        ref = tlm.generate_speech_from_ids(params, cfg, *_t(inputs), None, max_new_tokens=max_new,
                                           sampler=GREEDY, **kw)
    finally:
        tlm.sample = orig
    return ref, gaps


def _first_difference(a, b):
    d = [i for i in range(min(len(a), len(b))) if a[i] != b[i]]
    return d[0] if d else None


def _assert_port_equals_standard(spec, ref):
    np.testing.assert_array_equal(spec.tokens.numpy(), ref.tokens.numpy())
    assert int(spec.lengths[0]) == int(ref.lengths[0]) == spec.n_commit
    # every verify commits at least one token
    assert spec.n_verify <= max(spec.n_commit, 1)


@pytest.mark.parametrize("seed,gamma,max_new", [
    (0, 4, 24), (1, 2, 24), (2, 6, 16), (3, 4, 8), (4, 3, 32),
])
def test_spec_matches_jax_and_standard_greedy(lm, seed, gamma, max_new):
    cfg, jp, tp = lm
    inputs = _prompt(seed, cfg)
    want = jlm.generate_speech_spec_from_ids(jp, cfg, *map(jnp.asarray, inputs), max_new_tokens=max_new,
                                             gamma=gamma, pad_multiple=16)
    got = tlm.generate_speech_spec_from_ids(tp, cfg, *_t(inputs), max_new_tokens=max_new, gamma=gamma,
                                            pad_multiple=16)
    ref, gaps = _greedy_with_gaps(tp, cfg, inputs, max_new, pad_multiple=16)
    _assert_port_equals_standard(got, ref)
    want_tokens = np.asarray(want.tokens)[0].tolist()
    i = _first_difference(got.tokens[0].tolist(), want_tokens)
    if i is None:
        assert (got.n_verify, got.n_commit) == (int(want.n_verify), int(want.n_commit))
        assert int(got.lengths[0]) == int(want.lengths[0])
    else:
        assert gaps[i] < NEAR_TIE, (seed, i, gaps[i], got.tokens[0].tolist(), want_tokens)


def test_spec_matches_greedy_kv_int8(lm):
    cfg, _, tp = lm
    inputs = _prompt(7, cfg)
    ref = tlm.generate_speech_from_ids(tp, cfg, *_t(inputs), None, max_new_tokens=24, sampler=GREEDY,
                                       kv_int8=True, pad_multiple=16)
    spec = tlm.generate_speech_spec_from_ids(tp, cfg, *_t(inputs), max_new_tokens=24, gamma=4, kv_int8=True,
                                             pad_multiple=16)
    _assert_port_equals_standard(spec, ref)


@pytest.mark.parametrize("max_new", [3, 5])
def test_spec_respects_max_new_cap(lm, max_new):
    """A verify window straddling the budget clamps exactly at max_new."""
    cfg, _, tp = lm
    inputs = _prompt(11, cfg)
    ref = tlm.generate_speech_from_ids(tp, cfg, *_t(inputs), None, max_new_tokens=max_new, sampler=GREEDY,
                                       pad_multiple=16)
    spec = tlm.generate_speech_spec_from_ids(tp, cfg, *_t(inputs), max_new_tokens=max_new, gamma=4,
                                             pad_multiple=16)
    _assert_port_equals_standard(spec, ref)
    assert spec.tokens.shape == (1, max_new)


def test_spec_empty_style_context(lm):
    """Zero style tokens: the lookup context starts empty, drafting falls
    back to repeating, and the tokens are still the greedy ones."""
    cfg, _, tp = lm
    rng = np.random.default_rng(23)
    inputs = (rng.integers(1, cfg.text_vocab_size, (1, 8)).astype(np.int32), np.asarray([6], np.int32),
              np.zeros((1, 4), np.int32), np.asarray([0], np.int32),
              rng.standard_normal((1, cfg.spk_dim)).astype(np.float32) * 0.2)
    ref = tlm.generate_speech_from_ids(tp, cfg, *_t(inputs), None, max_new_tokens=16, sampler=GREEDY,
                                       pad_multiple=16)
    spec = tlm.generate_speech_spec_from_ids(tp, cfg, *_t(inputs), max_new_tokens=16, gamma=4,
                                             pad_multiple=16)
    _assert_port_equals_standard(spec, ref)


def test_lookup_draft_matches_jax():
    """On random contexts over a 3-token alphabet (matches everywhere,
    also overlapping the tail, where the indices clamp to the last known
    token) and at every w, the port's draft is the JAX function's."""
    rng = np.random.default_rng(3)
    ctx = np.asarray([5, 6, 7, 9, 5, 6, 8, 3, 5, 6, 0, 0], np.int32)
    assert tlm._lookup_draft(torch.from_numpy(ctx), 10, 3).tolist() == [8, 3, 5]
    assert tlm._lookup_draft(torch.tensor([1, 2, 3, 4, 0, 0], dtype=torch.int32), 4, 3).tolist() == [4, 4, 4]
    assert tlm._lookup_draft(torch.tensor([7, 7, 7, 7, 0, 0], dtype=torch.int32), 4, 3).tolist() == [7, 7, 7]
    jdraft = jax.jit(jlm._lookup_draft, static_argnums=2)
    n = 0
    for trial in range(30):
        ctx = rng.integers(0, 3, (16,)).astype(np.int32)
        for w in range(0, 17):
            for gamma in (1, 3, 6):
                want = np.asarray(jdraft(jnp.asarray(ctx), jnp.int32(w), gamma))
                got = tlm._lookup_draft(torch.from_numpy(ctx), w, gamma).numpy()
                np.testing.assert_array_equal(got, want, err_msg=f"ctx {ctx.tolist()} w {w} gamma {gamma}")
                n += 1
    assert n > 1000


def test_spec_sampled_requires_generator(lm):
    cfg, _, tp = lm
    with pytest.raises(ValueError, match="Generator"):
        tlm.generate_speech_spec_from_ids(tp, cfg, *_t(_prompt(29, cfg)), max_new_tokens=8, gamma=2,
                                          pad_multiple=16, sampler=SamplerConfig(temperature=1.0, top_k=4))


def test_spec_sampled_topk1_equals_greedy(lm):
    """Top-k 1 sampling is argmax: rejection sampling emits the greedy
    speculative tokens."""
    cfg, _, tp = lm
    inputs = _prompt(13, cfg)
    ref = tlm.generate_speech_spec_from_ids(tp, cfg, *_t(inputs), max_new_tokens=24, gamma=4, pad_multiple=16)
    got = tlm.generate_speech_spec_from_ids(tp, cfg, *_t(inputs), torch.Generator().manual_seed(5),
                                            max_new_tokens=24, gamma=4, pad_multiple=16,
                                            sampler=SamplerConfig(temperature=1.0, top_k=1))
    np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens.numpy())
    assert int(got.lengths[0]) == int(ref.lengths[0])


def test_spec_sampled_preserves_marginal_distribution(lm):
    """The joint law of (token 0, token 1) of the sampled speculative path
    matches the standard sampled path's: 1200 runs each (the standard path
    as one batch of 1200 rows of the same prompt), total variation < 0.15."""
    cfg, _, tp = lm
    inputs = _prompt(17, cfg)
    sampler = SamplerConfig(temperature=1.2, top_k=4)
    N = 1200
    gen = torch.Generator().manual_seed(1000)
    spec_c: Counter = Counter()
    for _ in range(N):
        g = tlm.generate_speech_spec_from_ids(tp, cfg, *_t(inputs), gen, max_new_tokens=2, gamma=3,
                                              pad_multiple=16, sampler=sampler)
        spec_c[tuple(g.tokens[0].tolist())] += 1
    batch = [np.repeat(x, N, axis=0) for x in inputs]
    r = tlm.generate_speech_from_ids(tp, cfg, *_t(batch), torch.Generator().manual_seed(500_000),
                                     max_new_tokens=2, sampler=sampler, pad_multiple=16)
    std_c = Counter(tuple(row) for row in r.tokens.tolist())
    keys = set(spec_c) | set(std_c)
    tv = 0.5 * sum(abs(spec_c[k] - std_c[k]) for k in keys) / N
    assert tv < 0.15, (tv, dict(spec_c), dict(std_c))


def _spec_engine(seed, **changes):
    cfg = dataclasses.replace(tiny_config(), speculative_gamma=4, **changes)
    return tengine.Engine(cfg, seed=seed, device="cpu")


def _sine(sr):
    t = np.arange(sr) / sr
    return (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)


def test_engine_speculative_mode_sampled_and_seed_deterministic():
    """``Engine(speculative_gamma=4)`` keeps the standard sampled
    semantics: the same seed gives the same audio from two fresh engines,
    another seed other audio; ``last_spec`` and ``last_decode_steps`` count
    the verify forwards."""

    def run(seed):
        eng = _spec_engine(seed)
        feat = eng.prompt_features([_sine(eng.cfg.audio.prompt_sample_rate)])[0]
        out = eng._synthesize(["hello speculative world"], ["st"], [feat], [feat], max_seconds=2.0)
        assert np.isfinite(out[0]).all() and out[0].size > 0
        assert eng.last_spec["n_verify"] == eng.last_decode_steps > 0
        assert eng.last_spec["n_commit"] == eng.last_gen_len
        return out[0]

    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a, b)
    assert a.shape != c.shape or not np.array_equal(a, c)


def test_engine_speculative_takes_no_decode_kernel(monkeypatch):
    """On an int8 LM that the decode kernel does not serve (GQA), a
    speculative B=1 request takes the speculative decode, neither the
    kernel nor the standard loop; a batch of two keeps the standard
    decode."""
    tl = dataclasses.replace(tiny_config().token_lm, n_kv_heads=2)
    eng = _spec_engine(0, quantize_lm_int8=True, token_lm=tl)
    assert eng._mega_params is None
    feat = eng.prompt_features([_sine(eng.cfg.audio.prompt_sample_rate)])[0]
    start = tlm.start_decode

    def no_standard(*a, **k):
        raise AssertionError("a speculative B=1 request took the standard decode")

    monkeypatch.setattr(tlm, "start_decode", no_standard)
    wav = next(eng.inference_tts_with_st("hello there", "st", feat, feat, max_seconds=2.0))["tts_speech"]
    assert wav.shape[1] > 0 and np.isfinite(wav).all() and eng.last_spec is not None
    monkeypatch.setattr(tlm, "start_decode", start)
    out = eng.synthesize_batch(["a", "bc"], ["", "x"], [feat, feat], [feat, feat], max_seconds=1.0)
    assert len(out) == 2 and eng.last_spec is None


def test_engine_speculative_yields_to_decode_kernel(monkeypatch):
    """On an int8 LM that the decode kernel serves, ``speculative_gamma``
    is ignored: a B=1 request takes the kernel's step (its weights passed
    as ``decode_params``), never the speculative decode."""
    eng = _spec_engine(0, quantize_lm_int8=True)
    assert eng._mega_params is not None
    feat = eng.prompt_features([_sine(eng.cfg.audio.prompt_sample_rate)])[0]
    seen, standard = [], tlm.generate_speech_from_ids

    def no_spec(*a, **k):
        raise AssertionError("a B=1 request the decode kernel serves took the speculative decode")

    def spy(*a, **k):
        seen.append(k.get("decode_params"))
        return standard(*a, **k)

    monkeypatch.setattr(tlm, "generate_speech_spec_from_ids", no_spec)
    monkeypatch.setattr(tlm, "generate_speech_from_ids", spy)
    wav = next(eng.inference_tts_with_st("hello there", "st", feat, feat, max_seconds=2.0))["tts_speech"]
    assert wav.shape[1] > 0 and np.isfinite(wav).all() and eng.last_spec is None
    assert len(seen) == 1 and seen[0] is eng._mega_params


def test_spec_on_trained_demo_engine():
    """On the trained demo LM (``demo_engine.npz``), three held-out rows,
    greedy, ``min_tokens=128`` (EOS suppressed throughout), gamma 4: the
    port's speculative tokens equal its standard greedy decode and the JAX
    function's (but at a near-tie), and prompt-lookup drafting saves
    verify forwards: commits per verify above the reference's 1.5."""
    cfg = demo_config()
    tree = load_npz(FIXTURES / "demo_engine.npz")
    eng = tengine.Engine(cfg, params=tengine.EngineParams.from_tree(from_jax_tree(tree, cfg)), device="cpu")
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), tree["token_lm"])
    tp, tl = eng.params.token_lm, cfg.token_lm
    rows = json.loads((FIXTURES / "demo_corpus_sample" / "manifest.json").read_text())
    ratios = []
    for row in rows[:3]:
        wav, sr = read_wav(FIXTURES / "demo_corpus_sample" / row["wav"])
        assert sr == cfg.audio.prompt_sample_rate
        feat = eng.prompt_features([wav])[0]
        ids = frontend.encode(row["text"], tokenizer=eng.text_tokenizer)
        sty = np.zeros((1, 64), np.int32)
        n_s = min(len(feat.tokens), 64)
        sty[0, :n_s] = feat.tokens[:n_s]
        inputs = (np.asarray(ids, np.int32)[None], np.asarray([len(ids)], np.int32), sty,
                  np.asarray([n_s], np.int32), feat.spk[None].astype(np.float32))
        kw = dict(max_new_tokens=128, gamma=4, min_tokens=128)
        got = tlm.generate_speech_spec_from_ids(tp, tl, *_t(inputs), **kw)
        want = jlm.generate_speech_spec_from_ids(jp, tl, *map(jnp.asarray, inputs), **kw)
        ref, gaps = _greedy_with_gaps(tp, tl, inputs, 128, min_tokens=128)
        _assert_port_equals_standard(got, ref)
        i = _first_difference(got.tokens[0].tolist(), np.asarray(want.tokens)[0].tolist())
        assert i is None or gaps[i] < NEAR_TIE, (row["wav"], i, gaps[i] if i is not None else None)
        ratios.append(got.n_commit / got.n_verify)
    assert float(np.mean(ratios)) > 1.5, ratios
