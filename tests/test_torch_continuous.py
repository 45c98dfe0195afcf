"""Continuous batching and concurrent streaming through the port
(``ContinuousBatcher``, ``StreamingScheduler``, ``token_lm.prefill_prefix``
/ ``decode_chunk``, per-row cache writes), on the CPU at ``tiny_config()``
widths, against the JAX package on the same weights and numpy-seeded
inputs.

Tolerances (the LM computes in bf16 on both sides):
- ``build_prefix_padded``: f32 embeddings, atol 1e-5 (measured: equal);
- ``prefill_prefix``: next logits within 8e-2, the bound
  ``test_torch_batch.py`` sets for bf16 work that XLA:CPU fuses and rounds
  otherwise (measured 2.7e-2 to 3.4e-2);
  the cache over each row's real slots within four bf16 ulps of its largest
  value (measured up to two: one ulp of k in [4, 8), two of v in [2, 4));
  an int8 cache compared dequantized, within that plus one step of its
  scale (its values move by a few steps where a bf16 flip moves a row's
  absmax);
- ``decode_chunk``, greedy, from the same prefilled state, bf16 and int8
  caches: the same tokens, positions, done flags and counts; the logits
  after the chunk within 8e-2 (measured 2.3e-2 to 2.6e-2);
- one decode step with per-row cache writes (``core.forward`` with [B]
  ``cache_start``) against the reference's masked whole-cache select:
  hidden states and the written rows within four bf16 ulps of their
  largest value (measured two), every other slot untouched.
The JAX package's own ``test_continuous.py`` and ``test_stream_serve.py``
contracts are held on the port: greedy tokens equal ``generate_speech``
over the same prefix (bf16 and int8 caches), mixed admissions finish, an
empty style prompt at exactly ``p_max`` is rejected, a solo streaming
session equals the engine's token-override stream exactly, concurrent
sessions interleave, and a bad request errors alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autostyle_tts_tpu.models.token_lm as jlm
import autostyle_tts_tpu.models.transformer as jtransformer
import autostyle_tts_tpu_torch.models.token_lm as tlm
from autostyle_tts_tpu.ops.quant import quantize_tree as jquantize_tree
from autostyle_tts_tpu.ops.sampling import SamplerConfig as JSampler
from autostyle_tts_tpu.utils import config as jconfig
from autostyle_tts_tpu_torch.models import frontend
from autostyle_tts_tpu_torch.models import transformer as ttransformer
from autostyle_tts_tpu_torch.ops.sampling import SamplerConfig
from autostyle_tts_tpu_torch.pipeline import engine as tengine
from autostyle_tts_tpu_torch.pipeline.continuous import ContinuousBatcher
from autostyle_tts_tpu_torch.pipeline.stream_serve import StreamingScheduler
from autostyle_tts_tpu_torch.utils import config as tconfig
from autostyle_tts_tpu_torch.weights import tree_from_numpy

LOGIT_ATOL = 8e-2
GREEDY = SamplerConfig(greedy=True)


def _lm(quant: bool):
    cfg = jconfig.tiny_config().token_lm
    jp = jlm.init_params(jax.random.PRNGKey(0), cfg)
    if quant:
        jp = jquantize_tree(jp)
    return cfg, jp, tree_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def _prefix_inputs(cfg):
    rng = np.random.default_rng(0)
    text = rng.integers(16, 200, (2, 40)).astype(np.int32)
    sty = rng.integers(0, 64, (2, 64)).astype(np.int32)
    spk = rng.standard_normal((2, cfg.spk_dim)).astype(np.float32)
    return text, np.asarray([40, 23], np.int32), sty, np.asarray([50, 64], np.int32), spk


def _bf16_bound(x):
    """Four bf16 ulps of the largest magnitude in ``x``."""
    return 4 * 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


def _dequant(cache, name):
    if name + "_scale" in cache:
        return np.asarray(cache[name], np.float32) * np.asarray(cache[name + "_scale"], np.float32)[..., None]
    return np.asarray(jnp.asarray(cache[name], jnp.float32)) if not torch.is_tensor(cache[name]) \
        else cache[name].float().numpy()


@pytest.fixture
def flash_route(monkeypatch):
    """The reference's prefill on its flash route (its accelerator's, and
    the only one the port has): ``flash_ok`` forced on, the Pallas kernel in
    interpret mode; the traces it makes must not outlive the test."""
    traced = (jlm.prefill_prefix, jlm.build_prefix_padded)
    monkeypatch.setattr(jtransformer, "flash_ok", lambda t, hd: True)
    for fn in traced:
        fn.clear_cache()
    yield
    for fn in traced:
        fn.clear_cache()


def _prefilled(quant, kv_int8, s_max=176):
    cfg, jp, tp = _lm(quant)
    tcfg = tconfig.tiny_config().token_lm
    inputs = _prefix_inputs(cfg)
    jpre = jlm.build_prefix_padded(jp, cfg, *map(jnp.asarray, inputs), pad_multiple=128)
    tpre = tlm.build_prefix_padded(tp, tcfg, *map(torch.from_numpy, inputs), pad_multiple=128)
    jout = jlm.prefill_prefix(jp, cfg, jpre, s_max=s_max, kv_int8=kv_int8)
    tout = tlm.prefill_prefix(tp, tcfg, tpre, s_max=s_max, kv_int8=kv_int8)
    return cfg, jp, tcfg, tp, (jpre, tpre), jout, tout


@pytest.mark.parametrize("quant,kv_int8", [(False, False), (False, True), (True, False), (True, True)])
def test_prefill_prefix_matches_jax(flash_route, quant, kv_int8):
    _, _, _, _, (jpre, tpre), (jc, jl, jo), (tc, tl_, to) = _prefilled(quant, kv_int8)
    np.testing.assert_allclose(tpre.embeds.numpy(), np.asarray(jpre.embeds), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tpre.length.numpy(), np.asarray(jpre.length))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert float(np.abs(tl_.numpy() - np.asarray(jl)).max()) < LOGIT_ATOL
    assert set(tc) == set(jc) and all(tuple(tc[k].shape) == jc[k].shape for k in jc)
    for name in ("k", "v"):
        want, got = _dequant(jc, name), _dequant(tc, name)
        for r, off in enumerate(np.asarray(jo)):
            bound = _bf16_bound(want[:, r, off:])
            if kv_int8:
                bound += float(np.asarray(jc[name + "_scale"])[:, r, off:].max())
            assert float(np.abs(got[:, r, off:] - want[:, r, off:]).max()) < bound, (name, r)
        assert not got[:, :, 128:].any()     # slots past the prefix stay empty


@pytest.mark.parametrize("quant,kv_int8", [(False, False), (True, True)])
def test_decode_chunk_greedy_matches_jax(flash_route, quant, kv_int8):
    """Two slots at their own positions (one four slots behind), eight
    greedy steps, from the reference's prefilled state."""
    cfg, jp, tcfg, tp, _, (jc, jl, jo), _ = _prefilled(quant, kv_int8)
    t = np.asarray([128, 124], np.int32)
    steps = np.asarray([0, 3], np.int32)
    tcache = {k: torch.from_numpy(np.array(v)) if v.dtype != jnp.bfloat16
              else torch.from_numpy(np.array(jnp.asarray(v, jnp.float32))).to(torch.bfloat16)
              for k, v in jc.items()}
    got = tlm.decode_chunk(tp, tcfg, tcache, torch.from_numpy(np.array(jl)), torch.from_numpy(t),
                           torch.from_numpy(np.array(jo)), torch.zeros(2, dtype=torch.bool), torch.from_numpy(steps),
                           None, n_steps=8, sampler=GREEDY)
    want = jlm.decode_chunk(jp, cfg, jc, jl, jnp.asarray(t), jo, jnp.zeros((2,), bool), jnp.asarray(steps),
                            jax.random.PRNGKey(0), n_steps=8, sampler=JSampler(greedy=True), min_tokens=2)
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    for i in (2, 3, 4):       # t, done, steps
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    assert float(np.abs(got[1].numpy() - np.asarray(want[1])).max()) < LOGIT_ATOL
    for name in ("k", "v"):       # the folded rows [t0, t0 + 8)
        g, w = _dequant(got[0], name), _dequant(want[0], name)
        for r in range(2):
            rows = slice(int(t[r]), int(t[r]) + 8)
            bound = _bf16_bound(w[:, r, rows]) + (float(np.asarray(want[0][name + "_scale"])[:, r, rows].max())
                                                  if kv_int8 else 0.0)
            assert float(np.abs(g[:, r, rows] - w[:, r, rows]).max()) < bound


def test_forward_writes_one_cache_slot_a_row():
    """One decode step, two rows at their own slots: the port's indexed
    write against the reference's masked select over the whole cache."""
    jcfg = jlm.core_config(jconfig.tiny_config().token_lm)
    tcfg = tlm.core_config(tconfig.tiny_config().token_lm)
    _, jp, tp = _lm(False)
    rng = np.random.default_rng(3)
    S = 24
    k0 = (rng.standard_normal((jcfg.n_layers, 2, S, jcfg.n_kv_heads, jcfg.head_dim)) * 0.5).astype(np.float32)
    v0 = (rng.standard_normal(k0.shape) * 0.5).astype(np.float32)
    x = (rng.standard_normal((2, 1, jcfg.dim)) * 0.3).astype(np.float32)
    start = np.asarray([9, 17], np.int32)
    mask = np.arange(S)[None, None, None, :] <= start[:, None, None, None]
    jout = jtransformer.forward(jp, jcfg, inputs_embeds=jnp.asarray(x), positions=jnp.asarray(start[:, None]),
                                mask=jnp.asarray(mask), cache={"k": jnp.asarray(k0, jnp.bfloat16),
                                                               "v": jnp.asarray(v0, jnp.bfloat16)},
                                cache_start=jnp.asarray(start), skip_logits=True)
    cache = {"k": torch.from_numpy(k0).to(torch.bfloat16), "v": torch.from_numpy(v0).to(torch.bfloat16)}
    hidden = ttransformer.forward(tp, tcfg, inputs_embeds=torch.from_numpy(x),
                                  positions=torch.from_numpy(start[:, None]).long(), mask=torch.from_numpy(mask),
                                  cache=cache, cache_start=torch.from_numpy(start))
    want_h = np.asarray(jnp.asarray(jout.hidden, jnp.float32))
    assert float(np.abs(hidden.float().numpy() - want_h).max()) < _bf16_bound(want_h)
    for name in ("k", "v"):
        w = np.asarray(jnp.asarray(jout.cache[name], jnp.float32))
        g = cache[name].float().numpy()
        for r in range(2):
            assert float(np.abs(g[:, r, start[r]] - w[:, r, start[r]]).max()) < _bf16_bound(w[:, r, start[r]])
            others = np.arange(S) != start[r]
            np.testing.assert_array_equal(g[:, r, others], w[:, r, others])
    with pytest.raises(ValueError, match="one decode slot a row"):
        ttransformer.forward(tp, tcfg, inputs_embeds=torch.zeros(2, 2, tcfg.dim), positions=torch.zeros(2, 2).long(),
                             mask=torch.ones(2, 1, 2, S, dtype=torch.bool), cache=cache,
                             cache_start=torch.from_numpy(start))


# ----------------------------------------------------------------------- the batcher's contracts


SR = 1600


def _wav(f=220.0, seed=0, seconds=1.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    return (0.4 * np.sin(2 * np.pi * f * t) + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def engine():
    return tengine.Engine(tconfig.tiny_config(), seed=0, device="cpu")


@pytest.mark.parametrize("kv_int8", [False, True])
def test_continuous_greedy_matches_generate_speech(engine, kv_int8):
    """A request decoded in chunks of slots gives the greedy tokens of one
    ``generate_speech`` over the same padded prefix, bf16 or int8 cache."""
    feat = engine.prompt_features([_wav(seed=3)])[0]
    req = {"id": "x", "text": "hello parity", "style_text": "st", "style_feat": feat, "flow_feat": feat}
    bat = ContinuousBatcher(engine, slots=2, chunk=5, p_max=64, sampler=GREEDY, max_new=24, kv_int8=kv_int8)
    assert ("k_scale" in bat.cache) == kv_int8
    bat.submit(dict(req))
    done = bat.drain()
    assert len(done) == 1
    got = done[0]["tokens"]
    ref = tlm.generate_speech(engine.params.token_lm, engine.cfg.token_lm, bat._build_prefix(req), None,
                              max_new_tokens=24, sampler=GREEDY, min_tokens=2, kv_int8=kv_int8)
    n = int(ref.lengths[0])
    np.testing.assert_array_equal(got[:n], ref.tokens[0, :n].numpy())
    assert len(got) == n or len(got) == 24


def test_continuous_mixed_admission_all_finish(engine):
    """More requests than slots: later ones join as slots free up; all
    finish and render."""
    feats = engine.prompt_features([_wav(seed=i, f=200 + 40 * i) for i in range(3)])
    bat = ContinuousBatcher(engine, slots=2, chunk=4, p_max=64, sampler=GREEDY, max_new=12)
    for i, f in enumerate(feats):
        bat.submit({"id": f"r{i}", "text": f"request number {i} speaks", "style_text": "",
                    "style_feat": f, "flow_feat": f})
    done = bat.drain()
    assert sorted(d["id"] for d in done) == ["r0", "r1", "r2"] and bat.idle
    wavs = engine.synthesize_from_tokens(done, max_seconds=2.0)
    assert len(wavs) == 3 and all(np.isfinite(w).all() and w.size > 0 for w in wavs)


def test_continuous_empty_style_at_exact_pmax_rejected(engine):
    """An empty style prompt takes one pad row at admission, so a request
    whose raw prefix fills ``p_max`` exactly is rejected with an error."""
    feat = engine.prompt_features([_wav(seed=4)])[0]
    empty = dataclasses.replace(feat, tokens=np.zeros((0,), np.int32))
    ids = frontend.encode("hello there", tokenizer=engine.text_tokenizer, numbers=engine.normalize_numbers)
    bat = ContinuousBatcher(engine, slots=2, chunk=4, p_max=2 + len(ids), sampler=GREEDY, max_new=8)
    bat.submit({"id": "edge", "text": "hello there", "style_text": "", "style_feat": empty, "flow_feat": feat})
    assert bat.step() == []
    rej = bat.take_rejected()
    assert len(rej) == 1 and "p_max" in rej[0]["error"] and bat.idle


def test_continuous_empty_style_with_headroom_finishes(engine):
    feat = engine.prompt_features([_wav(seed=5)])[0]
    empty = dataclasses.replace(feat, tokens=np.zeros((0,), np.int32))
    bat = ContinuousBatcher(engine, slots=2, chunk=4, p_max=64, sampler=GREEDY, max_new=8)
    bat.submit({"id": "ok", "text": "hello", "style_text": "", "style_feat": empty, "flow_feat": feat})
    done = bat.drain()
    assert len(done) == 1 and done[0]["id"] == "ok" and len(done[0]["tokens"]) >= 1


def test_admission_batches_to_a_power_of_two_with_one_prefill(engine, monkeypatch):
    """Three admissions: one prefill of four rows (the last request
    repeated), complementary widths filling ``p_max``."""
    shapes = []
    prefill = tlm.prefill_prefix
    monkeypatch.setattr(tlm, "prefill_prefix", lambda *a, **k: shapes.append(tuple(a[2].embeds.shape))
                        or prefill(*a, **k))
    feats = engine.prompt_features([_wav(seed=i, f=210 + 30 * i) for i in range(3)])
    bat = ContinuousBatcher(engine, slots=4, chunk=4, p_max=128, sampler=GREEDY, max_new=8)
    for i, f in enumerate(feats):
        bat.submit({"id": f"r{i}", "text": f"line {i}", "style_text": "", "style_feat": f, "flow_feat": f})
    bat.step()
    assert shapes == [(4, 128, engine.cfg.token_lm.dim)]
    assert [s.req["id"] for s in bat.slots[:3]] == ["r0", "r1", "r2"] and bat.slots[3].req is None


# ----------------------------------------------------------------------- the scheduler's contracts


def _req(feat, text="stream serve test", n=None):
    r = {"text": text, "style_text": "st", "style_feat": feat, "flow_feat": feat}
    if n is not None:
        r["max_tokens"] = n
    return r


def test_solo_session_matches_engine_stream(engine):
    """A solo session's audio equals the engine's own stream of the same
    tokens (the token-override path) from the same engine generator state:
    both draw one CFM noise a window from it."""
    feat = engine.prompt_features([_wav(seed=5)])[0]
    sch = StreamingScheduler(engine, slots=2, max_seconds=2.0, sampler=GREEDY)
    state = engine.generator.get_state()
    sid = sch.submit(_req(feat, n=3 * sch.chunk))
    events = sch.run()[sid]
    kinds = [e.kind for e in events]
    assert kinds[-1] == "done" and kinds[:-1] == ["chunk"] * (len(kinds) - 1) and len(kinds) > 2
    got = np.concatenate([e.wav for e in events if e.kind == "chunk"])
    engine.generator.set_state(state)
    ref = np.concatenate(list(engine._synthesize_stream(
        "", "", None, feat, lm_tokens_override=np.asarray(sch.finished[sid].tokens, np.int32))))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_concurrent_sessions_interleave(engine):
    """Three sessions of two chunks: each completes with its audio, and
    every session's first chunk comes before the first completion."""
    feat = engine.prompt_features([_wav(seed=6, f=260.0)])[0]
    sch = StreamingScheduler(engine, slots=4, max_seconds=2.0, sampler=GREEDY)
    n = 2 * sch.chunk
    sids = [sch.submit(_req(feat, text=f"turn number {i} of the dialogue", n=n)) for i in range(3)]
    order, per = [], {s: [] for s in sids}
    for _ in range(1000):
        if sch.idle:
            break
        for ev in sch.step():
            order.append((ev.session, ev.kind))
            per[ev.session].append(ev)
    per_token = engine.cfg.cfm.upsample * engine.cfg.audio.hop_length
    for s in sids:
        assert per[s][-1].kind == "done"
        assert sum(len(e.wav) for e in per[s]) == len(sch.finished[s].tokens) * per_token > 0
    first_chunk = [next(i for i, (sid, k) in enumerate(order) if sid == s and k == "chunk") for s in sids]
    first_done = min(i for i, (_, k) in enumerate(order) if k == "done")
    assert max(first_chunk) < first_done
    assert sch.take_finished().keys() == set(sids) and not sch.finished


def test_error_isolation(engine):
    feat = engine.prompt_features([_wav(seed=7)])[0]
    sch = StreamingScheduler(engine, slots=2, max_seconds=2.0, p_max=64, sampler=GREEDY)
    ok = sch.submit(_req(feat, n=sch.chunk))
    bad = sch.submit(_req(feat, text="x " * 500))     # prefix > p_max
    out = sch.run()
    assert [e.kind for e in out[bad]] == ["error"] and "p_max" in out[bad][0].error
    assert out[ok][-1].kind == "done" and sum(len(e.wav) for e in out[ok]) > 0
