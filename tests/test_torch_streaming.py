"""Streaming through the port (``stream=True`` on every entry point), on the
CPU at ``tiny_config()`` widths, against the JAX package on the same
weights and numpy-seeded inputs.

Tolerances:
- the window body (``engine.stream_window`` against the JAX engine's
  ``_stream_chunk``, the port handed the noise the JAX key draws,
  ``jax.random.normal(key, (B, W * up, M))``): the chunk's samples atol
  1e-3, because the JAX window returns them as f16 (half an ulp is at most
  4.9e-4 below 1); the chunk's mel atol 1e-4 (f32 on both sides through the
  CFM, in another summation order);
- a voice-conversion stream against the JAX engine's, chunk after chunk,
  each window handed the JAX key's noise: atol 1e-3 on every chunk (f16 on
  the JAX side), which holds the seams and the mel context carried from
  window to window;
- a window read from each row's fixed ``[emitted - chunk, emitted +
  chunk)`` token slice against the same window read from the whole
  growing buffer (the arithmetic is the same): exactly equal;
- the same request streamed and not streamed from the same generator
  state (the default sampler, temperature 1 and top-k 25): the same tokens,
  exactly, on the decode step (int8 LM, its plain version here) and on the
  scanned decode (dense LM), and joined chunks as long as the wav.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autostyle_tts_tpu_torch.models.token_lm as tlm
from autostyle_tts_tpu.pipeline import engine as jengine
from autostyle_tts_tpu.utils import config as jconfig
from autostyle_tts_tpu_torch.pipeline import engine as tengine
from autostyle_tts_tpu_torch.utils import config as tconfig
from autostyle_tts_tpu_torch.weights import from_jax_tree

SEED = 3


def _tree(cfg):
    tree = jax.tree_util.tree_map(np.asarray, jengine.EngineParams.init(jax.random.PRNGKey(0), cfg).tree())
    rng = np.random.default_rng(0)
    c = tree["cfm"]     # fill the zero-initialized modulation and output projection
    c["layers"]["mod"] = (rng.standard_normal(c["layers"]["mod"].shape) * 0.05).astype(np.float32)
    c["out_proj"] = (rng.standard_normal(c["out_proj"].shape) * 0.1).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = jconfig.tiny_config(), tconfig.tiny_config()
    tree = _tree(jcfg)
    jeng = jengine.Engine(jcfg, params=jengine.EngineParams.from_tree(
        jax.tree_util.tree_map(jnp.asarray, tree)), seed=SEED)
    teng = tengine.Engine(tcfg, params=tengine.EngineParams.from_tree(from_jax_tree(tree, tcfg)),
                          seed=SEED, device="cpu")
    return jeng, teng


def _wav(seed, seconds=1.0, sr=1600, f=220.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    return (0.4 * np.sin(2 * np.pi * f * t) + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


def _chunk(cfg):
    return max(8, (2 * cfg.token_lm.token_rate) // 3)


# ----------------------------------------------------------------------- the window body


def _token_slice(gen, emitted, chunk):
    """Each row's generated tokens ``emitted - chunk .. emitted + chunk``
    ([B, 2 * chunk], zero outside the row's buffer): what a window reads."""
    out = np.zeros((len(gen), 2 * chunk), np.int32)
    for b, e in enumerate(emitted):
        for c in range(2 * chunk):
            if 0 <= e - chunk + c < gen.shape[1]:
                out[b, c] = gen[b, e - chunk + c]
    return out


@pytest.mark.parametrize("rows", [
    [(40, 0, 20, 40)],                                     # (gen_len, emitted, n_p, n_mel)
    [(40, 16, 32, 64), (20, 16, 7, 10), (33, 32, 25, 50)],
])
def test_stream_window_matches_jax(engines, rows):
    jeng, teng = engines
    cfg = teng.cfg
    up, hop, M = cfg.cfm.upsample, cfg.audio.hop_length, cfg.cfm.n_mels
    chunk, fp_w = _chunk(cfg), 32
    B = len(rows)
    rng = np.random.default_rng(11 + B)
    gen = rng.integers(0, 64, (B, 48)).astype(np.int32)
    gl, em, n_p, n_mel = (np.asarray([r[i] for r in rows], np.int32) for i in range(4))
    ptok = rng.integers(0, 64, (B, fp_w)).astype(np.int32)
    pmel = rng.standard_normal((B, fp_w * up, M)).astype(np.float32)
    spk = rng.standard_normal((B, cfg.token_lm.spk_dim)).astype(np.float32)
    ctx = rng.standard_normal((B, chunk * up, M)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    packed, jmel = jeng._stream_chunk(jnp.asarray(gen), jnp.asarray(gl), jnp.asarray(em), jnp.asarray(ptok),
                                      jnp.asarray(n_p), jnp.asarray(pmel), jnp.asarray(n_mel), jnp.asarray(spk),
                                      jnp.asarray(ctx), key, chunk=chunk, fp_w=fp_w)
    jwav, vals = jengine._unpack_vals(np.asarray(packed), 2)
    W = fp_w + 2 * chunk
    noise = torch.from_numpy(np.array(jax.random.normal(key, (B, W * up, M), jnp.float32)))
    t = torch.from_numpy
    wav, mel = tengine.stream_window(teng.params, cfg, t(_token_slice(gen, em, chunk)), t(gl), t(em), t(ptok),
                                     t(n_p), t(pmel), t(n_mel), t(spk), t(ctx), None, chunk=chunk, noise=noise)
    n_c = np.minimum(chunk, gl - em)
    np.testing.assert_array_equal(vals[:, 0], n_c)
    for b in range(B):
        n = n_c[b] * up * hop
        np.testing.assert_allclose(wav[b, :n].numpy(), jwav[b, :n].astype(np.float32), atol=1e-3, rtol=0)
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), atol=1e-4, rtol=0)


def _growing_window(params, cfg, gen_tokens, gen_len, emitted, prompt_tokens, n_p, prompt_mel, n_mel, spk,
                    mel_ctx, *, chunk, noise):
    """The window as it read each row's whole token buffer ([B, W_g],
    token i at column i), before it read a fixed slice: the reference the
    slice has to reproduce exactly."""
    from autostyle_tts_tpu_torch.models import cfm, vocoder

    up, hop, M = cfg.cfm.upsample, cfg.audio.hop_length, cfg.cfm.n_mels
    B, fp_w = prompt_tokens.shape
    W = fp_w + 2 * chunk
    gl, em, npp, nm = (x.long().reshape(-1, 1) for x in (gen_len, emitted, n_p, n_mel))
    n_chunk = torch.clamp(gl - em, max=chunk)
    slot = torch.arange(W)[None, :]
    ctx_lo = fp_w + chunk - torch.clamp(em, max=chunk)
    gidx = slot - (fp_w + chunk) + em
    from_gen = torch.gather(gen_tokens.long(), 1, torch.clamp(gidx, 0, gen_tokens.shape[1] - 1))
    from_prompt = torch.gather(prompt_tokens.long(), 1, torch.clamp(slot, 0, fp_w - 1).expand(B, W))
    in_tail = (slot >= ctx_lo) & (gidx < em + n_chunk) & (slot >= fp_w)
    tokens = torch.where(slot < npp, from_prompt, torch.where(in_tail, from_gen, torch.zeros_like(from_gen)))
    fr = torch.arange(W * up)[None, :]
    sl = fr // up
    in_ctx = (sl >= ctx_lo) & (sl < fp_w + chunk)
    pmask = ((fr < nm) | in_ctx).float()
    fmask = ((fr < npp * up) | in_ctx | ((sl >= fp_w + chunk) & (sl < fp_w + chunk + n_chunk))).float()
    pm = torch.zeros((B, W * up, M), dtype=torch.float32)
    pm[:, : fp_w * up] = prompt_mel * (torch.arange(fp_w * up)[None, :, None] < nm[:, :, None])
    pm[:, fp_w * up : (fp_w + chunk) * up] = mel_ctx
    pm = pm * pmask[..., None]
    pos = torch.where(fr < fp_w * up, fr, torch.clamp((npp + em - chunk) * up + fr - fp_w * up, min=0))
    cond = cfm.upsample_tokens(params.cfm, tokens, up, cfg.cfm.token_vocab_size)
    mel = cfm.sample_mel(params.cfm, cfg.cfm, None, cond, spk, pm, pmask, fmask, use_cfg=cfg.cfm.use_cfg,
                         positions=pos, noise=noise)
    lo = (fp_w + chunk) * up
    wav = vocoder.apply(params.vocoder, cfg.vocoder, mel)[:, lo * hop : (lo + chunk * up) * hop].float()
    return wav, mel[:, lo : lo + chunk * up]


@pytest.mark.parametrize("rows", [
    [(16, 0)],                # (tokens so far, emitted): the first window
    [(60, 32)],               # a middle window, tokens past the chunk already drawn
    [(53, 48)],               # the last, short window
    [(40, 16), (21, 8)],      # two rows at different emitted, one with less context than a chunk
])
def test_token_slice_window_equals_growing_buffer(engines, rows):
    """``render_windows`` reads each row's ``[emitted - chunk, emitted +
    chunk)`` tokens as a fixed [B, 2 * chunk] slice: the window it renders
    equals, exactly, the window read from the row's whole growing buffer
    (the same noise, eagerly on the CPU)."""
    _, eng = engines
    cfg = eng.cfg
    up, hop, M = cfg.cfm.upsample, cfg.audio.hop_length, cfg.cfm.n_mels
    chunk = _chunk(cfg)
    rng = np.random.default_rng(31 + len(rows))
    tokens = [list(rng.integers(0, 64, n)) for n, _ in rows]
    emitted = [e for _, e in rows]
    prompts = [eng._flow_stream_dev(eng.prompt_features([_wav(40 + b)])[0]) for b in range(len(rows))]
    assert len({p.key for p in prompts}) == 1
    fp_w = prompts[0].key[0]
    mel_ctx = torch.from_numpy(rng.standard_normal((len(rows), chunk * up, M)).astype(np.float32))
    noise = rng.standard_normal((len(rows), (fp_w + 2 * chunk) * up, M)).astype(np.float32)
    wavs, mel_chunk = eng.render_windows(tokens, emitted, prompts, mel_ctx, chunk, noise=noise)
    buf = np.zeros((len(rows), max(len(t) for t in tokens)), np.int32)
    for b, t in enumerate(tokens):
        buf[b, : len(t)] = t
    t32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    want, want_mel = _growing_window(
        eng.params, cfg, torch.from_numpy(buf), t32([len(t) for t in tokens]), t32(emitted),
        torch.cat([p.tokens for p in prompts]), t32([p.n_p for p in prompts]), torch.cat([p.mel for p in prompts]),
        t32([p.n_mel for p in prompts]), torch.cat([p.spk for p in prompts]), mel_ctx, chunk=chunk,
        noise=torch.from_numpy(noise))
    for b, (t, e) in enumerate(zip(tokens, emitted)):
        n = min(chunk, len(t) - e) * up * hop
        assert wavs[b].shape == (n,)
        np.testing.assert_array_equal(wavs[b], want[b, :n].numpy())
    assert torch.equal(mel_chunk, want_mel)


def test_cpu_engine_renders_windows_eagerly(engines):
    """Off a card the window is ``stream_window``, eager: no kept graph, and
    each window's ``cfm`` span keeps its children and counts no replay or
    capture (``graph`` false), as its ``vocoder`` span does."""
    _, eng = engines
    chunks = list(eng.inference_vc(_wav(50, seconds=2.0), _wav(51), stream=True))
    assert len(chunks) > 1 and eng._windows == []
    trace = eng.last_trace
    cfms = [s for s in trace if s.name == "cfm"]
    assert len(cfms) == len(chunks) == len([s for s in trace if s.name == "vocoder"])
    for s in cfms + [s for s in trace if s.name == "vocoder"]:
        assert s.counters["graph_replays"] == 0 and s.counters["graph_captures"] == 0
        assert s.attrs["graph"] is False
    assert all(s.counters["euler_steps"] == eng.cfg.cfm.n_steps and s.counters["frames"] > 0 for s in cfms)
    ids = {s.id for s in cfms}
    assert sum(s.name in ("cfm.cond", "cfm.solve") and s.parent in ids for s in trace) == 2 * len(cfms)


def test_window_graph_keys_fit_the_kept_graphs(engines, monkeypatch):
    """The window graphs a scheduler can ask for (1 to 8 due sessions on
    prompts of either stream width) are keyed on the row count rounded up
    to a ``WINDOW_ROWS`` count, so all of them fit in ``MAX_KEPT_WINDOWS``:
    a second sweep in another order finds each one kept. A window of more
    rows is eager; a weight rebound inside the served tree (not only a new
    tree) gives another key. Run on the CPU engine with the card check
    forced (nothing is recorded here)."""
    _, eng = engines
    monkeypatch.setattr(tlm, "graph_step_fits", lambda dev: True)
    monkeypatch.setattr(eng, "_windows", [])
    chunk = _chunk(eng.cfg)
    rng = np.random.default_rng(5)
    feats = [tengine.PromptFeatures(tokens=rng.integers(0, 64, n).astype(np.int32),
                                    spk=rng.standard_normal(eng.cfg.speaker.emb_dim).astype(np.float32),
                                    mel24=rng.standard_normal((2 * n, eng.cfg.cfm.n_mels)).astype(np.float32))
             for n in (20, 40, 90)]
    prompts = [eng._flow_stream_dev(f) for f in feats]
    assert sorted({p.key[0] for p in prompts}) == list(tengine.STREAM_BUCKETS) == [32, 64]
    first = {}
    for B in range(1, 9):
        for p in prompts:
            win = eng._window_graph(B, p, chunk)
            assert win.block.shape[0] in tengine.WINDOW_ROWS and B <= win.block.shape[0] < 2 * B
            first[B, p.key] = win
    assert len(eng._windows) == tengine.MAX_KEPT_WINDOWS == len({id(w) for w in first.values()})
    for B, key in reversed(list(first)):
        assert eng._window_graph(B, next(p for p in prompts if p.key == key), chunk) is first[B, key]
    assert eng._window_graph(9, prompts[0], chunk) is None
    out_proj = eng.params.cfm["out_proj"]
    monkeypatch.setitem(eng.params.cfm, "out_proj", out_proj.clone())
    moved = eng._window_graph(1, prompts[0], chunk)
    assert moved is not first[1, prompts[0].key] and len(eng._windows) == tengine.MAX_KEPT_WINDOWS


# ----------------------------------------------------------------------- the JAX stream contracts


def test_stream_vc_chunk_count_and_sizes(engines):
    """Voice conversion streams the source's tokens: ceil(n / chunk) chunks,
    every one but the last ``chunk`` tokens long, joined n tokens long."""
    _, eng = engines
    cfg = eng.cfg
    per_token = cfg.cfm.upsample * cfg.audio.hop_length
    chunk = _chunk(cfg)
    src, prm = _wav(3, seconds=4.0), _wav(4)
    chunks = [j["tts_speech"] for j in eng.inference_vc(src, prm, stream=True)]
    n_tok = len(eng.prompt_features([src])[0].tokens)
    assert len(chunks) == -(-n_tok // chunk) == len(eng.last_chunk_ms) > 1
    assert sum(c.shape[1] for c in chunks) == n_tok * per_token
    assert all(c.shape == (1, chunk * per_token) for c in chunks[:-1])
    assert all(c.dtype == np.float32 and np.isfinite(c).all() for c in chunks)
    assert eng.last_decode_steps == 0 and "prefill" not in eng.last_timings
    assert 0 < eng.last_timings["ttfa"] and {"featurize", "cfm", "vocoder"} <= set(eng.last_timings)


def test_stream_short_prompt_mel_clamped(engines):
    """A prompt shorter than one token's hop (40 samples at 1600 Hz: one
    token, one mel frame) has fewer mel frames than n_p * upsample: the
    window's prompt mask stops at the mel it has."""
    _, eng = engines
    chunks = list(eng.inference_vc(_wav(6, seconds=2.0), _wav(7, seconds=0.025), stream=True))
    assert chunks and all(np.isfinite(c["tts_speech"]).all() for c in chunks)
    prompt = eng._flow_stream_dev(eng.prompt_features([_wav(7, seconds=0.025)])[0])
    assert prompt.n_mel < prompt.n_p * eng.cfg.cfm.upsample


def test_stream_tts_with_st_zero_shot_and_sft(engines):
    _, eng = engines
    per_token = eng.cfg.cfm.upsample * eng.cfg.audio.hop_length
    outs = [j["tts_speech"] for j in eng.inference_tts_with_st(
        "streaming test text", "style", _wav(1), _wav(2), stream=True, max_seconds=2.0)]
    assert outs and all(c.ndim == 2 and c.shape[0] == 1 and c.shape[1] > 0 for c in outs)
    assert sum(c.shape[1] for c in outs) == eng.last_gen_len * per_token
    assert set(eng.last_timings) >= {"featurize", "prefill", "decode", "cfm", "vocoder", "ttfa"}
    outs = list(eng.inference_zero_shot("hello stream", "prompt", _wav(4), stream=True, max_seconds=2.0))
    assert outs and all(np.isfinite(c["tts_speech"]).all() for c in outs)
    eng.register_speaker("s1", _wav(5))
    outs = list(eng.inference_sft("sft stream", "s1", stream=True, max_seconds=2.0))
    assert outs and all(np.isfinite(c["tts_speech"]).all() for c in outs)


def test_stream_prompt_is_the_last_64_tokens_cached(engines):
    _, eng = engines
    feat = eng.prompt_features([_wav(8, seconds=8.0)])[0]
    assert len(feat.tokens) > tengine.STREAM_PROMPT_TOKENS
    p = eng._flow_stream_dev(feat)
    up = eng.cfg.cfm.upsample
    k0 = len(feat.tokens) - tengine.STREAM_PROMPT_TOKENS
    assert p.key[0] == 64 and p.n_p == 64
    np.testing.assert_array_equal(p.tokens[0].numpy(), feat.tokens[k0:])
    np.testing.assert_array_equal(p.mel[0, : p.n_mel].numpy(), feat.mel24[k0 * up:][: p.n_mel])
    assert eng._flow_stream_dev(feat) is p


# ----------------------------------------------------------------------- streamed == not streamed


def _record_decodes(monkeypatch):
    """Every decode loop the engine starts, its SpeechGen kept when it ends."""
    seen = []
    start = tlm.start_decode

    def recording(*a, **k):
        loop = start(*a, **k)

        def run():
            gen = yield from loop
            seen.append(gen)
            return gen

        return run()

    monkeypatch.setattr(tlm, "start_decode", recording)
    return seen


@pytest.mark.parametrize("int8", [True, False])
def test_streamed_tokens_equal_unstreamed(monkeypatch, int8):
    """One request, unstreamed and then streamed from the same generator
    state: the same tokens (the LM draws from a generator seeded by one draw
    of the engine's, the windows' noise from the engine's), and chunks that
    join to the wav's length. int8: the decode step (H = K, B=1); dense:
    the scanned decode. The engine's seed gives requests of several chunks
    on both LMs (on seeds 1 and 2 the int8 LM draws EOS within its first
    chunk, which would leave the later windows untested)."""
    cfg = tconfig.tiny_config()
    cfg.quantize_lm_int8 = int8
    eng = tengine.Engine(cfg, seed=4, device="cpu")
    assert (eng._mega_params is not None) == int8
    steps = []
    step = tlm.mega_decode_step
    monkeypatch.setattr(tlm, "mega_decode_step", lambda *a, **k: steps.append(1) or step(*a, **k))
    seen = _record_decodes(monkeypatch)
    feat = eng.prompt_features([_wav(9)])[0]
    state = eng.generator.get_state()
    wav = next(eng.inference_tts_with_st("one request, two ways", "style", feat, feat, max_seconds=2.0))
    n_unstreamed, n_steps = eng.last_gen_len, eng.last_decode_steps
    eng.generator.set_state(state)
    chunks = [c["tts_speech"] for c in eng.inference_tts_with_st(
        "one request, two ways", "style", feat, feat, stream=True, max_seconds=2.0)]
    assert len(seen) == 2
    np.testing.assert_array_equal(seen[0].tokens.numpy(), seen[1].tokens.numpy())
    assert n_unstreamed == eng.last_gen_len > _chunk(cfg) and n_steps == eng.last_decode_steps
    assert np.concatenate(chunks, axis=1).shape == wav["tts_speech"].shape
    assert len(chunks) == -(-n_unstreamed // _chunk(cfg))
    assert (len(steps) == 2 * n_steps > 0) if int8 else not steps


# ----------------------------------------------------------------------- seams against JAX


def test_stream_vc_matches_jax_chunk_by_chunk(engines):
    """Voice conversion streamed by both engines, each window of the port
    handed the noise of the JAX engine's key split for that window."""
    jeng, teng = engines
    cfg = teng.cfg
    up, M = cfg.cfm.upsample, cfg.cfm.n_mels
    src, prm = _wav(12, seconds=5.0, f=180.0), _wav(13, seconds=1.2, f=300.0)
    jeng.key = jax.random.PRNGKey(SEED + 17)
    want = [np.asarray(c["tts_speech"]) for c in jeng.inference_vc(src, prm, stream=True)]
    fp_w = teng._flow_stream_dev(teng.prompt_features([prm])[0]).key[0]
    W = fp_w + 2 * _chunk(cfg)
    key, noises = jax.random.PRNGKey(SEED + 17), []
    for _ in want:
        key, sub = jax.random.split(key)
        noises.append(np.asarray(jax.random.normal(sub, (1, W * up, M), jnp.float32)))
    got = [c["tts_speech"] for c in teng.inference_vc(src, prm, stream=True, cfm_noise=noises)]
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)
