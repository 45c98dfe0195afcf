"""The port's RAG layer against the JAX package's: the embedder service,
the style-DB build and dialog search, and the transformer pieces they add
(LoRA, the attention bias, ``embed_text``, ``generate``, the quantized
init, the top-p cap, the ft3b adapter).

Mirrors ``tests/test_rag.py`` (all of its tests), and
``tests/test_transformer.py::test_embed_text_mask_semantics``,
``tests/test_quant_pallas.py::test_embed_text_flash_matches_masked_sdpa``
and ``tests/test_bpe.py::test_embedder_truncation_counts_tokens``, with the
JAX side run as its own tests run it on the CPU (``flash_ok`` is false
there, so its prefill takes the masked attention; the port's flash wrapper
takes its plain version for a CPU tensor).

Tolerances: an f32 embedder (as ``tests/test_rag.py`` builds it) matches to
1e-5, LoRA and the attention bias included; a bf16 embedder to 2e-2 of the
largest |component| (XLA and torch round the bf16 activations after sums
taken in another order: a few bf16 ulps through two layers). Greedy
generations are equal token for token, EOS and lengths included. Sampled
biographies cannot be compared (the random streams differ): the DB build
and search are compared with the biography sampler set to greedy on both
sides, and the sampled law through ``transform_logits``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autostyle_tts_tpu.models import frontend
from autostyle_tts_tpu.models import transformer as jcore
from autostyle_tts_tpu.ops import sampling as jsampling
from autostyle_tts_tpu.pipeline import rag as jrag
from autostyle_tts_tpu.utils import config as jconfig
from autostyle_tts_tpu.utils.manifest import StyleSample as JStyleSample
from autostyle_tts_tpu_torch.models import transformer as tcore
from autostyle_tts_tpu_torch.ops import sampling as tsampling
from autostyle_tts_tpu_torch.pipeline import rag as trag
from autostyle_tts_tpu_torch.retrieval.store import StyleStore
from autostyle_tts_tpu_torch.utils import config as tconfig
from autostyle_tts_tpu_torch.utils.manifest import JsonDataReader, StyleSample, write_jsonl
from autostyle_tts_tpu_torch.weights import QTensor, _flat_keys, embedder_from_jax, load_lora, lora_from_jax

ATOL = 1e-5
CFG_KW = dict(vocab_size=frontend.VOCAB_SIZE, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
              ffn_dim=64, max_seq_len=1600, dtype="float32")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(dtype="float32", seed=0, **kw):
    jcfg = jconfig.TransformerConfig(**dict(CFG_KW, dtype=dtype))
    tcfg = tconfig.TransformerConfig(**dict(CFG_KW, dtype=dtype))
    jp = jcore.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, embedder_from_jax(_np(jp), tcfg)


@pytest.fixture(scope="module")
def services():
    """(JAX service, port service) on the same f32 weights."""
    jcfg, tcfg, jp, tp = _pair()
    return jrag.EmbedderService(jcfg, jp), trag.EmbedderService(tcfg, tp, device="cpu")


@pytest.fixture
def greedy_bios(monkeypatch):
    """Biographies drawn greedily on both sides (the random streams differ)."""
    for mod in (jsampling, tsampling):
        monkeypatch.setattr(mod.SamplerConfig, "biography", classmethod(lambda cls: cls(greedy=True)))


@pytest.fixture(scope="module")
def stores(services):
    """(port store, JAX store) of the same samples, biographies greedy."""
    jsvc, tsvc = services
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jsampling, tsampling):
            mp.setattr(mod.SamplerConfig, "biography", classmethod(lambda cls: cls(greedy=True)))
        return (trag.build_style_db(tsvc, _samples(StyleSample), capacity=64, batch=4),
                jrag.build_style_db(jsvc, _samples(JStyleSample), capacity=64, batch=4))


def _samples(cls):
    return [cls(speaker="w1", zh_text=f"utterance {i} about topic {i % 3}", file_id=f"denoise_{i}.wav")
            for i in range(6)] + \
           [cls(speaker="m1", zh_text=f"different voice line {i}", file_id=f"denoise_m{i}.wav")
            for i in range(4)]


# ----------------------------------------------------------------------- tests/test_rag.py


def test_embed_shape_and_determinism(services):
    jsvc, tsvc = services
    e1 = tsvc.embed(["hello world", "你好"])
    e2 = tsvc.embed(["hello world", "你好"])
    assert e1.shape == (2, 32) and e1.dtype == np.float32
    np.testing.assert_allclose(e1, e2, atol=1e-6)
    assert not np.allclose(e1[0], e1[1])
    np.testing.assert_allclose(e1, jsvc.embed(["hello world", "你好"]), atol=ATOL)


def test_combined_embedding_halves(services):
    jsvc, tsvc = services
    c = tsvc.combined_embedding(["happy"], ["a biography"])
    assert c.shape == (1, 64)
    np.testing.assert_allclose(c[0, :32], tsvc.embed(["happy"])[0], atol=ATOL)
    np.testing.assert_allclose(c[0, 32:], tsvc.embed(["a biography"])[0], atol=ATOL)
    np.testing.assert_allclose(c, jsvc.combined_embedding(["happy"], ["a biography"]), atol=ATOL)


def test_emotion_label_always_in_set(services):
    jsvc, tsvc = services
    texts = ["I am so glad!", "terrible news", "ok"]
    labels = tsvc.emotion_labels(texts)
    assert all(l in tsvc.labels or l == "neutral" for l in labels)
    assert len(labels) == 3
    assert labels == jsvc.emotion_labels(texts)
    # the raw greedy generations the labels were matched from, token for token
    want = jsvc._generate(texts, jrag.EMOTION_MAX_NEW, jsampling.SamplerConfig.label(), 512)
    assert tsvc._generate(texts, trag.EMOTION_MAX_NEW, tsampling.SamplerConfig.label(), 512) == want


def test_biography_batched(services, greedy_bios):
    jsvc, tsvc = services
    items = [("A: hi\nB: hello", "A"), ("A: x", "B")]
    bios = tsvc.biographies(items)
    assert len(bios) == 2
    assert all(isinstance(b, str) for b in bios)
    assert bios == jsvc.biographies(items)


def test_biography_sampled_law(services):
    """The service's own sampler (T=0.7, top-p 0.9) draws from its
    explicit generator: the same seed gives the same biographies."""
    _, tsvc = services
    state = tsvc.generator.get_state()
    a = tsvc.biographies([("A: hi", "A")])
    tsvc.generator.set_state(state)
    assert tsvc.biographies([("A: hi", "A")]) == a
    assert tsampling.SamplerConfig.biography() == tsampling.SamplerConfig(temperature=0.7, top_p=0.9)
    assert tsampling.SamplerConfig.label().greedy


def test_generate_kv_budget_chunking(services, monkeypatch):
    """A KV budget smaller than the batch makes _generate_ids chunk; greedy
    labels are the same as in one call."""
    _, tsvc = services
    texts = ["glad tidings", "terrible news", "fine", "angry words", "meh"]
    whole = tsvc.emotion_labels(texts)
    row = (tsvc.cfg.n_layers * (512 + trag.EMOTION_MAX_NEW + 1)
           * tsvc.cfg.n_kv_heads * tsvc.cfg.head_dim * 4)
    calls = []
    gen0 = tcore.generate
    monkeypatch.setattr(tcore, "generate", lambda *a, **k: calls.append(a[2].shape[0]) or gen0(*a, **k))
    monkeypatch.setattr(trag, "GEN_KV_BUDGET_BYTES", 2 * row)
    assert tsvc.emotion_labels(texts) == whole
    assert calls == [2, 2, 1]


def test_erc_chat_serving_mode(services):
    """Chat-format labelling gives valid labels, the same as the JAX
    service's; "auto" turns it on exactly when an adapter rides the byte
    frontend."""
    jsvc, tsvc = services
    texts = ["I am so glad!", "terrible news"]
    chat = trag.EmbedderService(tsvc.cfg, tsvc.params, erc_chat=True, device="cpu")
    labels = chat.emotion_labels(texts)
    assert len(labels) == 2
    assert all(l in chat.labels or l == "neutral" for l in labels)
    jchat = jrag.EmbedderService(jsvc.cfg, jsvc.params, erc_chat=True)
    assert labels == jchat.emotion_labels(texts)
    assert chat._erc_chat_labels_raw(texts) == jchat._erc_chat_labels_raw(texts)
    ctx, names = ["A: hi\n B: I am so glad!", ""], ["B", "C"]
    assert chat._erc_chat_labels_raw(texts, ctx, names) == jchat._erc_chat_labels_raw(texts, ctx, names)

    assert not tsvc.erc_chat  # no adapter: the plain prompt
    lora = tcore.init_lora(tsvc.cfg, 4, torch.Generator().manual_seed(1))
    tuned = trag.EmbedderService(tsvc.cfg, tsvc.params, lora=lora, lora_scale=1.0, device="cpu")
    assert tuned.erc_chat


def test_embed_budget_chunking(services, monkeypatch):
    """The same budget on the embed forward: chunked == whole-batch."""
    _, tsvc = services
    texts = [f"sample text number {i}" for i in range(5)]
    whole = tsvc.embed(texts)
    row = trag.EMBED_MAX_TOKENS * tsvc.cfg.dim * 2 * 8
    monkeypatch.setattr(trag, "GEN_KV_BUDGET_BYTES", 2 * row)
    np.testing.assert_allclose(tsvc.embed(texts), whole, atol=ATOL)


def test_build_style_db_and_verify(stores):
    store, jstore = stores
    assert len(store) == 10
    assert store.self_verify(sample=10)
    assert store.meta[0]["file_id"] == "denoise_0.wav"
    assert "emotion" in store.meta[0]
    assert store.meta == jstore.meta
    np.testing.assert_allclose(store.db[:10].numpy(), np.asarray(jstore.db[:10]), atol=ATOL)


def test_search_dialog_rows_and_prefix(services, stores, greedy_bios):
    (jsvc, tsvc), (store, jstore) = services, stores
    texts = [("utterance 1 about topic 1", "w1"), ("different voice line 2", "m1"), ("more from w1", "w1")]
    for window in (0, 2):
        rows = trag.search_dialog(tsvc, store, [trag.DialogTurn(*t) for t in texts],
                                  file_prefix_path="/data/styles", context_window=window, batch=2)
        want = jrag.search_dialog(jsvc, jstore, [jrag.DialogTurn(*t) for t in texts],
                                  file_prefix_path="/data/styles", context_window=window, batch=2)
        assert len(rows) == 3
        for r, w in zip(rows, want):
            assert r.retrieved_file_id.startswith("/data/styles/denoise_")
            assert 0.0 <= r.distance <= 1.0 + 1e-5
            assert r.retrieved_text
            fields = ("zh_text", "speaker", "retrieved_file_id", "retrieved_text", "retrieved_index")
            assert [getattr(r, f) for f in fields] == [getattr(w, f) for f in fields]
            assert abs(r.distance - w.distance) <= ATOL


def test_search_dialog_ablations_differ(services, stores, greedy_bios):
    (jsvc, tsvc), (store, jstore) = services, stores
    turns = [trag.DialogTurn("utterance 0 about topic 0", "w1")]
    full = trag.search_dialog(tsvc, store, turns)
    emo = trag.search_dialog(tsvc, store, turns, ablation="emotion_only")
    bio = trag.search_dialog(tsvc, store, turns, ablation="bio_only")
    # an ablated score is at most the full combined one (half the signal)
    assert emo[0].distance <= full[0].distance + 1e-5
    assert bio[0].distance <= full[0].distance + 1e-5
    jturns = [jrag.DialogTurn("utterance 0 about topic 0", "w1")]
    for got, ablation in ((full, None), (emo, "emotion_only"), (bio, "bio_only")):
        want = jrag.search_dialog(jsvc, jstore, jturns, ablation=ablation)
        assert got[0].retrieved_index == want[0].retrieved_index
        assert abs(got[0].distance - want[0].distance) <= ATOL


def test_search_dialog_round_trips_jsonl(tmp_path, services, stores):
    (_, tsvc), (store, _) = services, stores
    rows = trag.search_dialog(tsvc, store, [trag.DialogTurn("hello", "w1")])
    p = tmp_path / "search_results.jsonl"
    write_jsonl(p, (r.to_dict() for r in rows))
    back = JsonDataReader(p)
    assert back[0].retrieved_file_id == rows[0].retrieved_file_id
    assert back[0].retrieved_index == rows[0].retrieved_index >= 0
    with pytest.raises(IndexError):
        back[1]


# ----------------------------------------------------------------------- transformer pieces


def test_embed_text_mask_semantics(services):
    """Pad tokens do not move the pooled embedding."""
    _, tsvc = services
    m1 = torch.tensor([[1, 1, 1, 0, 0]])
    e1 = tcore.embed_text(tsvc.params, tsvc.cfg, torch.tensor([[4, 5, 6, 0, 0]]), m1)
    e2 = tcore.embed_text(tsvc.params, tsvc.cfg, torch.tensor([[4, 5, 6, 9, 9]]), m1)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), atol=ATOL)
    assert e1.shape == (1, tsvc.cfg.dim)


def test_embed_text_flash_matches_masked_sdpa():
    """The flash path (zero offsets on right-padded rows) equals the
    explicit prefix-mask path and the JAX function on every real row."""
    kw = dict(vocab_size=211, dim=128, n_layers=2, n_heads=2, n_kv_heads=1, ffn_dim=128,
              max_seq_len=256, dtype="float32")
    jcfg, tcfg = jconfig.TransformerConfig(**kw), tconfig.TransformerConfig(**kw)
    jp = jcore.init_params(jax.random.PRNGKey(0), jcfg)
    tp = embedder_from_jax(_np(jp), tcfg)
    rng = np.random.default_rng(2)
    B, T = 2, 128
    lens = np.asarray([T, 57])
    toks = np.zeros((B, T), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, kw["vocab_size"], n)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.int32)
    ref = tcore.embed_text(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(mask), prefix_mask=False)
    got = tcore.embed_text(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(mask), prefix_mask=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-4)
    want = jcore.embed_text(jp, jcfg, jnp.asarray(toks), jnp.asarray(mask), prefix_mask=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_embedder_truncation_counts_tokens():
    """With BPE the 512 truncation covers ~3x more text than with bytes."""
    from autostyle_tts_tpu_torch.models import bpe

    tok = bpe.BPETokenizer.load("vocab/bpe_en_2k.json")
    ecfg = dataclasses.replace(tconfig.tiny_config().embedder, vocab_size=bpe.VOCAB_SIZE)
    params = tcore.init_params(dataclasses.replace(ecfg, vocab_size=bpe.VOCAB_SIZE),
                               torch.Generator().manual_seed(0))
    svc = trag.EmbedderService(ecfg, params, tokenizer=tok, device="cpu")
    long_text = "the quick brown fox jumps over the lazy dog " * 40
    ids = svc._encode(long_text, 64)
    assert len(ids) == 64
    assert len(tok.decode_segment(ids)) > 2 * len(long_text[:64])
    assert svc.embed([long_text]).shape == (1, ecfg.dim)


def _lora_pair(jcfg, tcfg, r=4, seed=1):
    """A LoRA tree with a non-zero b (init_lora's starts at zero)."""
    jl = jcore.init_lora(jax.random.PRNGKey(seed), jcfg, r)
    rng = np.random.default_rng(seed)
    jl = {"layers": {k: (v + 0.05 * rng.standard_normal(v.shape).astype(np.float32)) if k.endswith("_b")
                     else v for k, v in _np(jl)["layers"].items()}}
    return jax.tree_util.tree_map(jnp.asarray, jl), lora_from_jax(jl, tcfg, r)


def _with_bias(jp, tcfg, seed=3):
    qkv = (tcfg.n_heads + 2 * tcfg.n_kv_heads) * tcfg.head_dim
    b = 0.1 * np.random.default_rng(seed).standard_normal((tcfg.n_layers, qkv)).astype(np.float32)
    jp = dict(jp, layers=dict(jp["layers"], bqkv=jnp.asarray(b)))
    return jp, embedder_from_jax(_np(jp), tcfg)


def test_lora_and_bias_match_jax():
    """A LoRA adapter with a non-zero b and the Qwen2 attention bias: the
    embedding and the last-position logits as the JAX core's (f32)."""
    jcfg, tcfg, jp, _ = _pair()
    jp, tp = _with_bias(jp, tcfg)
    jl, tl = _lora_pair(jcfg, tcfg)
    toks = np.random.default_rng(4).integers(1, 200, (2, 24)).astype(np.int32)
    mask = np.ones_like(toks)
    mask[1, 15:] = 0
    want = jcore.embed_text(jp, jcfg, jnp.asarray(toks), jnp.asarray(mask), lora=jl, lora_scale=2.0)
    got = tcore.embed_text(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(mask), lora=tl, lora_scale=2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    base = tcore.embed_text(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(mask))
    assert float((got - base).abs().max()) > 1e-3           # the adapter and bias do act
    jlog = jcore.forward(jp, jcfg, jnp.asarray(toks), lora=jl, lora_scale=2.0).logits[:, -1]
    hid = tcore.forward(tp, tcfg, torch.from_numpy(toks), offset=torch.zeros(2, dtype=torch.int32),
                        lora=tl, lora_scale=2.0)
    tlog = tcore.matmul_any(hid[:, -1], tp["lm_head"])
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)


def test_bf16_embed_matches_jax():
    """A bf16 embedder with an int8 base and an adapter: within 2e-2 of the
    largest |component| (bf16 activations rounded after sums in another
    order)."""
    jcfg, tcfg, jp, _ = _pair(dtype="bfloat16")
    from autostyle_tts_tpu.ops.quant import quantize_tree as jquantize

    jq = jquantize(jp)
    tq = embedder_from_jax(_np(jq), tcfg)
    assert isinstance(tq["layers"]["wqkv"], QTensor)
    jl, tl = _lora_pair(jcfg, tcfg)
    texts = ["hello world", "a longer line of text to embed", "你好"]
    want = jrag.EmbedderService(jcfg, jq, lora=jl, lora_scale=4.0).embed(texts, width=64)
    got = trag.EmbedderService(tcfg, tq, lora=tl, lora_scale=4.0, device="cpu").embed(texts, width=64)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_generate_greedy_matches_jax_with_eos():
    """Greedy generate with a LoRA adapter, left-padded prompts and an EOS
    that row 0 draws: the same tokens (pad after EOS) and lengths."""
    jcfg, tcfg, jp, tp = _pair()
    jl, tl = _lora_pair(jcfg, tcfg)
    seqs = [np.arange(3, 20), np.arange(40, 48), np.asarray([7, 9, 11, 13, 15, 17, 19, 21, 23, 25, 27, 29])]
    toks, lens = jcore.left_pad(seqs, pad_id=0, width=24)
    t2, l2 = tcore.left_pad(seqs, pad_id=0, width=24)
    np.testing.assert_array_equal(toks, t2)
    np.testing.assert_array_equal(lens, l2)
    greedy = dict(max_new_tokens=12, pad_id=0)

    def run_jax(eos):
        r = jcore.generate(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens), jcore.make_cache(jcfg, 3, 37),
                           jax.random.PRNGKey(0), sampler=jsampling.SamplerConfig(greedy=True), eos_id=eos,
                           lora=jl, lora_scale=2.0, **greedy)
        return np.asarray(r.tokens), np.asarray(r.lengths)

    first, _ = run_jax(eos=-1)
    eos = int(first[0, 4])
    want_t, want_l = run_jax(eos)
    r = tcore.generate(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(lens),
                       tcore.make_cache(tcfg, 3, 37, "cpu"), torch.Generator().manual_seed(0),
                       sampler=tsampling.SamplerConfig(greedy=True), eos_id=eos, lora=tl, lora_scale=2.0,
                       **greedy)
    np.testing.assert_array_equal(r.tokens.numpy(), want_t)
    np.testing.assert_array_equal(r.lengths.numpy(), want_l)
    assert int(want_l[0]) <= 4 and (want_t[0, int(want_l[0]) + 1:] == 0).all()


@pytest.mark.parametrize("flat", [False, True])
def test_transform_logits_top_p_cap(flat):
    """The biography sampler (T=0.7, top-p 0.9) on a 1000-token vocabulary
    with the 256-logit cap: a peaked row whose nucleus fits the cap, and a
    flat one whose nucleus does not (the whole call takes the full sort)."""
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((3, 1000)) * (0.05 if flat else 6.0)).astype(np.float32)
    want = np.asarray(jsampling.transform_logits(jnp.asarray(logits), jsampling.SamplerConfig.biography()))
    got = tsampling.transform_logits(torch.from_numpy(logits), tsampling.SamplerConfig.biography()).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_allclose(np.where(want > -1e29, got, 0), np.where(want > -1e29, want, 0), rtol=1e-6)
    kept = (want > -1e29).sum(-1)
    assert (kept.max() > 256) if flat else (kept.max() < 256)


def test_ft3b_adapter_loads():
    """``artifacts/ft3b/adapter_f16.npz`` loads into the shape of
    ``init_lora(llama32_3b_config(), 32)`` in f32 (shapes only: no 3B base
    is built here)."""
    jshape = jax.eval_shape(lambda: jcore.init_lora(jax.random.PRNGKey(0), jconfig.llama32_3b_config(), 32))
    lora = load_lora("artifacts/ft3b/adapter_f16.npz", tconfig.llama32_3b_config(), 32)
    assert {k: tuple(v.shape) for k, v in lora["layers"].items()} == \
           {k: tuple(v.shape) for k, v in jshape["layers"].items()}
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v).all()) for v in lora["layers"].values())
    assert float(lora["layers"]["wqkv_lora_b"].abs().max()) > 0     # trained: b moved from zero
    assert sum(v.numel() for v in lora["layers"].values()) == 40_370_176


def test_init_params_quantized_matches_jax_structure():
    """The same flat keys, shapes and dtypes as the JAX builder at tiny
    geometry (int8 projections and lm_head with f32 scales, f32 embedding)."""
    ecfg_j, ecfg_t = jconfig.tiny_config().embedder, tconfig.tiny_config().embedder
    want = _flat_keys(embedder_from_jax(_np(jcore.init_params_quantized(jax.random.PRNGKey(0), ecfg_j)), ecfg_t))
    got = _flat_keys(tcore.init_params_quantized(ecfg_t, torch.Generator().manual_seed(0)))
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == \
           {k: (tuple(v.shape), v.dtype) for k, v in want.items()}
    assert got["layers/wqkv/q"].dtype == torch.int8 and got["tok_emb"].dtype == torch.float32
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tcore.init_params_quantized(ecfg_t, torch.Generator().manual_seed(0), bits=4)


def test_store_drop_and_self_verify():
    """``self_verify`` finds each row as its own top hit, ties allowed, and
    fails on a row that another row outscores; ``drop`` empties the store
    and its artifacts."""
    store = StyleStore(4, capacity=8, device="cpu")
    store.insert(np.asarray([[1, 0, 0, 0], [1, 0, 0, 0], [0, 1, 0, 0]], np.float32),
                 [{"file_id": f"f{i}"} for i in range(3)])
    assert store.self_verify() and store.self_verify(sample=1)
    store.db[2] = torch.tensor([0.0, 0.0, 0.0, 0.0])       # a corrupted row matches nothing
    assert not store.self_verify()
    store.artifacts = {"spk": np.zeros((3, 2), np.float32)}
    store.drop()
    assert len(store) == 0 and store.artifacts == {} and not bool(store.valid.any())
    assert store.self_verify()
