"""The port's slice as a whole: one B=1 DB-served request through
``Engine.inference_tts_with_st`` against the JAX engine on the same weights,
plus the port's isolation and device rules.

Both LMs are forced greedy (the random streams of the two packages differ)
and the port is handed the CFM noise the JAX engine draws from its key. The
JAX engine takes its B=1 int8 route, the decode megakernel (in interpret
mode: on a CPU backend it would otherwise take the scanned decode), and the
generation bucket is pinned to 32 tokens: an untrained LM's logits are
near-tied, and after some tens of greedy steps two correct implementations
that sum in another order pick a different token. Run as a script, this
file prints where the greedy tokens first differ over a longer generation,
on this test's weights and on those of
``test_torch_kernels.py::test_generate_from_ids_greedy_matches_jax_scan``:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_engine.py 192

The wav is held to atol 1e-4: the LM tokens must agree exactly, and the CFM
and vocoder then run in f32 on both sides.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autostyle_tts_tpu.models.token_lm as jlm
import autostyle_tts_tpu_torch.models.token_lm as tlm
from autostyle_tts_tpu.ops.sampling import SamplerConfig as JSampler
from autostyle_tts_tpu.pipeline import engine as jengine
from autostyle_tts_tpu.retrieval import StyleStore as JStyleStore
from autostyle_tts_tpu.utils import config as jconfig
from autostyle_tts_tpu_torch.ops import decode_step as tdecode
from autostyle_tts_tpu_torch.ops.sampling import SamplerConfig
from autostyle_tts_tpu_torch.pipeline import engine as tengine
from autostyle_tts_tpu_torch.retrieval.store import StyleStore
from autostyle_tts_tpu_torch.utils import config as tconfig
from autostyle_tts_tpu_torch.weights import from_jax_tree, quantize_tree

REPO = Path(__file__).resolve().parent.parent
SEED = 3


def _cfg(mod):
    cfg = mod.tiny_config()
    cfg.quantize_lm_int8 = True
    cfg.quantize_lm_kv_int8 = False
    cfg.fetch_dtype = "float32"
    cfg.vocoder = dataclasses.replace(
        cfg.vocoder, kind="istft", istft_hop=cfg.audio.hop_length,
        istft_n_fft=4 * cfg.audio.hop_length, istft_channels=32, istft_blocks=2)
    return cfg


def _tree(cfg):
    tree = jax.tree_util.tree_map(
        np.asarray, jengine.EngineParams.init(jax.random.PRNGKey(0), cfg).tree())
    rng = np.random.default_rng(0)
    # the CFM's adaLN modulation and output projection start at zero; fill
    # them so that the flow solve is not the identity on its noise
    c = tree["cfm"]
    c["layers"]["mod"] = (rng.standard_normal(c["layers"]["mod"].shape) * 0.05).astype(np.float32)
    c["out_proj"] = (rng.standard_normal(c["out_proj"].shape) * 0.1).astype(np.float32)
    return tree


def _store(dim, n, spk_dim, n_mels, rng):
    """A style DB whose rows carry precomputed prompt artifacts."""
    s = JStyleStore(dim=dim, capacity=8)
    s.insert(rng.standard_normal((n, dim)).astype(np.float32),
             [{"file_id": f"s{i}", "text": f"style line {i}"} for i in range(n)])
    s.artifacts = {
        "speech_tokens": rng.integers(0, 64, (n, 40)).astype(np.int32),
        "speech_token_lens": np.asarray([23, 37, 12][:n], np.int64),
        "prompt_mel": (rng.standard_normal((n, 80, n_mels)) * 0.5).astype(np.float32),
        "prompt_mel_lens": np.asarray([46, 70, 24][:n], np.int64),
        "spk": rng.standard_normal((n, spk_dim)).astype(np.float32),
    }
    return s


def test_slice_matches_jax_engine(monkeypatch, tmp_path):
    jcfg, tcfg = _cfg(jconfig), _cfg(tconfig)
    tree = _tree(jcfg)
    monkeypatch.setattr(jlm, "generate_speech_from_ids", functools.partial(
        jlm.generate_speech_from_ids, sampler=JSampler(greedy=True)))
    monkeypatch.setattr(tlm, "generate_speech_from_ids", functools.partial(
        tlm.generate_speech_from_ids, sampler=SamplerConfig(greedy=True)))
    monkeypatch.setattr(jengine, "GEN_BUCKETS", (32,))
    monkeypatch.setattr(tengine, "GEN_BUCKETS", (32,))
    jeng = jengine.Engine(jcfg, params=jengine.EngineParams.from_tree(
        jax.tree_util.tree_map(jnp.asarray, tree)), seed=SEED)
    mega = jlm.mega_decode_params(jeng.params.token_lm, jcfg.token_lm)
    monkeypatch.setattr(jeng, "_fused_decode_params", lambda shape, max_new: mega)
    teng = tengine.Engine(tcfg, params=tengine.EngineParams.from_tree(
        from_jax_tree(tree, tcfg)), seed=SEED, device="cpu")

    rng = np.random.default_rng(1)
    js = _store(32, 3, tcfg.token_lm.spk_dim, tcfg.cfm.n_mels, rng)
    js.save(tmp_path / "db")
    ts = StyleStore.load(tmp_path / "db", device="cpu")
    query = rng.standard_normal((1, 32)).astype(np.float32)
    hit = ts.search(query, k=2)[0]
    assert [h.index for h in hit] == [h.index for h in js.search(query, k=2)[0]]
    sty_t, tim_t = teng.prompt_features_from_store(ts, [hit[0].index, hit[1].index])
    sty_j, tim_j = jeng.prompt_features_from_store(js, [hit[0].index, hit[1].index])

    text, style_text = "Hello there, this is a test.", hit[0].text
    want = next(jeng.inference_tts_with_st(text, style_text, sty_j, tim_j))["tts_speech"]

    # the CFM noise the JAX engine drew: key split order of _synthesize_one
    up, M = tcfg.cfm.upsample, tcfg.cfm.n_mels
    fp_w = tengine._bucket(len(tim_t.tokens), tengine.TOKEN_BUCKETS)
    max_new = 32
    key = jax.random.PRNGKey(SEED + 17)
    key, _key_lm = jax.random.split(key)
    key, key_cfm = jax.random.split(key)
    noise = np.asarray(jax.random.normal(key_cfm, (1, (fp_w + max_new) * up, M), jnp.float32))

    got = next(teng.inference_tts_with_st(text, style_text, sty_t, tim_t,
                                          cfm_noise=noise))["tts_speech"]
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[1] > 0 and got.shape[1] % (up * tcfg.audio.hop_length) == 0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert set(teng.last_timings) == {"prefill", "decode", "cfm", "vocoder"}


def test_prefill_and_decode_share_one_int8_copy():
    """The engine keeps one int8 copy of the LM: the prefill's projections
    are views of the decode kernel's output-major weights, equal to the
    input-major quantized weights they replace."""
    cfg = _cfg(tconfig)
    lm = quantize_tree(tlm.init_params(cfg.token_lm, torch.Generator().manual_seed(0)))
    mp = tlm.mega_decode_params(lm, cfg.token_lm)
    shared = tlm.share_decode_weights(lm, mp)
    pairs = [(shared["layers"][n], lm["layers"][n], mp[k])
             for n, k in (("wqkv", "wqkv"), ("wo", "wo"), ("w_gate_up", "wgu"), ("w_down", "wd"))]
    pairs.append((shared["speech_head"], lm["speech_head"], mp["head"]))
    for got, want, storage in pairs:
        assert torch.equal(got.q, want.q) and torch.equal(got.s, want.s)
        assert got.q.data_ptr() == storage.data_ptr()
    eng = tengine.Engine(cfg, device="cpu")
    layers = eng.params.token_lm["layers"]
    assert layers["wqkv"].q.data_ptr() == eng._mega_params["wqkv"].data_ptr()
    assert eng.params.token_lm["speech_head"].q.data_ptr() == eng._mega_params["head"].data_ptr()


@pytest.mark.parametrize("change,int4,kernel", [
    ({}, False, True),
    ({"ffn_dim": 144}, False, True),                              # a multiple of 16, not of 512
    ({"ffn_dim": 144}, True, False),                              # int4 loads take 32 elements
    ({"ffn_dim": 160}, True, True),                               # 32 mod 64: a half tile ends a row
    ({"speech_vocab_size": 8192}, True, True),                    # the sampler's widest vocabulary
    ({"n_kv_heads": 2}, False, False),                            # GQA
    ({"dim": 96, "n_heads": 2, "n_kv_heads": 2}, False, False),   # head width 48
    ({"speech_vocab_size": 9000}, False, False),                  # beyond the sampler's vocabulary
])
def test_engine_takes_the_decode_kernel_where_the_step_serves(change, int4, kernel):
    """An int8 LM gets the decode kernel's weights (and its B=1 requests
    the kernel) exactly where ``decode_step.step_serves`` says the kernel
    runs its widths at 8 bits; elsewhere it takes the scanned decode. Under
    ``quantize_lm_int4`` the weights are int4 where the step serves 4 bits
    (``kernel``) and stay int8 where it serves only 8, as in the
    reference."""
    cfg = _cfg(tconfig)
    cfg.token_lm = dataclasses.replace(cfg.token_lm, **change)
    cfg.quantize_lm_int4 = int4
    tl = cfg.token_lm

    def serves(bits):
        return tdecode.step_serves(dim=tl.dim, n_heads=tl.n_heads, n_kv_heads=tl.n_kv_heads,
                                   head_dim=tl.head_dim, ffn_dim=tl.ffn_dim, vocab=tl.speech_vocab_size,
                                   bits=bits)

    assert serves(4 if int4 else 8) == kernel
    eng = tengine.Engine(cfg, device="cpu")
    assert (eng._mega_params is not None) == serves(8)
    if serves(8):
        assert tdecode.weight_bits(eng._mega_params) == (4 if int4 and kernel else 8)


def test_int4_engine_falls_back_to_the_int8_decode_step(monkeypatch):
    """At widths the int4 step cannot take and the int8 one can (dim 80,
    H = K = 5, hd 16, F 160: int4 loads take multiples of 32), an engine
    with ``quantize_lm_int4`` builds int8 decode weights, and a B=1 greedy
    request runs the decode step (its plain version here), not the scanned
    decode."""
    cfg = _cfg(tconfig)
    cfg.quantize_lm_int4 = True
    cfg.token_lm = dataclasses.replace(cfg.token_lm, dim=80, n_heads=5, n_kv_heads=5, ffn_dim=160)
    tl = cfg.token_lm
    assert tl.head_dim == 16
    kw = dict(dim=80, n_heads=5, n_kv_heads=5, head_dim=16, ffn_dim=160, vocab=tl.speech_vocab_size)
    assert tdecode.step_serves(**kw, bits=8) and not tdecode.step_serves(**kw, bits=4)
    lm = tlm.init_params(tl, torch.Generator().manual_seed(0))
    params, mega = tengine._prepare_lm(lm, cfg)
    assert mega is not None and tdecode.weight_bits(mega) == 8
    assert params["layers"]["wqkv"].q.data_ptr() == mega["wqkv"].data_ptr()

    calls = []
    step = tlm.mega_decode_step
    monkeypatch.setattr(tlm, "mega_decode_step", lambda *a, **k: calls.append(1) or step(*a, **k))

    def no_scan(*a, **k):
        raise AssertionError("the int4 engine took the scanned decode")

    monkeypatch.setattr(tlm, "_decode_scan", no_scan)
    monkeypatch.setattr(tlm, "generate_speech_from_ids", functools.partial(
        tlm.generate_speech_from_ids, sampler=SamplerConfig(greedy=True)))
    monkeypatch.setattr(tengine, "GEN_BUCKETS", (32,))
    eng = tengine.Engine(cfg, device="cpu")
    assert tdecode.weight_bits(eng._mega_params) == 8
    f = tengine.PromptFeatures(tokens=np.arange(5, dtype=np.int32), spk=np.zeros(cfg.token_lm.spk_dim, np.float32),
                               mel24=np.zeros((10, cfg.cfm.n_mels), np.float32))
    wav = next(eng.inference_tts_with_st("hello", "style", f, f))["tts_speech"]
    assert wav.shape[1] > 0 and np.isfinite(wav).all()
    assert len(calls) == eng.last_decode_steps > 0


def test_engine_out_of_slice_paths_raise():
    """Nothing of the engine raises for being out of the port any more:
    speculative decoding (``tests/test_torch_spec_decode.py``), streaming, a
    batch, voice conversion, a dense LM, prompts from wavs and
    ``build_style_db`` (``tests/test_torch_rag.py``) are inside it."""
    cfg = _cfg(tconfig)
    eng = tengine.Engine(cfg, device="cpu")
    f = tengine.PromptFeatures(tokens=np.arange(5, dtype=np.int32),
                               spk=np.zeros(16, np.float32), mel24=np.zeros((10, 16), np.float32))
    for stream in (lambda: eng.inference_tts_with_st("a", "b", f, f, stream=True, max_seconds=1.0),
                   lambda: eng.inference_zero_shot("a", "b", f, stream=True, max_seconds=1.0),
                   lambda: eng.inference_vc(f, f, stream=True)):
        chunks = [c["tts_speech"] for c in stream()]
        assert chunks and all(c.shape[0] == 1 and np.isfinite(c).all() for c in chunks)
    # the dense LM (the decode kernel serves int8 only) takes the speculative decode
    spec = tengine.Engine(dataclasses.replace(cfg, speculative_gamma=2, quantize_lm_int8=False), device="cpu")
    wav = next(spec.inference_tts_with_st("a", "b", f, f, max_seconds=1.0))["tts_speech"]
    assert wav.shape[1] > 0 and np.isfinite(wav).all() and spec.last_spec["n_verify"] > 0
    feats = eng.prompt_features([np.zeros(1600, np.float32)])
    assert len(feats) == 1 and feats[0].spk.shape == (cfg.speaker.emb_dim,)
    with pytest.raises(ValueError, match="store has no precomputed"):
        eng.prompt_features_from_store(StyleStore(8, device="cpu"), [0])
    out = eng.synthesize_batch(["hi"], [""], [f], [f], max_seconds=1.0)
    assert len(out) == 1 and np.isfinite(out[0]).all()
    out = eng.synthesize_batch(["a", "bc"], ["", "x"], [f, f], [f, f], max_seconds=1.0)
    assert len(out) == 2 and all(np.isfinite(w).all() for w in out)
    dense = tengine.Engine(dataclasses.replace(cfg, quantize_lm_int8=False), device="cpu")
    assert dense._mega_params is None
    out = dense.synthesize_batch(["hi"], [""], [f], [f], max_seconds=1.0)
    assert len(out) == 1 and np.isfinite(out[0]).all()


def test_engine_without_cuda_requires_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tengine.Engine(_cfg(tconfig))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StyleStore(8)


def test_port_imports_no_jax():
    """The whole port, and chip_smoke.py, import neither jax nor anything
    of the JAX package; nor, at import time, ``transformers`` or
    ``safetensors``, which the machine with the card does not have."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import autostyle_tts_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'autostyle_tts_tpu', 'transformers', 'safetensors')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('autostyle_tts_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok") and int(r.stdout.split()[1]) >= 20


def first_greedy_difference(n: int):
    """First token index at which the port's greedy tokens differ from the
    JAX package's over ``n`` tokens (EOS masked throughout), as
    (index or None, n): on this file's engine setup against the JAX decode
    megakernel (interpret mode), and on the generate test's setup against
    the JAX scanned decode."""
    import pathlib
    import tempfile

    import test_torch_kernels as K
    from autostyle_tts_tpu_torch.utils.config import tiny_config

    def first(a, b):
        d = [i for i in range(min(len(a), len(b))) if a[i] != b[i]]
        return (d[0] if d else None), min(len(a), len(b))

    jcfg, tcfg = _cfg(jconfig), _cfg(tconfig)
    tree = _tree(jcfg)
    jeng = jengine.Engine(jcfg, params=jengine.EngineParams.from_tree(
        jax.tree_util.tree_map(jnp.asarray, tree)), seed=SEED)
    teng = tengine.Engine(tcfg, params=tengine.EngineParams.from_tree(
        from_jax_tree(tree, tcfg)), seed=SEED, device="cpu")
    rng = np.random.default_rng(1)
    js = _store(32, 3, tcfg.token_lm.spk_dim, tcfg.cfm.n_mels, rng)
    db = pathlib.Path(tempfile.mkdtemp()) / "db"
    js.save(db)
    ts = StyleStore.load(db, device="cpu")
    hit = ts.search(rng.standard_normal((1, 32)).astype(np.float32), k=2)[0]
    sty, tim = teng.prompt_features_from_store(ts, [hit[0].index, hit[1].index])
    seen = {}
    orig = tlm.generate_speech_from_ids

    def record(*a, **kw):
        kw.update(sampler=SamplerConfig(greedy=True), min_tokens=n)
        seen["args"] = a[2:7]
        out = orig(*a, **kw)
        seen["tokens"] = out.tokens[0].tolist()
        return out

    tlm.generate_speech_from_ids, tengine.GEN_BUCKETS = record, (n,)
    try:
        next(teng.inference_tts_with_st("Hello there, this is a test.", hit[0].text, sty, tim))
    finally:
        tlm.generate_speech_from_ids = orig
    want = jlm.generate_speech_from_ids(
        jeng.params.token_lm, jcfg.token_lm, *[jnp.asarray(x.numpy()) for x in seen["args"]],
        jax.random.PRNGKey(0), max_new_tokens=n, kv_int8=False, fused=True,
        decode_params=jlm.mega_decode_params(jeng.params.token_lm, jcfg.token_lm),
        sampler=JSampler(greedy=True), min_tokens=n)
    engine = first(np.asarray(want.tokens)[0].tolist(), seen["tokens"])

    lcfg, jp, tp = K._tiny_lm(3)
    r = np.random.default_rng(3)
    text = r.integers(16, 200, (1, 10)).astype(np.int32)
    sty_ids = r.integers(0, 64, (1, 6)).astype(np.int32)
    spk = r.standard_normal((1, lcfg.spk_dim)).astype(np.float32)
    want = jlm.generate_speech_from_ids(
        jp, lcfg, jnp.asarray(text), jnp.asarray([10]), jnp.asarray(sty_ids), jnp.asarray([6]),
        jnp.asarray(spk), jax.random.PRNGKey(0), max_new_tokens=n,
        sampler=JSampler(greedy=True), fused=False, min_tokens=n)
    lm_cfg = tiny_config().token_lm
    got = tlm.generate_speech_from_ids(
        tp, lm_cfg, torch.from_numpy(text), torch.tensor([10]), torch.from_numpy(sty_ids),
        torch.tensor([6]), torch.from_numpy(spk), None, max_new_tokens=n,
        decode_params=tlm.mega_decode_params(tp, lm_cfg), sampler=SamplerConfig(greedy=True),
        min_tokens=n)
    scan = first(np.asarray(want.tokens)[0].tolist(), got.tokens[0].tolist())
    return {"engine_vs_megakernel": engine, "generate_vs_scan": scan}


if __name__ == "__main__":
    jax.config.update("jax_default_matmul_precision", "highest")
    print(first_greedy_difference(int(sys.argv[1]) if len(sys.argv) > 1 else 192))
