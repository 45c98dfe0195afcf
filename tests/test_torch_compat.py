"""The port's CosyVoice compat stack against the JAX package's
(``tests/test_cosy_compat.py``, ``tests/test_convert.py``), on the CPU, on
one synthetic release directory at ``SynthGeometry()`` built by the port's
``utils/synth_release.py`` in the upstream key names.

Tolerances (f32 on both sides):
- the converted trees of both packages are bitwise equal, artifact by
  artifact;
- the encoders, the prefix, the KV-cache decode, the U-Net estimator, the
  token encoder with the length regulator, the CFM solve (JAX's ``x0``
  injected) and the S3 tokenizer match within 1e-5 (absolute, plus 1e-5 of
  the value); its tokens are equal;
- HiFT with the JAX draws injected (initial phases and noise) within 1e-5
  (measured 1.8e-7) at 12 frames (3,072 samples at this geometry), short
  on purpose: the source's phase is an f32 cumulative sum over every
  sample, which XLA and PyTorch add in different orders, and ``sin``
  carries the drift into the waveform as outputs grow;
- greedy ``cosy_llm.generate`` tokens equal JAX's, but where the two
  packages round an f32 top-2 near-tie (gap below 1e-4) differently;
- the x-vector of a wav through ``CosyEngine`` within 1e-4 (the fbank's
  own bounds are in ``tests/test_torch_onnx_exec.py``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autostyle_tts_tpu.models.compat import cosy_llm as jllm
from autostyle_tts_tpu.models.compat import hift as jhift
from autostyle_tts_tpu.models.compat import matcha_unet as junet
from autostyle_tts_tpu.models.compat import s3_tokenizer as js3
from autostyle_tts_tpu.models.compat import wenet_conformer as jwc
from autostyle_tts_tpu.models.compat.engine import CosyEngine as JCosyEngine
from autostyle_tts_tpu.ops.conv import conv1d as jconv1d
from autostyle_tts_tpu.ops.sampling import SamplerConfig as JSamplerConfig
from autostyle_tts_tpu.utils import cosyvoice_convert as jcc
from autostyle_tts_tpu_torch.models.compat import cosy_llm, hift, matcha_unet, s3_tokenizer
from autostyle_tts_tpu_torch.models.compat import wenet_conformer as wc
from autostyle_tts_tpu_torch.models.compat.engine import CosyEngine, load_snapshot, save_snapshot
from autostyle_tts_tpu_torch.ops.conv import conv1d
from autostyle_tts_tpu_torch.ops.sampling import SamplerConfig
from autostyle_tts_tpu_torch.utils import cosyvoice_convert as cc
from autostyle_tts_tpu_torch.utils.synth_release import SynthGeometry, build_release_dir
from autostyle_tts_tpu_torch.weights import compat_trees_to_torch
from torch_one_thread import one_thread  # noqa: F401

GEO = SynthGeometry()
ATOL = RTOL = 1e-5
HIFT_ATOL = 1e-5
NEAR_TIE = 1e-4
RULE_ARTIFACTS = ("llm.pt", "flow.pt", "hift.pt", "speech_tokenizer_v1.onnx")


@pytest.fixture(scope="module")
def release_dir(tmp_path_factory):
    torch.manual_seed(0)     # the weight-norm gains draw from the global stream
    return build_release_dir(tmp_path_factory.mktemp("cosy_release"), GEO)


@pytest.fixture(scope="module")
def converted(release_dir):
    """{artifact: (port numpy tree, JAX numpy tree)}."""
    out = {}
    for artifact in RULE_ARTIFACTS:
        tree, report = cc.apply_rules(cc.load_artifact(release_dir / artifact), cc.RULESETS[artifact])
        jtree, jreport = jcc.apply_rules(jcc.load_artifact(release_dir / artifact), jcc.RULESETS[artifact])
        assert report.unmapped_src == [] and report.__dict__ == jreport.__dict__, artifact
        out[artifact] = (tree, jtree)
    return out


@pytest.fixture(scope="module")
def trees(converted):
    """{artifact: (port tensor tree, JAX array tree)}."""
    port = compat_trees_to_torch({a: t for a, (t, _) in converted.items()}, "cpu")
    return {a: (port[a], jax.tree.map(jnp.asarray, jt)) for a, (_, jt) in converted.items()}


def close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ conversion


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, p)
        else:
            yield p, v


def test_synthetic_release_bytes_equal_jax(tmp_path):
    """Both packages' builders write the same bytes from the same seeds."""
    from autostyle_tts_tpu.utils.synth_release import build_release_dir as jbuild

    torch.manual_seed(0)
    a = build_release_dir(tmp_path / "port", GEO)
    torch.manual_seed(0)
    b = jbuild(tmp_path / "jax", GEO)
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir()) and len(names) == 5
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


@pytest.mark.parametrize("artifact", RULE_ARTIFACTS)
def test_converted_trees_bitwise_equal(converted, artifact):
    tree, jtree = converted[artifact]
    got, want = dict(_leaves(tree)), dict(_leaves(jtree))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_inventory_matches_jax(release_dir):
    assert cc.inventory(release_dir) == jcc.inventory(release_dir)


# ------------------------------------------------------------------ conv padding


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["SAME", (1, 1), "half"])
@pytest.mark.parametrize("T", [11, 12])
def test_conv1d_padding_matches_jax(stride, padding, T):
    """``padding=`` (1, 1), (s//2, s//2) and SAME against the JAX conv1d."""
    k = 3 if padding != "half" else 2 * stride
    pad = (stride // 2, stride // 2) if padding == "half" else padding
    x, w, b = rand(0, 2, T, 5), rand(1, k, 5, 4), rand(2, 4)
    want = jconv1d(jnp.asarray(x), {"w": jnp.asarray(w), "b": jnp.asarray(b)}, stride=stride, padding=pad)
    got = conv1d(torch.from_numpy(x), {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, stride=stride,
                 padding=pad)
    assert tuple(got.shape) == want.shape
    close(got, want)


# ------------------------------------------------------------------ encoders and the LM


@pytest.mark.parametrize("which", ["text_encoder", "llm_causal", "flow_encoder"])
def test_apply_encoder_matches_jax(trees, which):
    art, enc = ("flow.pt", "encoder") if which == "flow_encoder" else ("llm.pt", which.split("_causal")[0])
    tree, jtree = trees[art]
    in_dim = int(tree[enc]["in_proj"]["w"].shape[0])
    cfg = cosy_llm._enc_config(tree[enc], in_dim, "relu" if enc == "llm" else "silu")
    jcfg = jllm._enc_config(jtree[enc], in_dim, "relu" if enc == "llm" else "silu")
    assert cfg.__dict__ == jcfg.__dict__
    x = rand(3, 2, 7, in_dim)
    mask = np.array([[1] * 7, [1] * 5 + [0] * 2], np.float32)
    causal = which == "llm_causal"
    got = wc.apply_encoder(tree[enc], cfg, torch.from_numpy(x), torch.from_numpy(mask), causal=causal)
    want = jwc.apply_encoder(jtree[enc], jcfg, jnp.asarray(x), jnp.asarray(mask), causal=causal)
    close(got, want)


def _prefix_inputs():
    text = np.array([[3, 5, 7, 2], [1, 9, 0, 0]], np.int32)
    prompt = np.array([[1, 4, 2], [6, 0, 0]], np.int32)
    spk = rand(4, 2, GEO.spk_dim, scale=0.3)
    return text, np.array([4, 2], np.int32), prompt, np.array([3, 1], np.int32), spk


def test_build_prefix_matches_jax(trees):
    tree, jtree = trees["llm.pt"]
    cfg, jcfg = cosy_llm.infer_config(tree), jllm.infer_config(jtree)
    args = _prefix_inputs()
    emb, mask, lens = cosy_llm.build_prefix(tree, cfg, *map(torch.from_numpy, args))
    jemb, jmask, jlens = jllm.build_prefix(jtree, jcfg, *map(jnp.asarray, args))
    close(emb, jemb)
    close(mask, jmask)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))


def test_prefill_and_decode_step_match_jax(trees):
    """The cached prefill and three decode steps (B=1-style positions)."""
    tree, jtree = trees["llm.pt"]
    cfg, jcfg = cosy_llm.infer_config(tree), jllm.infer_config(jtree)
    args = _prefix_inputs()
    emb, mask, lens = cosy_llm.build_prefix(tree, cfg, *map(torch.from_numpy, args))
    jemb, jmask, jlens = jllm.build_prefix(jtree, jcfg, *map(jnp.asarray, args))
    s_max = emb.shape[1] + 4
    h, cache = wc.prefill(tree["llm"], cfg.llm, emb, mask, s_max)
    jh, jcache = jwc.prefill(jtree["llm"], jcfg.llm, jemb, jmask, s_max)
    close(h, jh)
    close(cache["k"], jcache["k"])
    pe = wc.relpos_table(torch.arange(cfg.llm.max_rel), cfg.llm.dim)
    jpe = jwc.relpos_table(jnp.arange(jcfg.llm.max_rel), jcfg.llm.dim)
    close(pe, jpe)
    for i in range(3):
        x_t = rand(10 + i, 2, cfg.llm_dim)
        pos = int(lens[0]) + i
        h, cache = wc.decode_step(tree["llm"], cfg.llm, cache, torch.from_numpy(x_t), pos, lens + i + 1, pe)
        jh, jcache = jwc.decode_step(jtree["llm"], jcfg.llm, jcache, jnp.asarray(x_t), jnp.int32(pos),
                                     jlens + i + 1, jpe)
        close(h, jh)
    close(cache["v"], jcache["v"])


def _full_pass_logits(tree, cfg, args, toks):
    """Head logits of one causal pass over [prefix | toks]: ``prefill``
    over the whole sequence, the batch path the decode loop's KV cache
    must reproduce (like the decode, without the trunk's after_norm,
    which ``apply_encoder`` applies)."""
    emb, _, lens = cosy_llm.build_prefix(tree, cfg, *map(torch.from_numpy, args))
    full = torch.cat([emb[:, : int(lens[0])], tree["speech_embedding"][torch.from_numpy(toks).long()][None]], 1)
    h, _ = wc.prefill(tree["llm"], cfg.llm, full, torch.ones(full.shape[:2]), full.shape[1])
    return (h @ tree["llm_decoder"]["w"] + tree["llm_decoder"]["b"])[0], int(lens[0]) - 1


@pytest.mark.parametrize("text,prompt", [([3, 5, 7, 2], [1, 4, 2]), ([11, 2, 30, 8, 8, 1], [7]),
                                         ([0, 39, 5], [19, 18, 0, 3, 3])])
def test_greedy_generate_matches_jax_and_full_pass(trees, text, prompt):
    """Greedy tokens equal JAX's (but at an f32 near-tie), and each equals
    the argmax of the port's own full causal pass over [prefix | tokens]."""
    tree, jtree = trees["llm.pt"]
    cfg, jcfg = cosy_llm.infer_config(tree), jllm.infer_config(jtree)
    spk = rand(5, 1, GEO.spk_dim, scale=0.3)
    args = (np.array([text], np.int32), np.array([len(text)], np.int32), np.array([prompt], np.int32),
            np.array([len(prompt)], np.int32), spk)
    n_new = 12
    gen = cosy_llm.generate(tree, cfg, *map(torch.from_numpy, args), max_new_tokens=n_new,
                            sampler=SamplerConfig(greedy=True))
    jgen = jllm.generate(jtree, jcfg, *map(jnp.asarray, args), jax.random.PRNGKey(0), max_new_tokens=n_new,
                         sampler=JSamplerConfig(greedy=True))
    n = int(gen.lengths[0])
    toks = gen.tokens[0].numpy()
    assert (toks[n:] == cfg.speech_vocab).all()
    logits, start = _full_pass_logits(tree, cfg, args, toks[:n])
    for i in range(min(n + 1, n_new)):
        want = int(torch.argmax(logits[start + i]))
        assert want == int(toks[i]) if i < n else want >= cfg.speech_vocab, (i, want, toks[i])
    jtoks = np.asarray(jgen.tokens[0])
    for i in range(n_new):
        if jtoks[i] != toks[i]:
            top2 = torch.topk(logits[start + i], 2).values
            assert float(top2[0] - top2[1]) < NEAR_TIE, (i, toks, jtoks)
            break
    else:
        assert n == int(jgen.lengths[0])


def test_sampled_generate_draws_from_the_generator(trees):
    """Top-k sampling: the same generator state gives the same tokens, and
    a tiny vocabulary turns the top-25 default off (as in JAX)."""
    tree, _ = trees["llm.pt"]
    cfg = cosy_llm.infer_config(tree)
    args = [torch.from_numpy(a) for a in _prefix_inputs()]
    args = [a[:1] for a in args]
    a = cosy_llm.generate(tree, cfg, *args, torch.Generator().manual_seed(3), max_new_tokens=8)
    b = cosy_llm.generate(tree, cfg, *args, torch.Generator().manual_seed(3), max_new_tokens=8)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.lengths, b.lengths)
    assert int(a.tokens.max()) <= cfg.speech_vocab


# ------------------------------------------------------------------ flow


def test_estimator_matches_jax(trees):
    tree, jtree = trees["flow.pt"]
    cfg = matcha_unet.MatchaFlowConfig(n_mels=GEO.n_mels, n_heads=2, n_steps=2)
    jcfg = junet.MatchaFlowConfig(n_mels=GEO.n_mels, n_heads=2, n_steps=2)
    B, T, M = 2, 12, GEO.n_mels
    x, mu, cond, spk = rand(6, B, T, M), rand(7, B, T, M), rand(8, B, T, M), rand(9, B, M)
    mask = np.ones((B, T), np.float32)
    mask[1, 9:] = 0
    t = np.array([0.1, 0.7], np.float32)
    args = (x, mask, mu, t, spk, cond)
    got = matcha_unet.estimator_apply(tree["estimator"], cfg, *map(torch.from_numpy, args))
    want = junet.estimator_apply(jtree["estimator"], jcfg, *map(jnp.asarray, args))
    close(got, want)


@pytest.mark.parametrize("n_in,n_out", [(6, 12), (7, 7), (12, 5), (5, 13)])
def test_linear_resize_matches_jax_image_resize(n_in, n_out):
    h = rand(10, 2, n_in, 3)
    got = matcha_unet._resize_linear(torch.from_numpy(h), n_out)
    want = jax.image.resize(jnp.asarray(h), (2, n_out, 3), method="linear")
    close(got, want)


def test_encode_tokens_matches_jax(trees):
    tree, jtree = trees["flow.pt"]
    enc = cosy_llm._enc_config(tree["encoder"], GEO.flow_emb, "silu")
    jenc = jllm._enc_config(jtree["encoder"], GEO.flow_emb, "silu")
    tokens = np.array([[1, 2, 3, 4, 5, 6]], np.int32)
    mask = np.ones((1, 6), np.float32)
    got = matcha_unet.encode_tokens(tree, enc, torch.from_numpy(tokens), torch.from_numpy(mask), 12)
    want = junet.encode_tokens(jtree, jenc, jnp.asarray(tokens), jnp.asarray(mask), 12)
    close(got, want)


def test_solve_matches_jax_with_its_noise(trees):
    tree, jtree = trees["flow.pt"]
    cfg = matcha_unet.MatchaFlowConfig(n_mels=GEO.n_mels, n_heads=2, n_steps=3)
    jcfg = junet.MatchaFlowConfig(n_mels=GEO.n_mels, n_heads=2, n_steps=3)
    B, Fr, M = 1, 12, GEO.n_mels
    mu, cond, spk = rand(11, B, Fr, M), rand(12, B, Fr, M, scale=0.1), rand(13, B, GEO.spk_dim)
    mask = np.r_[np.ones(10), np.zeros(2)][None].astype(np.float32)
    key = jax.random.PRNGKey(7)
    x0 = np.asarray(jax.random.normal(key, (B, Fr, M), jnp.float32))     # the draw inside junet.solve
    want = junet.solve(jtree, jcfg, key, jnp.asarray(mu), jnp.asarray(spk), jnp.asarray(cond), jnp.asarray(mask))
    got = matcha_unet.solve(tree, cfg, torch.from_numpy(mu), torch.from_numpy(spk), torch.from_numpy(cond),
                            torch.from_numpy(mask), x0=torch.tensor(x0))
    close(got, want)
    assert float(got[0, 10:].abs().max()) == 0.0


# ------------------------------------------------------------------ HiFT and the tokenizer


def test_hift_matches_jax_with_its_draws(trees):
    tree, jtree = trees["hift.pt"]
    cfg, jcfg = hift.infer_config(tree, n_mels=GEO.n_mels), jhift.infer_config(jtree, n_mels=GEO.n_mels)
    assert cfg == hift.HiFTConfig(**jcfg.__dict__)
    Fr = 12
    mel = rand(14, 1, Fr, GEO.n_mels, scale=0.1)
    key = jax.random.PRNGKey(3)
    # the draws inside jhift.harmonic_source
    H, T = jcfg.nb_harmonics + 1, Fr * jcfg.samples_per_frame
    k1, k2 = jax.random.split(key)
    init = np.asarray(jax.random.uniform(k1, (1, 1, H)) * 2 * jnp.pi)
    noise = np.asarray(jax.random.normal(k2, (1, T, H)))
    want = jhift.apply(jtree, jcfg, jnp.asarray(mel), key)
    got = hift.apply(tree, cfg, torch.from_numpy(mel), init_phase=torch.tensor(init), noise=torch.tensor(noise))
    assert tuple(got.shape) == (1, Fr * cfg.samples_per_frame)
    close(got, want, atol=HIFT_ATOL, rtol=0)


def test_s3_tokenizer_encode_matches_jax(trees):
    tree, jtree = trees["speech_tokenizer_v1.onnx"]
    cfg, jcfg = s3_tokenizer.infer_config(tree, n_heads=2), js3.infer_config(jtree, n_heads=2)
    mel = rand(15, 2, 12, GEO.n_mels)
    mask = np.ones((2, 12), np.float32)
    mask[1, 10:] = 0
    toks, tmask = s3_tokenizer.encode(tree, cfg, torch.from_numpy(mel), torch.from_numpy(mask))
    jtoks, jtmask = js3.encode(jtree, jcfg, jnp.asarray(mel), jnp.asarray(mask))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    close(tmask, jtmask)


# ------------------------------------------------------------------ end to end


def _convert(main, release_dir, out_dir, extra=()):
    snap, report = out_dir / "engine.npz", out_dir / "report.json"
    main(["--model_dir", str(release_dir), "--strict", "--report_json", str(report), "--output", str(snap),
          *extra])
    return snap, json.loads(report.read_text())


@pytest.fixture(scope="module")
def snapshots(release_dir, tmp_path_factory):
    """``convert_cosyvoice --strict --output`` of both packages."""
    from autostyle_tts_tpu.cli.convert_cosyvoice import main as jmain
    from autostyle_tts_tpu_torch.cli.convert_cosyvoice import main

    port = _convert(main, release_dir, tmp_path_factory.mktemp("port_snap"), ["--device", "cpu"])
    jax_ = _convert(jmain, release_dir, tmp_path_factory.mktemp("jax_snap"))
    return port, jax_


def test_convert_cli_strict_on_both_packages(snapshots):
    (snap, rep), (jsnap, jrep) = snapshots
    assert rep == jrep
    for artifact in RULE_ARTIFACTS:
        assert rep[artifact]["unmapped_src"] == [] and rep[artifact]["unfilled_dst"] == []
    assert rep["campplus.onnx"]["mode"] == "graph-executed" and rep["campplus.onnx"]["unsupported_ops"] == []
    a, b = np.load(snap), np.load(jsnap)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshot_loads_in_the_other_package(snapshots, tmp_path, writer):
    """A port snapshot loads into the JAX CosyEngine and a JAX one into the
    port's; the trees read back equal."""
    (snap, _), (jsnap, _) = snapshots
    if writer == "port":
        jeng = JCosyEngine.load(snap, n_steps=2)
        assert jeng.llm_cfg.speech_vocab == GEO.speech_vocab and jeng.campplus is not None
        back = load_snapshot(snap)
    else:
        eng = CosyEngine.load(jsnap, n_steps=2, device="cpu")
        assert eng.llm_cfg.speech_vocab == GEO.speech_vocab and eng.campplus is not None
        save_snapshot(tmp_path / "again.npz", load_snapshot(jsnap))
        back = load_snapshot(tmp_path / "again.npz")
    src = load_snapshot(jsnap if writer == "jax" else snap)
    assert sorted(dict(_leaves(back))) == sorted(dict(_leaves(src)))


@pytest.fixture(scope="module")
def engines(snapshots):
    (snap, _), (jsnap, _) = snapshots
    return CosyEngine.load(snap, n_steps=2, device="cpu"), JCosyEngine.load(jsnap, n_steps=2)


def _wav(n=8000, f=180.0):
    """A voiced-like prompt: a modulated tone over a noise floor (every
    fbank bin carries power; see tests/test_torch_onnx_exec.py for the
    lowest bins of a pure tone)."""
    t = np.arange(n) / 16000
    noise = np.random.default_rng(int(f)).standard_normal(n)
    return (0.3 * np.sin(2 * np.pi * f * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t)) + 0.05 * noise).astype(np.float32)


def test_engine_tokenize_and_xvector_match_jax(engines):
    eng, jeng = engines
    wav = _wav()
    np.testing.assert_array_equal(eng.tokenize_wav16(wav), jeng.tokenize_wav16(wav))
    close(eng.embed_speaker_wav16(wav), jeng.embed_speaker_wav16(wav), atol=1e-4, rtol=1e-4)
    close(eng.embed_speaker_wav16(wav, bucket=True), jeng.embed_speaker_wav16(wav, bucket=True),
          atol=1e-4, rtol=1e-4)
    assert set(eng.last_timings) == {"tokenize", "xvector"}


def test_engine_synthesizes_from_pretokenized_and_wav_prompts(engines):
    """Both entry points, pre-tokenized and from a wav: finite audio of
    (generated tokens) x (samples a token)."""
    eng, _ = engines
    rng = np.random.default_rng(0)
    spf = eng.hift_cfg.samples_per_frame * eng.flow_cfg.token_mel_ratio
    text = np.array([3, 1, 4, 1, 5], np.int32)
    wav = _wav(6400, 220.0)
    toks, spk = eng.tokenize_wav16(wav), eng.embed_speaker_wav16(wav)
    calls = [
        lambda: eng.inference_tts_with_st(text, np.array([2, 7, 1], np.int32), np.array([5, 3], np.int32),
                                          rng.standard_normal((4, GEO.n_mels)).astype(np.float32) * 0.1,
                                          rng.standard_normal(GEO.spk_dim).astype(np.float32), max_new=8),
        lambda: eng.inference_zero_shot(text, toks, np.zeros((2 * len(toks), GEO.n_mels), np.float32), spk,
                                        max_new=8),
    ]
    for call in calls:
        out = next(call())["tts_speech"]
        assert out.shape == (1, eng.last_gen_len * spf) and np.isfinite(out).all()
        assert {"llm", "flow", "hift"} <= set(eng.last_timings)


def test_engine_requires_explicit_cpu_without_cuda(snapshots):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    (snap, _), _ = snapshots
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CosyEngine.load(snap)
