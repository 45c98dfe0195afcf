"""Port parity for prompts from wavs: log-mel, resampler, strided conv,
speech tokenizer, speaker encoder, ``Engine.prompt_features`` and the entry
points that take wavs, against the JAX package on the same weights and the
same numpy-seeded inputs. On the CPU the port's ``fused_log_mel`` takes its
plain version; the JAX side runs both its XLA branch and its Pallas kernel
in interpret mode.

Tolerances (all f32 on both sides, sums taken in another order):
- log-mel: atol 2e-4 in log units against either JAX branch (the JAX
  package's own bound between its two branches), 2e-3 against the float64
  FFT mirror;
- the port's kernel computes its products on the tensor cores with both
  operands split into two TF32 parts; ``fused_log_mel_split_emulation``
  repeats that arithmetic on the CPU and is held to the JAX kernel (interpret
  mode) at atol 1e-3, the tolerance of the kernel-vs-plain checks on the
  card; one TF32 pass alone must miss it on the same tonal input (that is
  why the kernel pays for three); a split operand is ``hi + lo`` to 2^-21;
- resampler: atol 1e-5 against JAX, 1e-5 against the float64 numpy mirror;
- conv / tokenizer ``pre_vq`` / speaker embedding: atol 1e-4 or tighter;
- speech tokens are an argmax over the codebook: they must be equal on
  every frame whose top-2 score gap exceeds ``VQ_MARGIN``;
- ``prompt_features``: ``spk`` atol 1e-4, ``mel24`` atol 1e-3 (log units);
- end-to-end wavs: atol 1e-4 with greedy LMs and the CFM noise handed over,
  as in ``test_torch_engine.py``.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autostyle_tts_tpu.models.token_lm as jlm
import autostyle_tts_tpu_torch.models.token_lm as tlm
from autostyle_tts_tpu.models import speaker as jspeaker
from autostyle_tts_tpu.models import speech_tokenizer as jtokenizer
from autostyle_tts_tpu.ops import conv as jconv
from autostyle_tts_tpu.ops import pallas_mel as jmel
from autostyle_tts_tpu.ops import resample as jresample
from autostyle_tts_tpu.ops import stft as jstft
from autostyle_tts_tpu.ops.sampling import SamplerConfig as JSampler
from autostyle_tts_tpu.pipeline import engine as jengine
from autostyle_tts_tpu.pipeline import rag as jrag
from autostyle_tts_tpu.utils import config as jconfig
from autostyle_tts_tpu.utils.manifest import StyleSample
from autostyle_tts_tpu_torch.models import speaker, speech_tokenizer
from autostyle_tts_tpu_torch.ops import conv, resample, stft
from autostyle_tts_tpu_torch.ops import log_mel
from autostyle_tts_tpu_torch.ops.log_mel import fused_log_mel
from autostyle_tts_tpu_torch.ops.sampling import SamplerConfig
from autostyle_tts_tpu_torch.pipeline import engine as tengine
from autostyle_tts_tpu_torch.pipeline import rag as trag
from autostyle_tts_tpu_torch.utils import audio_io
from autostyle_tts_tpu_torch.utils import config as tconfig
from autostyle_tts_tpu_torch.weights import from_jax_tree, tree_from_numpy
from test_torch_engine import SEED, _cfg, _tree

VQ_MARGIN = 1e-3


def _wav(seed, n, sr):
    """A seeded synthetic prompt: sinusoids under slow envelopes plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = 0.02 * rng.standard_normal(n)
    for _ in range(4):
        f0, a = rng.uniform(0.02, 0.4) * sr, rng.uniform(0.05, 0.2)
        x += a * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.5, 3.0) * t)) * np.sin(2 * np.pi * f0 * t)
    return np.clip(x, -1, 1).astype(np.float32)


# ------------------------------------------------------------------------ log-mel


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("shape,n_fft,hop,win,n_mels", [
    ((2, 4000), 512, 160, None, 80),      # batched, 26 frames
    ((24000,), 400, 160, 400, 40),        # 1-D, 151 frames: not a multiple of 128
    ((3, 2, 1700), 64, 40, 48, 16),       # two leading axes, window shorter than n_fft
])
def test_log_mel_matches_jax(impl, shape, n_fft, hop, win, n_mels):
    x = (np.random.default_rng(0).standard_normal(shape) * 0.3).astype(np.float32)
    want = np.asarray(jstft.log_mel_spectrogram(jnp.asarray(x), 16000, n_fft, hop, win,
                                                n_mels=n_mels, impl=impl))
    fused_log_mel.launches = 0
    got = stft.log_mel_spectrogram(torch.from_numpy(x), 16000, n_fft, hop, win, n_mels=n_mels).numpy()
    assert fused_log_mel.launches == 0     # the CPU takes the plain version
    assert got.shape == want.shape == shape[:-1] + (stft.num_frames(shape[-1], n_fft, hop, win), n_mels)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_log_mel_matches_fft_mirror_and_power_spectrogram():
    x = (np.random.default_rng(1).standard_normal(8000) * 0.2).astype(np.float32)
    want = jstft.log_mel_spectrogram_np(x, 16000, 400, 160, n_mels=80, fmax=8000.0)
    got = stft.log_mel_spectrogram(torch.from_numpy(x), 16000, 400, 160, n_mels=80, fmax=8000.0).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)
    spec = stft.power_spectrogram(torch.from_numpy(x), 400, 160).numpy()
    jspec = np.asarray(jstft.power_spectrogram(jnp.asarray(x), 400, 160))
    np.testing.assert_allclose(spec, jspec, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(stft.mel_filterbank(16000, 400, 80, 0.0, 8000.0),
                                  jstft.mel_filterbank(16000, 400, 80, 0.0, 8000.0))
    for a, b in zip(stft._dft_basis(512, 400), jstft._dft_basis(512, 400)):
        np.testing.assert_array_equal(a, b)


def test_log_mel_non_cpu_tensor_never_falls_back():
    """A tensor that is not on the CPU goes to the kernel or raises (here:
    a meta tensor, no CUDA build)."""
    z = torch.zeros((1, 4, 64), device="meta")
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        fused_log_mel(z, torch.zeros((64, 33), device="meta"), torch.zeros((64, 33), device="meta"),
                      torch.zeros((33, 16), device="meta"))


def _prompt_geometry(leg):
    """(sr, n_fft, hop, win, n_mels, fmax) of the engine's two log-mel legs."""
    a = tconfig.Config().audio
    if leg == "16k":
        assert (a.prompt_n_fft, a.prompt_hop_length, a.prompt_win_length, a.prompt_n_mels, a.prompt_fmax) == \
            (400, 160, 400, 80, 8000)
        return a.prompt_sample_rate, 400, 160, 400, 80, 8000.0
    assert (a.n_fft, a.hop_length, a.win_length, a.n_mels) == (1024, 480, 1024, 80)
    return a.sample_rate, 1024, 480, 1024, 80, a.fmax


def _tonal_zero_tailed(leg, seconds=1.0, batch=2):
    """Seeded tonal prompts (strong sinusoids beside near-empty bins) whose
    last third is silence, as a prompt padded into its length bucket."""
    sr = _prompt_geometry(leg)[0]
    n = int(seconds * sr)
    x = np.zeros((batch, n), np.float32)
    for i in range(batch):
        x[i, : 2 * n // 3] = _wav(50 + i, 2 * n // 3, sr)
    return x


def _frames_and_bases(leg):
    """The strided frames ``log_mel_spectrogram`` hands to ``fused_log_mel``,
    with the bases and the filterbank of that leg."""
    sr, n_fft, hop, win, n_mels, fmax = _prompt_geometry(leg)
    x = stft._reflect_pad(torch.from_numpy(_tonal_zero_tailed(leg)), n_fft // 2)
    cos_b, sin_b = stft._dft_basis_on(torch.device("cpu"), n_fft, win)
    fb = stft._mel_filterbank_on(torch.device("cpu"), sr, n_fft, n_mels, 0.0, fmax)
    return stft.frame_signal(x, win, hop), cos_b, sin_b, fb


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("leg", ["16k", "24k"])
def test_log_mel_matches_jax_at_prompt_geometry(leg, impl):
    sr, n_fft, hop, win, n_mels, fmax = _prompt_geometry(leg)
    x = _tonal_zero_tailed(leg)
    want = np.asarray(jstft.log_mel_spectrogram(jnp.asarray(x), sr, n_fft, hop, win, n_mels=n_mels,
                                                fmax=fmax, impl=impl))
    got = stft.log_mel_spectrogram(torch.from_numpy(x), sr, n_fft, hop, win, n_mels=n_mels, fmax=fmax).numpy()
    assert got.shape == want.shape == (2, stft.num_frames(x.shape[1], n_fft, hop, win), n_mels)
    np.testing.assert_allclose(got, want, atol=2e-4)
    silent = np.abs(want - np.log(np.float32(1e-5))) < 1e-6      # frames that see only the zero tail
    assert silent.all(axis=-1).sum() >= 2 * 10
    np.testing.assert_array_equal(got[silent], np.log(np.float32(1e-5)))


@pytest.mark.parametrize("leg", ["16k", "24k"])
def test_fused_log_mel_strided_view_equals_its_copy(leg):
    frames, cos_b, sin_b, fb = _frames_and_bases(leg)
    hop = _prompt_geometry(leg)[2]
    assert frames.stride() == (frames.stride(0), hop, 1) and not frames.is_contiguous()
    got = fused_log_mel(frames, cos_b, sin_b, fb)
    assert torch.equal(got, fused_log_mel(frames.contiguous(), cos_b, sin_b, fb))
    # log_mel_spectrogram passes that view on, with no copy of the frames
    seen = []
    orig = stft.fused_log_mel
    try:
        stft.fused_log_mel = lambda f, *a, **k: seen.append(f.stride()) or orig(f, *a, **k)
        sr, n_fft, _, win, n_mels, fmax = _prompt_geometry(leg)
        out = stft.log_mel_spectrogram(torch.from_numpy(_tonal_zero_tailed(leg)), sr, n_fft, hop, win,
                                       n_mels=n_mels, fmax=fmax)
    finally:
        stft.fused_log_mel = orig
    assert seen == [frames.stride()] and torch.equal(out, got)


@pytest.mark.parametrize("n_fft,win", [(400, 400), (1024, 1024), (64, 48), (130, 130)])
def test_packed_basis_reproduces_the_bases_and_is_cached(n_fft, win):
    cos_b, sin_b = stft._dft_basis_on(torch.device("cpu"), n_fft, win)
    n_bins = n_fft // 2 + 1
    packed = log_mel.packed_basis(cos_b, sin_b)
    chunks, pairs = -(-n_bins // log_mel.TILE_BINS), -(-win // log_mel.TILE_WIN) * log_mel.TILE_WIN // 2
    assert tuple(packed.shape) == (chunks, pairs, 4 * log_mel.TILE_BINS + log_mel.PAIR_PAD) and packed.is_contiguous()
    for got, want in zip(log_mel.unpack_basis(packed, win, n_bins), (cos_b, sin_b)):
        assert torch.equal(got, want)
    # everything outside the bases is zero: the kernel multiplies it with frames it did not mask
    assert int(torch.count_nonzero(packed)) == int(torch.count_nonzero(cos_b) + torch.count_nonzero(sin_b))
    # element (window sample w, bin) of cos: chunk, pair w // 2, column bin % TILE_BINS, parity w % 2
    w, k = win - 3, n_bins - 1
    assert packed[k // log_mel.TILE_BINS, w // 2, 2 * (k % log_mel.TILE_BINS) + w % 2] == cos_b[w, k]
    assert packed[k // log_mel.TILE_BINS, w // 2, 2 * (log_mel.TILE_BINS + k % log_mel.TILE_BINS) + w % 2] == sin_b[w, k]
    assert log_mel.packed_basis(cos_b, sin_b) is packed                        # same tensors, same packed form
    assert log_mel.packed_basis(*stft._dft_basis_on(torch.device("cpu"), n_fft, win)) is packed
    fresh = log_mel.packed_basis(cos_b.clone(), sin_b)                         # another tensor: packed anew
    assert fresh is not packed and torch.equal(fresh, packed)


def test_packed_basis_follows_an_in_place_change():
    cos_b, sin_b = torch.randn(16, 9), torch.randn(16, 9)
    before = log_mel.packed_basis(cos_b, sin_b)
    cos_b.mul_(2.0)
    after = log_mel.packed_basis(cos_b, sin_b)
    assert after is not before and torch.equal(log_mel.unpack_basis(after, 16, 9)[0], cos_b)


def test_tf32_split_is_exact_to_2_pow_minus_21():
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(50000).astype(np.float32)
                         * np.float32(10.0) ** np.random.default_rng(8).integers(-6, 6, 50000).astype(np.float32))
    hi, lo = log_mel.tf32_split(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0      # 10 mantissa bits each
    rel = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert float(rel.max()) <= 2.0 ** -21
    assert float(((hi.double() - x.double()).abs() / x.double().abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("leg", ["16k", "24k"])
def test_split_tf32_emulation_matches_jax_kernel_on_tonal_input(leg):
    """The arithmetic of the CUDA kernel (operands rounded as it rounds
    them) against the JAX kernel in interpret mode, on the input where TF32
    hurts most: weak bins beside strong tones, and a silent tail."""
    frames, cos_b, sin_b, fb = _frames_and_bases(leg)
    want = np.asarray(jmel.fused_log_mel(jnp.asarray(frames.contiguous().numpy()), jnp.asarray(cos_b.numpy()),
                                         jnp.asarray(sin_b.numpy()), jnp.asarray(fb.numpy()), interpret=True))
    got = log_mel.fused_log_mel_split_emulation(frames, cos_b, sin_b, fb).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert np.abs(got - want).max() < 2e-4          # in fact as close as the plain f32 version
    silent = (frames.abs().amax(-1) == 0).numpy()
    assert silent.sum() >= 2 * 10
    np.testing.assert_array_equal(got[silent], np.log(np.float32(1e-5)))
    one_pass = log_mel.fused_log_mel_split_emulation(frames, cos_b, sin_b, fb, passes=1).numpy()
    assert np.abs(one_pass - want).max() > 1e-3     # plain TF32 does not hold the tolerance here


def _meta(*shape):
    return torch.zeros(shape, device="meta")


@pytest.mark.parametrize("case", ["f64_frames", "f16_bases", "sample_stride", "negative_shape", "basis_shape",
                                  "transposed_fb", "mixed_devices"])
def test_fused_log_mel_refusals_never_reach_the_plain_version(case, monkeypatch):
    """What the kernel does not take raises in the wrapper (meta tensors: no
    CUDA build here); the plain version is for CPU tensors only."""
    def no_fallback(*a, **k):
        raise AssertionError("the plain version was called for a tensor that is not on the CPU")
    monkeypatch.setattr(log_mel, "fused_log_mel_plain", no_fallback)
    frames, cos_b, sin_b, fb = _meta(1, 4, 64), _meta(64, 33), _meta(64, 33), _meta(33, 16)
    if case == "f64_frames":
        frames = frames.double()
    elif case == "f16_bases":
        cos_b, sin_b = cos_b.half(), sin_b.half()
    elif case == "sample_stride":
        frames = _meta(1, 4, 128)[:, :, ::2]
    elif case == "negative_shape":
        frames = _meta(1, 0, 64)
    elif case == "basis_shape":
        sin_b = _meta(64, 32)
    elif case == "transposed_fb":
        fb = _meta(16, 33).t()
    else:
        fb = torch.zeros((33, 16))
    with pytest.raises(ValueError, match="fused_log_mel"):
        fused_log_mel(frames, cos_b, sin_b, fb)


# ---------------------------------------------------------------------- resampler


@pytest.mark.parametrize("sr_in,sr_out,n", [(16000, 24000, 4001), (1600, 2400, 1600),
                                            (22050, 16000, 3000), (16000, 16000, 100)])
def test_resample_matches_jax_and_numpy_mirror(sr_in, sr_out, n):
    x = (np.random.default_rng(2).standard_normal((2, n)) * 0.3).astype(np.float32)
    want = np.asarray(jresample.resample(jnp.asarray(x), sr_in, sr_out))
    got = resample.resample(torch.from_numpy(x), sr_in, sr_out).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got[1], resample.resample_poly_np(x[1], sr_in, sr_out), atol=1e-5)
    np.testing.assert_array_equal(resample.resample_poly_np(x[0], sr_in, sr_out),
                                  jresample.resample_poly_np(x[0], sr_in, sr_out))


# ------------------------------------------------------------------- strided conv


@pytest.mark.parametrize("T", [8, 9, 10, 11, 33])
@pytest.mark.parametrize("stride,kernel,dilation", [(2, 4, 1), (1, 3, 2), (3, 5, 1), (2, 3, 1)])
def test_conv1d_same_padding_matches_xla(T, stride, kernel, dilation):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, T, 5)).astype(np.float32)
    p = {"w": rng.standard_normal((kernel, 5, 7)).astype(np.float32),
         "b": rng.standard_normal((7,)).astype(np.float32)}
    want = np.asarray(jconv.conv1d(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p),
                                   stride=stride, dilation=dilation))
    got = conv.conv1d(torch.from_numpy(x), tree_from_numpy(p), stride=stride, dilation=dilation).numpy()
    assert got.shape == want.shape == (2, -(-T // stride), 7)
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------- speech tokenizer and speaker


def _masked_mel(rng, B, T, n_mels, lens):
    mel = (rng.standard_normal((B, T, n_mels)) * 2.0 - 4.0).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)
    return mel, mask


def _assert_tokens_equal_where_decisive(got, codebook, pre_vq, want):
    scores = speech_tokenizer.vq_scores(torch.tensor(codebook), torch.tensor(pre_vq))
    top2 = torch.topk(scores, 2, dim=-1).values
    decisive = ((top2[..., 0] - top2[..., 1]) > VQ_MARGIN).numpy()
    assert decisive.mean() > 0.9
    np.testing.assert_array_equal(got[decisive], want[decisive])


@pytest.mark.parametrize("T,lens", [(61, [61, 37]), (64, [50, 3])])
def test_speech_tokenizer_matches_jax(T, lens):
    cfg = jconfig.tiny_config().speech_tokenizer
    jp = jtokenizer.init_params(jax.random.PRNGKey(1), cfg)
    tp = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    mel, mask = _masked_mel(np.random.default_rng(4), 2, T, cfg.n_mels, lens)
    want = jtokenizer.apply(jp, cfg, jnp.asarray(mel), jnp.asarray(mask))
    got = speech_tokenizer.apply(tp, tconfig.tiny_config().speech_tokenizer,
                                 torch.from_numpy(mel), torch.from_numpy(mask))
    assert got.tokens.dtype == torch.int32 and tuple(got.tokens.shape) == want.tokens.shape
    np.testing.assert_array_equal(got.token_mask.numpy(), np.asarray(want.token_mask))
    np.testing.assert_allclose(got.pre_vq.numpy(), np.asarray(want.pre_vq), atol=1e-4)
    _assert_tokens_equal_where_decisive(got.tokens.numpy(), np.asarray(jp["codebook"]),
                                        np.asarray(want.pre_vq), np.asarray(want.tokens))
    rows = speech_tokenizer.codebook_lookup(tp["codebook"], got.tokens)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jtokenizer.codebook_lookup(jp["codebook"], got.tokens.numpy())))


def test_speaker_encoder_matches_jax():
    cfg = jconfig.tiny_config().speaker
    jp = jspeaker.init_params(jax.random.PRNGKey(2), cfg)
    tp = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    mel, mask = _masked_mel(np.random.default_rng(5), 3, 45, cfg.n_mels, [45, 20, 1])
    want = np.asarray(jspeaker.apply(jp, cfg, jnp.asarray(mel), jnp.asarray(mask)))
    got = speaker.apply(tp, tconfig.tiny_config().speaker, torch.from_numpy(mel), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_port_init_fills_tokenizer_and_speaker_with_jax_shapes():
    cfg = tconfig.tiny_config()
    jt = jtokenizer.init_params(jax.random.PRNGKey(0), jconfig.tiny_config().speech_tokenizer)
    js = jspeaker.init_params(jax.random.PRNGKey(0), jconfig.tiny_config().speaker)
    g = torch.Generator().manual_seed(0)
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shapes(tree_from_numpy(jax.tree_util.tree_map(np.asarray, jt))) == \
        shapes(speech_tokenizer.init_params(cfg.speech_tokenizer, g))
    assert shapes(tree_from_numpy(jax.tree_util.tree_map(np.asarray, js))) == \
        shapes(speaker.init_params(cfg.speaker, g))
    bad = _tree(_cfg(jconfig))
    bad["speech_tokenizer"]["codebook"] = bad["speech_tokenizer"]["codebook"][:-1]
    with pytest.raises(ValueError, match="speech_tokenizer/codebook"):
        from_jax_tree(bad, _cfg(tconfig))


# ------------------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def engines():
    """One JAX engine and one port engine on the same weights, both greedy,
    the generation bucket pinned to 32 tokens (see test_torch_engine.py)."""
    mp = pytest.MonkeyPatch()
    jcfg, tcfg = _cfg(jconfig), _cfg(tconfig)
    tree = _tree(jcfg)
    mp.setattr(jlm, "generate_speech_from_ids", functools.partial(
        jlm.generate_speech_from_ids, sampler=JSampler(greedy=True)))
    mp.setattr(tlm, "generate_speech_from_ids", functools.partial(
        tlm.generate_speech_from_ids, sampler=SamplerConfig(greedy=True)))
    mp.setattr(jengine, "GEN_BUCKETS", (32,))
    mp.setattr(tengine, "GEN_BUCKETS", (32,))
    jeng = jengine.Engine(jcfg, params=jengine.EngineParams.from_tree(
        jax.tree_util.tree_map(jnp.asarray, tree)), seed=SEED)
    mega = jlm.mega_decode_params(jeng.params.token_lm, jcfg.token_lm)
    mp.setattr(jeng, "_fused_decode_params", lambda shape, max_new: mega)
    teng = tengine.Engine(tcfg, params=tengine.EngineParams.from_tree(
        from_jax_tree(tree, tcfg)), seed=SEED, device="cpu")
    yield jeng, teng, tcfg
    mp.undo()


def _assert_features_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.tokens.dtype == np.int32 and g.tokens.shape == w.tokens.shape
        assert g.mel24.shape == w.mel24.shape and g.spk.shape == w.spk.shape
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_allclose(g.spk, w.spk, atol=1e-4)
        np.testing.assert_allclose(g.mel24, w.mel24, atol=1e-3)


def test_prompt_features_match_jax_engine(engines):
    jeng, teng, tcfg = engines
    sr = tcfg.audio.prompt_sample_rate
    wavs = [_wav(11, int(1.5 * sr), sr), _wav(12, int(2.7 * sr), sr)]   # 2 s and 4 s buckets
    got = teng.prompt_features(wavs)
    _assert_features_match(got, jeng.prompt_features(wavs))
    assert [len(f.tokens) for f in got] == [15, 27]
    one = teng.prompt_features(wavs[:1])     # alone it lands in the 2 s bucket
    np.testing.assert_array_equal(one[0].tokens, got[0].tokens)


def test_tokens_do_not_depend_on_the_padding_bucket(engines):
    """The same wav padded to the 4 s and to the 8 s bucket: same tokens,
    same speaker embedding, same prompt mel on the real frames."""
    _, teng, tcfg = engines
    sr = tcfg.audio.prompt_sample_rate
    w = _wav(13, int(3.1 * sr), sr)
    short = teng.prompt_features([w])[0]
    longer = teng.prompt_features([w, np.zeros(int(7.5 * sr), np.float32)])[0]
    np.testing.assert_array_equal(short.tokens, longer.tokens)
    np.testing.assert_allclose(short.spk, longer.spk, atol=1e-5)
    # the last frames see the reflect padding of the bucket's end
    n = short.mel24.shape[0] - 4
    np.testing.assert_allclose(short.mel24[:n], longer.mel24[:n], atol=1e-4)


def _cfm_noise(jeng, tcfg, n_prompt_tokens):
    """The CFM noise the JAX engine will draw on its next B=1 request: the
    key split order of its ``_synthesize_one``."""
    fp_w = tengine._bucket(n_prompt_tokens, tengine.TOKEN_BUCKETS)
    key, _key_lm = jax.random.split(jeng.key)
    _, key_cfm = jax.random.split(key)
    return np.asarray(jax.random.normal(
        key_cfm, (1, (fp_w + 32) * tcfg.cfm.upsample, tcfg.cfm.n_mels), jnp.float32))


@pytest.mark.parametrize("entry", ["zero_shot", "tts_with_st", "sft"])
def test_wav_entry_points_match_jax_engine(engines, entry):
    jeng, teng, tcfg = engines
    sr = tcfg.audio.prompt_sample_rate
    style, timbre = _wav(21, int(1.6 * sr), sr), _wav(22, int(2.2 * sr), sr)
    text = "Hello there, this is a test."
    if entry == "zero_shot":
        noise = _cfm_noise(jeng, tcfg, 16)
        want = next(jeng.inference_zero_shot(text, "the prompt text", style))["tts_speech"]
        got = next(teng.inference_zero_shot(text, "the prompt text", style, cfm_noise=noise))["tts_speech"]
    elif entry == "tts_with_st":
        noise = _cfm_noise(jeng, tcfg, 22)
        want = next(jeng.inference_tts_with_st(text, "the style text", style, timbre))["tts_speech"]
        got = next(teng.inference_tts_with_st(text, "the style text", style, timbre,
                                              cfm_noise=noise))["tts_speech"]
    else:
        jeng.register_speaker("a", timbre)
        teng.register_speaker("a", timbre)
        noise = _cfm_noise(jeng, tcfg, 22)
        want = next(jeng.inference_sft(text, "a"))["tts_speech"]
        got = next(teng.inference_sft(text, "a", cfm_noise=noise))["tts_speech"]
    assert got.dtype == np.float32 and got.shape == want.shape and got.shape[1] > 0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert ("featurize" in teng.last_timings) == (entry != "sft")


def test_synthesize_batch_featurizes_a_repeated_wav_once(engines, monkeypatch):
    _, teng, tcfg = engines
    sr = tcfg.audio.prompt_sample_rate
    w = _wav(23, int(1.2 * sr), sr)
    seen = []
    orig = teng.prompt_features
    monkeypatch.setattr(teng, "prompt_features", lambda wavs, clock=None: seen.append(len(wavs)) or orig(wavs, clock))
    out = teng.synthesize_batch(["hi there"], ["style"], [w], [w], max_seconds=1.0)
    assert seen == [1] and len(out) == 1 and out[0].ndim == 1 and np.isfinite(out[0]).all()
    teng.synthesize_batch(["hi there"], ["style"], [w], [w.copy()], max_seconds=1.0)
    assert seen == [1, 2]
    f = orig([w])[0]
    teng.synthesize_batch(["hi there"], ["style"], [f], [f], max_seconds=1.0)
    assert seen == [1, 2]


def test_speakers_round_trip_across_packages(engines, tmp_path):
    jeng, teng, tcfg = engines
    sr = tcfg.audio.prompt_sample_rate
    teng.register_speaker("x", _wav(31, sr, sr))
    teng.register_speaker("y", _wav(32, 2 * sr, sr))
    teng.save_speakers(tmp_path / "spk" / "reg.npz")
    fresh = tengine.Engine.__new__(tengine.Engine)
    fresh.speakers = {}
    fresh.load_speakers(tmp_path / "spk" / "reg")
    assert {"x", "y"} <= set(fresh.speakers) and sorted(fresh.speakers) == sorted(teng.speakers)
    for sid in ("x", "y"):
        for field in ("tokens", "spk", "mel24"):
            np.testing.assert_array_equal(getattr(fresh.speakers[sid], field),
                                          getattr(teng.speakers[sid], field))
    jeng.load_speakers(tmp_path / "spk" / "reg")      # the reference reads the same files
    np.testing.assert_array_equal(jeng.speakers["y"].tokens, teng.speakers["y"].tokens)


def test_prompt_artifacts_match_build_style_db(engines, tmp_path):
    """The artifact half of the DB build: the same wav files through the
    JAX ``build_style_db(engine=...)`` and the port's ``prompt_artifacts``."""
    jeng, teng, tcfg = engines
    sr = tcfg.audio.prompt_sample_rate
    lens = [int(1.3 * sr), int(2.6 * sr), sr]
    samples = [StyleSample(speaker="w1", zh_text=f"line {i}", file_id=f"utt_{i}") for i in range(3)]
    for i, n in enumerate(lens):
        audio_io.write_wav(tmp_path / f"utt_{i}.wav", _wav(40 + i, n, sr), sr)
    rng = np.random.default_rng(6)
    embedder = types.SimpleNamespace(
        cfg=types.SimpleNamespace(dim=4),
        biographies=lambda items: ["bio"] * len(items),
        emotion_labels=lambda texts: ["neutral"] * len(texts),
        combined_embedding=lambda emotions, bios: rng.standard_normal((len(bios), 8)).astype(np.float32))
    want = jrag.build_style_db(embedder, samples, capacity=8, batch=2, engine=jeng,
                               wav_dir=str(tmp_path)).artifacts
    wavs = []
    for i in range(3):
        x, rate = audio_io.read_wav(tmp_path / f"utt_{i}.wav")
        assert rate == sr
        wavs.append(x)
    got = trag.prompt_artifacts(teng, wavs, batch=2)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    for k in ("speech_tokens", "speech_token_lens", "prompt_mel_lens"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["spk"], want["spk"], atol=1e-4)
    np.testing.assert_allclose(got["prompt_mel"], want["prompt_mel"], atol=1e-3)
    feats = teng.prompt_features_from_store(types.SimpleNamespace(artifacts=got), [1])
    assert len(feats[0].tokens) == got["speech_token_lens"][1] == 26
