"""Port parity for the acoustic half of the slice (CFM and iSTFT vocoder),
in f32 at tiny widths. Tolerance: rtol 1e-5 (atol 1e-5 where values cross
zero); both sides compute in f32 with the JAX matmul precision at
``highest``, so only summation order differs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autostyle_tts_tpu.models import cfm as jcfm
from autostyle_tts_tpu.models import vocoder as jvoc
from autostyle_tts_tpu.ops import stft as jstft
from autostyle_tts_tpu.utils.config import tiny_config as jtiny
from autostyle_tts_tpu_torch.models import cfm as tcfm
from autostyle_tts_tpu_torch.models import vocoder as tvoc
from autostyle_tts_tpu_torch.ops import stft as tstft
from autostyle_tts_tpu_torch.weights import tree_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfm_params(cfg, seed=0):
    """JAX init, with the zero-initialized adaLN modulation and output
    projection filled so that every layer contributes."""
    p = jax.tree_util.tree_map(np.asarray, jcfm.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    p["layers"]["mod"] = (rng.standard_normal(p["layers"]["mod"].shape) * 0.05).astype(np.float32)
    p["out_proj"] = (rng.standard_normal(p["out_proj"].shape) * 0.1).astype(np.float32)
    return p, tree_from_numpy(p)


def _cfm_inputs(cfg, B=2, Fr=24, seed=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    pmask = (np.arange(Fr)[None, :] < np.asarray([6, 9])[:B, None]).astype(np.float32)
    fmask = (np.arange(Fr)[None, :] < np.asarray([24, 19])[:B, None]).astype(np.float32)
    return dict(token_cond=f(B, Fr, cfg.dim), spk=f(B, cfg.spk_dim),
                prompt_mel=f(B, Fr, cfg.n_mels) * pmask[..., None],
                prompt_mask=pmask, frame_mask=fmask)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_vector_field_matches():
    cfg = jtiny().cfm
    jp, tp = _cfm_params(cfg)
    inp = _cfm_inputs(cfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, cfg.n_mels)).astype(np.float32)
    t = np.asarray([0.25, 0.7], np.float32)
    want = np.asarray(jcfm.vector_field(jp, cfg, jnp.asarray(x), jnp.asarray(t),
                                        **{k: jnp.asarray(v) for k, v in inp.items()}))
    got = tcfm.vector_field(tp, cfg, _t(x), _t(t), **{k: _t(v) for k, v in inp.items()})
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("use_cfg,n_steps", [(True, 4), (False, 2)])
def test_sample_mel_matches_with_injected_noise(use_cfg, n_steps):
    cfg = dataclasses.replace(jtiny().cfm, n_steps=n_steps)
    jp, tp = _cfm_params(cfg, seed=3)
    inp = _cfm_inputs(cfg)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jcfm.sample_mel(jp, cfg, key, use_cfg=use_cfg,
                                      **{k: jnp.asarray(v) for k, v in inp.items()}))
    noise = np.asarray(jax.random.normal(key, (2, 24, cfg.n_mels), jnp.float32))
    got = tcfm.sample_mel(tp, cfg, None, use_cfg=use_cfg, noise=_t(noise),
                          **{k: _t(v) for k, v in inp.items()})
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_upsample_tokens_matches():
    cfg = jtiny().cfm
    jp, tp = _cfm_params(cfg)
    tok = np.random.default_rng(0).integers(0, cfg.token_vocab_size, (2, 7)).astype(np.int32)
    want = np.asarray(jcfm.upsample_tokens(jp, jnp.asarray(tok), 2))
    np.testing.assert_array_equal(tcfm.upsample_tokens(tp, _t(tok), 2, cfg.token_vocab_size).numpy(), want)


@pytest.mark.parametrize("n_fft,hop", [(128, 32), (1920, 480)])
def test_istft_overlap_add_matches(n_fft, hop):
    rng = np.random.default_rng(4)
    n_bins = n_fft // 2 + 1
    sr = rng.standard_normal((2, 11, n_bins)).astype(np.float32)
    si = rng.standard_normal((2, 11, n_bins)).astype(np.float32)
    want = np.asarray(jstft.istft_overlap_add(jnp.asarray(sr), jnp.asarray(si), n_fft, hop))
    got = tstft.istft_overlap_add(_t(sr), _t(si), n_fft, hop).numpy()
    assert got.shape == (2, 11 * hop)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n_fft,hop,frames", [(128, 32, 11), (1920, 480, 192)])
def test_istft_kept_constants_equal_host_uploads(n_fft, hop, frames, monkeypatch):
    """The bases and the envelope kept on the device give exactly what the
    same constants built on the host and uploaded in the call give, and a
    second call of the same size uploads nothing."""
    rng = np.random.default_rng(6)
    n_bins = n_fft // 2 + 1
    sr, si = (_t(rng.standard_normal((2, frames, n_bins)).astype(np.float32)) for _ in range(2))
    cos_b, msin_b = (torch.from_numpy(b) for b in tstft._istft_basis(n_fft))
    frames_t = sr @ cos_b + si @ msin_b
    out = torch.zeros((2, (frames + n_fft // hop - 1) * hop))
    for r in range(n_fft // hop):
        out[:, r * hop : r * hop + frames * hop] += frames_t[:, :, r * hop : (r + 1) * hop].reshape(2, -1)
    out = out / torch.clamp(torch.from_numpy(tstft._ola_envelope(frames, n_fft, hop)), min=1e-8)
    want = out[:, (n_fft - hop) // 2 : (n_fft - hop) // 2 + frames * hop]
    tstft._istft_basis_on.cache_clear()
    tstft._ola_envelope_on.cache_clear()
    uploads = []
    upload = tstft.upload
    monkeypatch.setattr(tstft, "upload", lambda a, dev: uploads.append(a.shape) or upload(a, dev))
    first = tstft.istft_overlap_add(sr, si, n_fft, hop)
    assert len(uploads) == 3
    second = tstft.istft_overlap_add(sr, si, n_fft, hop)
    assert len(uploads) == 3
    assert torch.equal(first, want) and torch.equal(second, want)


def _istft_cfg():
    c = jtiny()
    return dataclasses.replace(c.vocoder, kind="istft", istft_hop=c.audio.hop_length,
                               istft_n_fft=4 * c.audio.hop_length, istft_channels=32,
                               istft_blocks=2)


def test_apply_istft_matches():
    vcfg = _istft_cfg()
    jp = jax.tree_util.tree_map(np.asarray, jvoc.init_params(jax.random.PRNGKey(5), vcfg))
    mel = np.random.default_rng(5).standard_normal((2, 13, vcfg.n_mels)).astype(np.float32)
    want = np.asarray(jvoc.apply(jp, vcfg, jnp.asarray(mel)))
    got = tvoc.apply(tree_from_numpy(jp), vcfg, _t(mel)).numpy()
    assert got.shape == (2, 13 * vcfg.istft_hop)
    np.testing.assert_allclose(got, want, **TOL)


def test_vocoder_hifigan_kind_is_not_ported():
    """The hifigan kind is ported now (``test_torch_batch.py`` holds its
    parity with the reference): the port's own init gives the reference
    init's tree, leaf for leaf, and ``apply`` maps F frames onto
    F * total_upsample samples in [-1, 1]."""
    vcfg = jtiny().vocoder
    want = jax.tree_util.tree_map(lambda x: np.asarray(x).shape,
                                  jvoc.init_params(jax.random.PRNGKey(0), vcfg))
    got = tvoc.init_params(vcfg, torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == want
    assert tvoc.total_upsample(vcfg) == jvoc.total_upsample(vcfg) == 32
    wav = tvoc.apply(got, vcfg, torch.randn((2, 5, vcfg.n_mels)))
    assert wav.shape == (2, 5 * 32) and float(wav.abs().max()) <= 1.0
