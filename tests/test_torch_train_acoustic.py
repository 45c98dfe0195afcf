"""Port parity for the acoustic training stack: one step of each factory of
``train/acoustic.py`` and ``train/cfm_distill.py`` against the JAX package's
on the same weights, batch and random draws (the draws the JAX step makes
from its key are computed here and handed to the port's step), and the
optimizer against optax.

Tolerances (f32 on both sides, JAX matmuls at ``highest``):
- loss: rel 1e-5;
- gradients: max |delta| <= 1e-4 * max |g| per tensor (the gradients are
  read from a first link of the optimizer chain that keeps them as its
  state, on both sides);
- parameters after the update (clip, AdamW, cosine schedule): 1e-6 where
  the gradient is resolved (|g| above the gradient tolerance; below it
  Adam's first step g / (|g| + eps) is a sign of rounding noise on either
  side, and there the two updates may differ by up to 2 lr);
- optimizer alone over 5 steps on the same gradients: 1e-6.
The iSTFT vocoder's gradient is held to 5e-3 * max |g| (measured 2.3e-3):
its random-init output leaves STFT bins near the 1e-9 power floor, where
the log-magnitude loss amplifies f32 rounding of the DFT sums (1e-4 of a
bin 60 dB under its frame's peak) on either side; the HiFi-GAN case, whose
output has no such bins, is held to 1e-4. The token LM's trunk computes in
bf16 in both packages; its f32 case
patches ``core_config`` to f32 on both sides, and the bf16 case holds the
loss to rel 2e-3 (measured: 1.1e-4 at these shapes) and the gradients to
5e-2 * max |g| (measured: 2.1e-2; bf16 rounds differently inside XLA's
fused programs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autostyle_tts_tpu.models import cfm as jcfm
from autostyle_tts_tpu.models import discriminator as jdisc
from autostyle_tts_tpu.models import speech_tokenizer as jst
from autostyle_tts_tpu.models import token_lm as jtlm
from autostyle_tts_tpu.models import vocoder as jvoc
from autostyle_tts_tpu.ops import stft as jstft
from autostyle_tts_tpu.train import acoustic as jac
from autostyle_tts_tpu.train import cfm_distill as jdist
from autostyle_tts_tpu.utils.config import tiny_config as jtiny
from autostyle_tts_tpu_torch.models import token_lm as ttlm
from autostyle_tts_tpu_torch.train import acoustic as tac
from autostyle_tts_tpu_torch.train import cfm_distill as tdist
from autostyle_tts_tpu_torch.train import optim
from autostyle_tts_tpu_torch.weights import _flat_keys, tree_from_numpy

from torch_one_thread import one_thread  # noqa: F401

LR = 1e-4
GRAD_TOL = 1e-4
ISTFT_GRAD_TOL = 5e-3   # the iSTFT vocoder's case; measured 2.3e-3 (see the module docstring)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _torch(tree):
    return tree_from_numpy(_np(tree))


def _j(tree):
    """Fresh JAX arrays (the JAX steps donate their parameter buffers)."""
    return jax.tree_util.tree_map(lambda x: jnp.array(np.asarray(x)), tree)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jax_opt(lr=LR, clip=True):
    """optax chain whose first link keeps the gradients as its state."""
    keep = optax.GradientTransformation(lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))
    links = [keep] + ([optax.clip_by_global_norm(1.0)] if clip else [])
    return optax.chain(*links, optax.adamw(optax.cosine_decay_schedule(lr, 10)))


def _port_opt(lr=LR, clip=True):
    keep = optim.GradientTransformation(lambda p: optim.tree_map(torch.zeros_like, p), lambda g, s, p=None: (g, g))
    links = [keep] + ([optim.clip_by_global_norm(1.0)] if clip else [])
    return optim.chain(*links, optim.adamw(optim.cosine_decay_schedule(lr, 10)))


def _flat(tree):
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in _flat_keys(tree).items()}


def check_step(jres, tres, j_params0, loss_rtol=1e-5, grad_tol=GRAD_TOL, lr=LR):
    """jres / tres: (params, opt_state, loss) of one step on each side."""
    (jp, jst_, jl), (tp, tst, tl) = jres, tres
    np.testing.assert_allclose(float(tl), float(jl), rtol=loss_rtol)
    jg, tg = _flat(_np(jst_[0])), _flat(tst[0])
    assert jg.keys() == tg.keys()
    for k in jg:
        tol = grad_tol * max(float(np.abs(jg[k]).max()), 1e-30)
        err = float(np.abs(jg[k] - tg[k]).max())
        assert err <= tol, f"grad {k}: max |delta| {err} > {tol}"
    jpf, tpf, p0 = _flat(_np(jp)), _flat(tp), _flat(_np(j_params0))
    for k in jpf:
        resolved = np.abs(jg[k]) > grad_tol * np.abs(jg[k]).max()
        d = np.abs(jpf[k] - tpf[k])
        assert float(np.where(resolved, d, 0).max(initial=0)) <= 1e-6, f"param {k}"
        assert float(d.max(initial=0)) <= 2.5 * lr, f"param {k}"
        assert np.any(jpf[k] != p0[k]) or not np.any(jg[k]), f"param {k} did not move"


@pytest.fixture(scope="module")
def cfg():
    return jtiny()


# ----------------------------------------------------------------------------- optimizer


@pytest.mark.parametrize("clip,schedule,accum", [(True, "cosine", 1), (False, "linear", 1), (True, "linear", 3),
                                                 (False, "constant", 2)])
def test_optimizer_matches_optax_over_5_steps(clip, schedule, accum):
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32), "b": [rng.standard_normal(5).astype(np.float32)]}
    grads = [{"a": (rng.standard_normal((4, 3)) * s).astype(np.float32),
              "b": [(rng.standard_normal(5) * s).astype(np.float32)]} for s in (0.3, 2.0, 0.01, 5.0, 0.5) * accum]
    wd = 1e-4 if schedule == "cosine" else 0.0
    js = {"cosine": optax.cosine_decay_schedule(1e-2, 7), "linear": optax.linear_schedule(1e-2, 0.0, 4),
          "constant": 1e-2}[schedule]
    ts = {"cosine": optim.cosine_decay_schedule(1e-2, 7), "linear": optim.linear_schedule(1e-2, 0.0, 4),
          "constant": 1e-2}[schedule]
    jopt = optax.chain(*([optax.clip_by_global_norm(1.0)] if clip else []), optax.adamw(js, weight_decay=wd))
    topt = optim.chain(*([optim.clip_by_global_norm(1.0)] if clip else []), optim.adamw(ts, weight_decay=wd))
    if accum > 1:
        jopt, topt = optax.MultiSteps(jopt, every_k_schedule=accum), optim.MultiSteps(topt, accum)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p0), tree_from_numpy(p0)
    js_, ts_ = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js_ = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js_, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts_ = topt.update(tree_from_numpy(g), ts_, tp)
        tp = optim.apply_updates(tp, tu)
        for k, v in _flat(_np(jp)).items():
            np.testing.assert_allclose(_flat(tp)[k], v, rtol=0, atol=1e-6)
    assert float(np.abs(_flat(tp)["a"] - p0["a"]).max()) > 1e-3


def test_default_optimizer_defaults():
    """The acoustic default: clip 1.0, AdamW decay 1e-4, cosine over
    total_steps, the schedule read before its count moves."""
    rng = np.random.default_rng(1)
    p = {"w": rng.standard_normal((3, 3)).astype(np.float32)}
    g = {"w": rng.standard_normal((3, 3)).astype(np.float32) * 3}
    jo, to = jac.default_optimizer(1e-3, 5), tac.default_optimizer(1e-3, 5)
    ju, _ = jo.update(jax.tree_util.tree_map(jnp.asarray, g), jo.init(jax.tree_util.tree_map(jnp.asarray, p)),
                      jax.tree_util.tree_map(jnp.asarray, p))
    tu, _ = to.update(tree_from_numpy(g), to.init(tree_from_numpy(p)), tree_from_numpy(p))
    np.testing.assert_allclose(tu["w"].numpy(), np.asarray(ju["w"]), rtol=1e-6, atol=1e-9)


# ----------------------------------------------------------------------------- token LM


def _lm_batch(tl, seed=0):
    rng = np.random.default_rng(seed)
    return {"text": rng.integers(16, 200, (2, 6)).astype(np.int32), "text_len": np.asarray([6, 4], np.int32),
            "style_tokens": rng.integers(0, 64, (2, 4)).astype(np.int32), "style_len": np.asarray([4, 3], np.int32),
            "spk": rng.standard_normal((2, tl.spk_dim)).astype(np.float32),
            "targets": rng.integers(0, 64, (2, 8)).astype(np.int32), "target_len": np.asarray([8, 6], np.int32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_token_lm_step_matches(cfg, monkeypatch, dtype):
    tl = cfg.token_lm
    if dtype == "float32":
        for mod in (jtlm, ttlm):
            orig = mod.core_config
            monkeypatch.setattr(mod, "core_config", lambda c, orig=orig: dataclasses.replace(orig(c), dtype="float32"))
    jp = _np(jtlm.init_params(jax.random.PRNGKey(0), tl))
    batch = _lm_batch(tl)
    jres = jac.make_token_lm_step(tl, _jax_opt(), remat=False)(_j(jp), _jax_opt().init(_j(jp)), _jnp(batch),
                                                                jax.random.PRNGKey(1))
    tp = _torch(jp)
    tres = tac.make_token_lm_step(tl, _port_opt(), remat=True)(tp, _port_opt().init(tp), _t(batch),
                                                               torch.Generator())
    if dtype == "float32":
        check_step(jres, tres, jp)
    else:
        np.testing.assert_allclose(float(tres[2]), float(jres[2]), rtol=2e-3)
        jg, tg = _flat(_np(jres[1][0])), _flat(tres[1][0])
        for k in jg:
            assert float(np.abs(jg[k] - tg[k]).max()) <= 5e-2 * float(np.abs(jg[k]).max()) + 1e-30, k


# ----------------------------------------------------------------------------- CFM


def _cfm_setup(c, seed=0):
    jp = _np(jcfm.init_params(jax.random.PRNGKey(seed), c))
    rng = np.random.default_rng(seed)
    # the zero-initialized adaLN modulation and output projection, filled so every layer has a gradient path
    jp["layers"]["mod"] = (rng.standard_normal(jp["layers"]["mod"].shape) * 0.05).astype(np.float32)
    jp["out_proj"] = (rng.standard_normal(jp["out_proj"].shape) * 0.1).astype(np.float32)
    B, T_tok = 2, 6
    F = T_tok * c.upsample
    pm = np.zeros((B, F), np.float32)
    pm[:, :2] = 1
    fm = np.ones((B, F), np.float32)
    fm[1, -3:] = 0
    batch = {"tokens": rng.integers(0, 64, (B, T_tok)).astype(np.int32),
             "mel": rng.standard_normal((B, F, c.n_mels)).astype(np.float32),
             "spk": rng.standard_normal((B, c.spk_dim)).astype(np.float32), "prompt_mask": pm, "frame_mask": fm}
    return jp, batch


def test_cfm_step_matches_with_injected_draws(cfg):
    c = cfg.cfm
    jp, batch = _cfm_setup(c)
    key = jax.random.PRNGKey(7)
    jres = jac.make_cfm_step(c, _jax_opt(), cond_drop_prob=0.5)(_j(jp), _jax_opt().init(_j(jp)), _jnp(batch), key)
    k1, k2, k3 = jax.random.split(key, 3)
    mel = jnp.asarray(batch["mel"])
    draws = {"x0": np.asarray(jax.random.normal(k1, mel.shape, mel.dtype)),
             "t": np.asarray(jax.random.uniform(k2, (2,), mel.dtype)),
             "drop": np.asarray(jax.random.bernoulli(k3, 0.5, (2,)))}
    tp = _torch(jp)
    tres = tac.make_cfm_step(c, _port_opt(), cond_drop_prob=0.5)(tp, _port_opt().init(tp), _t(batch), None,
                                                                 draws=_t(draws))
    check_step(jres, tres, jp)


# ----------------------------------------------------------------------------- vocoder


def _voc_batch(cfg, F=16):
    a, v = cfg.audio, cfg.vocoder
    up = jvoc.total_upsample(v)
    t = np.arange(F * up) / a.sample_rate
    wav = np.stack([0.5 * np.sin(2 * np.pi * 220 * t), 0.3 * np.sin(2 * np.pi * 330 * t)]).astype(np.float32)
    mel = np.asarray(jstft.log_mel_spectrogram(jnp.asarray(wav), a.sample_rate, a.n_fft, a.hop_length,
                                               n_mels=v.n_mels))[:, :F]
    return {"mel": mel, "wav": wav}


@pytest.mark.parametrize("kind", ["hifigan", "istft"])
def test_vocoder_step_matches(cfg, kind):
    a = cfg.audio
    v = cfg.vocoder if kind == "hifigan" else dataclasses.replace(
        cfg.vocoder, kind="istft", istft_n_fft=128, istft_hop=32, istft_channels=32, istft_blocks=2)
    jp = _np(jvoc.init_params(jax.random.PRNGKey(0), v))
    if kind == "istft":
        # magnitudes down from e^0 to e^-3: at init most samples clip at +-1, and the STFT loss of a clipped
        # run (bins of power ~0 under a sqrt) makes the gradient a function of rounding noise on either side
        jp["head"]["b"][: v.istft_n_fft // 2 + 1] -= 3.0
    batch = _voc_batch(cfg)
    kw = dict(sr=a.sample_rate, n_fft=a.n_fft, hop=a.hop_length)
    jres = jac.make_vocoder_step(v, _jax_opt(), **kw)(_j(jp), _jax_opt().init(_j(jp)), _jnp(batch),
                                                      jax.random.PRNGKey(0))
    tp = _torch(jp)
    tres = tac.make_vocoder_step(v, _port_opt(), **kw)(tp, _port_opt().init(tp), _t(batch), None)
    check_step(jres, tres, jp, grad_tol=GRAD_TOL if kind == "hifigan" else ISTFT_GRAD_TOL)


def test_vocoder_gan_steps_match(cfg):
    a, v = cfg.audio, cfg.vocoder
    g = _np(jvoc.init_params(jax.random.PRNGKey(0), v))
    d = _np(jdisc.init_params(jax.random.PRNGKey(1)))
    batch = _voc_batch(cfg, F=16)
    kw = dict(sr=a.sample_rate, n_fft=a.n_fft, hop=a.hop_length)
    jgen, jdis = jac.make_vocoder_gan_steps(v, _jax_opt(), _jax_opt(), **kw)
    tgen, tdis = tac.make_vocoder_gan_steps(v, _port_opt(), _port_opt(), **kw)
    tg, td = _torch(g), _torch(d)
    jd_res = jdis(_j(d), _jax_opt().init(_j(d)), _j(g), _jnp(batch), jax.random.PRNGKey(0))
    td_res = tdis(td, _port_opt().init(td), tg, _t(batch), None)
    check_step(jd_res, td_res, d)
    # the generator step against the updated discriminator of each side
    jg_res = jgen(_j(g), _jax_opt().init(_j(g)), _j(_np(jd_res[0])), _jnp(batch), jax.random.PRNGKey(1))
    tg_res = tgen(tg, _port_opt().init(tg), td_res[0], _t(batch), None)
    check_step(jg_res, tg_res, g)


# ----------------------------------------------------------------------------- tokenizer


def _tok_batch(a, seed=0):
    rng = np.random.default_rng(seed)
    T = a.prompt_sample_rate
    wav = (0.3 * np.sin(2 * np.pi * 220 * np.arange(2 * T).reshape(2, T) / a.prompt_sample_rate)
           + 0.05 * rng.standard_normal((2, T))).astype(np.float32)
    return {"wav16": wav, "len": np.asarray([T, T // 2], np.int32),
            "phn": rng.integers(0, 8, (2, 64)).astype(np.int32)}


def test_tokenizer_step_matches_with_injected_restarts(cfg):
    st, a = cfg.speech_tokenizer, cfg.audio
    V = st.codebook_size
    jp = _np({"tok": jst.init_params(jax.random.PRNGKey(0), st),
              "head": jac.init_tokenizer_head(jax.random.PRNGKey(1), st, 8)})
    batch = _tok_batch(a)
    usage = np.full((V,), 1.0 / V, np.float32)
    usage[::3] = 0.0              # a third of the codes dead: the restarts run
    key = jax.random.PRNGKey(5)
    jopt = _jax_opt()
    jres = jac.make_tokenizer_step(st, a, jopt, 8)(_j(jp), jopt.init(_j(jp)), jnp.array(usage), _jnp(batch), key)
    # the restart frames the JAX step drew from its key, over its valid frames
    mel16 = jstft.log_mel_spectrogram(jnp.asarray(batch["wav16"]), a.prompt_sample_rate, a.prompt_n_fft,
                                      a.prompt_hop_length, a.prompt_win_length, n_mels=a.prompt_n_mels,
                                      fmax=a.prompt_fmax)
    fmask = (jnp.arange(mel16.shape[1])[None, :] < (batch["len"][:, None] // a.prompt_hop_length) + 1)
    tmask = jst.apply(_j(jp["tok"]), st, mel16, fmask.astype(jnp.float32)).token_mask
    idx = jax.random.categorical(key, jnp.log(tmask.reshape(-1).astype(jnp.float32) + 1e-9), shape=(V,))
    tp = _torch(jp)
    topt = _port_opt()
    tres = tac.make_tokenizer_step(st, a, topt, 8)(tp, topt.init(tp), torch.from_numpy(usage), _t(batch), None,
                                                   restart_idx=torch.from_numpy(np.array(idx)))
    jp1, js1, ju, jl, jce, jacc, jn = jres
    tp1, ts1, tu, tl, tce, tacc, tn = tres
    np.testing.assert_allclose(float(tce), float(jce), rtol=1e-5)
    assert float(tacc) == float(jacc) and int(tn) == int(jn)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6, atol=1e-9)
    dead = usage < 1.0 / (8 * V)
    assert dead.any()
    cb_j, cb_t = np.asarray(jp1["tok"]["codebook"]), tp1["tok"]["codebook"].numpy()
    np.testing.assert_allclose(cb_t[dead], cb_j[dead], rtol=1e-5, atol=1e-6)   # restarted: encoder frames
    tp1["tok"]["codebook"][torch.from_numpy(dead)] = torch.from_numpy(cb_j[dead])  # the rest as any parameter
    check_step((jp1, js1, jl), (tp1, ts1, tl), jp)


def test_phn_head_step_matches(cfg):
    st, a = cfg.speech_tokenizer, cfg.audio
    tok = _np(jst.init_params(jax.random.PRNGKey(0), st))
    head = np.asarray(jac.init_tokenizer_head(jax.random.PRNGKey(3), st, 8))
    batch = _tok_batch(a, seed=1)
    jopt, topt = _jax_opt(), _port_opt()
    jh, js, jce, jacc = jac.make_phn_head_step(st, a, jopt, 8)(_j(tok), _j(head), jopt.init(_j(head)), _jnp(batch))
    th = _torch(head)
    tres = tac.make_phn_head_step(st, a, topt, 8)(_torch(tok), th, topt.init(th), _t(batch))
    assert float(tres[3]) == float(jacc)
    check_step((jh, js, jce), (tres[0], tres[1], tres[2]), head)


def test_vq_losses_straight_through(cfg):
    st = cfg.speech_tokenizer
    rng = np.random.default_rng(0)
    cb = rng.standard_normal((st.codebook_size, st.dim)).astype(np.float32)
    pre = rng.standard_normal((2, 10, st.dim)).astype(np.float32)
    mask = np.ones((2, 10), np.float32)
    mask[1, 6:] = 0
    jl = jax.value_and_grad(lambda c, h: sum(jac.vq_losses(c, h, jnp.asarray(mask))), argnums=(0, 1))
    (jv, (jgc, jgh)) = jl(jnp.asarray(cb), jnp.asarray(pre))
    tc, th = torch.tensor(cb, requires_grad=True), torch.tensor(pre, requires_grad=True)
    tv = sum(tac.vq_losses(tc, th, torch.from_numpy(mask)))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jgc), atol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), atol=1e-6)
    toks = np.asarray(jst.quantize(jnp.asarray(cb), jnp.asarray(pre)))
    assert float(tac.codebook_usage(torch.from_numpy(toks), st.codebook_size)) == float(
        jac.codebook_usage(jnp.asarray(toks), st.codebook_size))


# ----------------------------------------------------------------------------- distillation


@pytest.mark.parametrize("teacher_cfg_scale", [0.7, 0.0])
def test_distill_step_matches_with_injected_draws(cfg, teacher_cfg_scale):
    c = cfg.cfm
    teacher, batch = _cfm_setup(c, seed=2)
    student = jax.tree_util.tree_map(lambda x: x * np.float32(1.01), teacher)
    key = jax.random.PRNGKey(11)
    n = 2
    jres = jdist.make_distill_step(c, _jax_opt(), n, teacher_cfg_scale)(
        _j(student), _j(teacher), _jax_opt().init(_j(student)), _jnp(batch), key)
    k0, k1 = jax.random.split(key)
    draws = {"i": np.asarray(jax.random.randint(k0, (2,), 0, n)),
             "x0": np.asarray(jax.random.normal(k1, batch["mel"].shape, jnp.float32))}
    ts = _torch(student)
    tres = tdist.make_distill_step(c, _port_opt(), n, teacher_cfg_scale)(ts, _torch(teacher), _port_opt().init(ts),
                                                                        _t(batch), None, draws=_t(draws))
    check_step(jres, tres, student)


def test_guided_field_matches(cfg):
    c = cfg.cfm
    jp, batch = _cfm_setup(c, seed=4)
    rng = np.random.default_rng(3)
    F = batch["mel"].shape[1]
    x = rng.standard_normal(batch["mel"].shape).astype(np.float32)
    t = np.asarray([0.2, 0.6], np.float32)
    tc = rng.standard_normal((2, F, c.dim)).astype(np.float32)
    pmel = batch["mel"] * batch["prompt_mask"][..., None]
    args = (x, t, tc, batch["spk"], pmel, batch["prompt_mask"], batch["frame_mask"])
    want = jdist.guided_field(_j(jp), c, 0.7, *map(jnp.asarray, args))
    got = tdist.guided_field(_torch(jp), c, 0.7, *(torch.from_numpy(np.array(a)) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------------- the kernels have no backward


def _wrapper_calls(requires_grad: bool):
    """Each kernel wrapper with small CPU inputs, one of them requiring grad."""
    from autostyle_tts_tpu_torch.ops import decode_step, flash_attn, log_mel

    g = torch.Generator().manual_seed(0)
    rg = lambda *s: torch.randn(s, generator=g).requires_grad_(requires_grad)
    q, k, v = rg(1, 8, 2, 16), torch.randn(1, 8, 2, 16), torch.randn(1, 8, 2, 16)
    D, H, hd, F, S = 32, 2, 16, 64, 8
    i8 = lambda *s: torch.randint(-127, 128, s, dtype=torch.int8, generator=g)
    yield "flash_attention", lambda: flash_attn.flash_attention(q, k, v, torch.zeros(1, dtype=torch.int32))
    frames = rg(1, 4, 16)
    yield "fused_log_mel", lambda: log_mel.fused_log_mel(frames, torch.randn(16, 9), torch.randn(16, 9),
                                                         torch.rand(9, 4))
    h = lambda: torch.randn(1, D, generator=g).bfloat16().requires_grad_(requires_grad)
    kc, vc = torch.zeros(S, H * hd, dtype=torch.bfloat16), torch.zeros(S, H * hd, dtype=torch.bfloat16)
    yield "attn_step", lambda: decode_step.attn_step(
        h(), torch.ones(D), i8(3 * H * hd, D), torch.rand(3 * H * hd) * 0.01, i8(D, H * hd), torch.rand(D) * 0.01,
        torch.rand(hd // 2), kc, vc, 2, 0, n_heads=H, head_dim=hd, eps=1e-5)
    yield "mlp_step", lambda: decode_step.mlp_step(h(), torch.ones(D), i8(2 * F, D), torch.rand(2 * F) * 0.01,
                                                   i8(D, F), torch.rand(D) * 0.01, eps=1e-5)
    mp = {"attn_norm": torch.ones(1, D).requires_grad_(requires_grad)}
    yield "mega_decode_step", lambda: decode_step.mega_decode_step(
        torch.zeros(1, dtype=torch.int32), mp, torch.zeros(1, S, H * hd), torch.zeros(1, S, H * hd), 0, 0, False, 0,
        n_heads=H, head_dim=hd, eps=1e-5, pad_id=0, bos_id=1, eos_id=2)


def test_kernel_wrappers_refuse_inputs_that_need_grad():
    """Under grad mode a wrapper given an input that requires grad raises
    before it picks the kernel or its plain version (the CUDA kernels have
    no backward; on the card the gradient would be cut silently)."""
    names = []
    for name, call in _wrapper_calls(requires_grad=True):
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            call()
        names.append(name)
    assert names == ["flash_attention", "fused_log_mel", "attn_step", "mlp_step", "mega_decode_step"]
    # under no_grad the same calls pass the guard and run their plain versions
    with torch.no_grad():
        for name, call in list(_wrapper_calls(requires_grad=True))[:4]:
            call()


def test_kernel_wrappers_run_under_grad_mode_without_grad_inputs():
    for name, call in list(_wrapper_calls(requires_grad=False))[:4]:
        assert torch.is_grad_enabled()
        call()


def test_mel_loss_differentiates_without_the_kernel(cfg, monkeypatch):
    """The vocoder's mel term takes the plain spectrogram: its gradient is
    nonzero and equals JAX's, and the kernel wrapper is never called."""
    from autostyle_tts_tpu_torch.models import vocoder as tvoc
    from autostyle_tts_tpu_torch.ops import stft as tstft

    def never(*a, **k):
        raise AssertionError("the mel loss called the log-mel kernel's wrapper")

    monkeypatch.setattr(tstft, "fused_log_mel", never)
    a = cfg.audio
    b = _voc_batch(cfg)
    pred = torch.from_numpy(b["wav"][::-1].copy()).requires_grad_(True)
    loss = tvoc.mel_l1_loss(pred, torch.from_numpy(b["wav"]), a.sample_rate, a.n_fft, a.hop_length, cfg.vocoder.n_mels)
    loss.backward()
    jg = jax.grad(lambda x: jvoc.mel_l1_loss(x, jnp.asarray(b["wav"]), a.sample_rate, a.n_fft, a.hop_length,
                                              cfg.vocoder.n_mels))(jnp.asarray(b["wav"][::-1].copy()))
    assert float(pred.grad.abs().max()) > 0
    np.testing.assert_allclose(pred.grad.numpy(), np.asarray(jg), atol=1e-4 * float(np.abs(jg).max()))
