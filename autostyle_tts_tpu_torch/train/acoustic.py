"""Training steps for the synthesis stack: token LM, CFM decoder, vocoder
(with or without its discriminators) and the speech tokenizer.

Counterpart of the JAX ``train/acoustic.py``. Each ``make_*_step`` returns a
functional step with the JAX contract, for example
``step(params, opt_state, batch, generator) -> (params, opt_state, loss)``:
the parameters are leaf tensors that the step differentiates with
``torch.autograd`` (a copy of each that requires grad; the caller's tensors
are never written) and replaces with new ones from the optimizer of
``train/optim.py``. Every random draw comes from the ``generator`` passed
to the step; the steps that draw also take the draws themselves
(``draws=`` / ``restart_idx=``), which is how the tests give both packages
the same ones. Each step keeps the global norm of its last gradient, before
clipping, as ``step.grad_norm`` (a device tensor).

- token LM: teacher-forced cross-entropy on speech continuations
  (``models/token_lm.lm_loss``), on the f32 master weights;
- CFM: the OT-CFM regression with conditioning dropout (``models/cfm.cfm_loss``);
- vocoder: multi-resolution STFT + mel L1 on the plain, differentiable
  spectrogram (``models/vocoder``); with ``make_vocoder_gan_steps`` also
  LSGAN and feature matching against ``models/discriminator.py``;
- speech tokenizer: VQ losses with the straight-through codebook, a
  phoneme head on the pre-VQ features, a usage EMA and dead-code restarts;
  ``make_phn_head_step`` fits a phoneme head alone on a frozen tokenizer.

The log-mel kernel has no backward and its wrapper refuses an input that
needs a gradient, so the tokenizer's input mel (a function of the batch
alone) is the only mel these steps take through it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models import cfm as cfm_lib
from ..models import discriminator as disc_lib
from ..models import speech_tokenizer as st_lib
from ..models import token_lm as tlm_lib
from ..models import vocoder as voc_lib
from ..ops import stft as stft_lib
from ..utils.config import CFMConfig, TokenLMConfig, VocoderConfig
from ..weights import normal
from .optim import GradientTransformation, apply_optimizer, default_optimizer, detached, value_and_grad  # noqa: F401


# ----------------------------------------------------------------------- token LM


def make_token_lm_step(cfg: TokenLMConfig, optimizer: GradientTransformation, remat: bool = True):
    def step(params, opt_state, batch, generator: Optional[torch.Generator] = None):
        def loss_fn(p):
            pre = tlm_lib.build_prefix(p, cfg, batch["text"], batch["text_len"], batch["style_tokens"],
                                       batch["style_len"], batch["spk"])
            return tlm_lib.lm_loss(p, cfg, pre, batch["targets"], batch["target_len"], remat=remat)

        loss, _, grads = value_and_grad(loss_fn, params)
        params, opt_state = apply_optimizer(step, optimizer, detached(params), grads, opt_state)
        return params, opt_state, loss

    return step


# ----------------------------------------------------------------------- CFM


def make_cfm_step(cfg: CFMConfig, optimizer: GradientTransformation, cond_drop_prob: float = 0.2):
    def step(params, opt_state, batch, generator: Optional[torch.Generator],
             draws: Optional[Dict[str, torch.Tensor]] = None):
        if draws is None:
            draws = cfm_lib.cfm_draws(generator, batch["mel"], cond_drop_prob)

        def loss_fn(p):
            cond = cfm_lib.upsample_tokens(p, batch["tokens"], cfg.upsample, cfg.token_vocab_size)
            return cfm_lib.cfm_loss(p, cfg, None, batch["mel"], cond, batch["spk"], batch["prompt_mask"],
                                    batch["frame_mask"], cond_drop_prob=cond_drop_prob, draws=draws).loss

        loss, _, grads = value_and_grad(loss_fn, params)
        params, opt_state = apply_optimizer(step, optimizer, detached(params), grads, opt_state)
        return params, opt_state, loss

    return step


# ----------------------------------------------------------------------- vocoder


def make_vocoder_step(cfg: VocoderConfig, optimizer: GradientTransformation, sr: int, n_fft: int, hop: int,
                      stft_weight: float = 1.0, mel_weight: float = 45.0):
    def step(params, opt_state, batch, generator: Optional[torch.Generator] = None):
        def loss_fn(p):
            wav_pred = voc_lib.apply(p, cfg, batch["mel"])
            wav_true = batch["wav"][:, : wav_pred.shape[1]]
            return (stft_weight * voc_lib.multi_res_stft_loss(wav_pred, wav_true)
                    + mel_weight * voc_lib.mel_l1_loss(wav_pred, wav_true, sr, n_fft, hop, cfg.n_mels))

        loss, _, grads = value_and_grad(loss_fn, params)
        params, opt_state = apply_optimizer(step, optimizer, detached(params), grads, opt_state)
        return params, opt_state, loss

    return step


def make_vocoder_gan_steps(cfg: VocoderConfig, gen_opt: GradientTransformation, disc_opt: GradientTransformation,
                           sr: int, n_fft: int, hop: int, adv_weight: float = 1.0, fm_weight: float = 2.0,
                           mel_weight: float = 45.0):
    """(generator_step, discriminator_step), the HiFi-GAN recipe: LSGAN +
    feature matching + mel L1 for G, LSGAN for D; D then G on each batch."""

    def disc_step(d_params, d_opt_state, g_params, batch, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            fake = voc_lib.apply(g_params, cfg, batch["mel"])
        real = batch["wav"][:, : fake.shape[1]]
        loss, _, grads = value_and_grad(lambda dp: disc_lib.discriminator_loss(dp, real, fake), d_params)
        d_params, d_opt_state = apply_optimizer(disc_step, disc_opt, detached(d_params), grads, d_opt_state)
        return d_params, d_opt_state, loss

    def gen_step(g_params, g_opt_state, d_params, batch, generator: Optional[torch.Generator] = None):
        d_params = detached(d_params)

        def loss_fn(gp):
            fake = voc_lib.apply(gp, cfg, batch["mel"])
            r = batch["wav"][:, : fake.shape[1]]
            adv, fm = disc_lib.generator_adversarial_losses(d_params, r, fake)
            mel = voc_lib.mel_l1_loss(fake, r, sr, n_fft, hop, cfg.n_mels)
            return adv_weight * adv + fm_weight * fm + mel_weight * mel

        loss, _, grads = value_and_grad(loss_fn, g_params)
        g_params, g_opt_state = apply_optimizer(gen_step, gen_opt, detached(g_params), grads, g_opt_state)
        return g_params, g_opt_state, loss

    return gen_step, disc_step


# ----------------------------------------------------------------------- tokenizer VQ


def _tokenizer_features(tok_params, st_cfg, a, batch) -> st_lib.TokenizeResult:
    """The tokenizer over the batch's 16 kHz wavs (the input mel through the
    log-mel kernel on the card: it depends on the batch alone)."""
    with torch.no_grad():
        mel16 = stft_lib.log_mel_spectrogram(
            batch["wav16"], a.prompt_sample_rate, a.prompt_n_fft, a.prompt_hop_length, a.prompt_win_length,
            n_mels=a.prompt_n_mels, fmax=a.prompt_fmax)
    frames = torch.arange(mel16.shape[1], device=mel16.device)[None, :]
    fmask = (frames < (batch["len"].long()[:, None] // a.prompt_hop_length) + 1).float()
    return st_lib.apply(tok_params, st_cfg, mel16, fmask)


def _phoneme_ce(logits: torch.Tensor, labels: torch.Tensor, lm: torch.Tensor, n_classes: int):
    """Masked cross-entropy and accuracy of frame logits against labels."""
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, torch.clamp(labels.long(), 0, n_classes - 1)[..., None])[..., 0]
    n = torch.clamp(lm.sum(), min=1.0)
    acc = ((torch.argmax(logits, -1) == labels.long()).float() * lm).sum() / n
    return (ce * lm).sum() / n, acc


def make_tokenizer_step(st_cfg, audio_cfg, optimizer: GradientTransformation, n_phoneme_classes: int,
                        aux_weight: float = 2.0, usage_decay: float = 0.98):
    """Speech-tokenizer training: the VQ-VAE losses plus a phoneme head on
    the pre-VQ encoding (cross-entropy against the 25 Hz labels), then on the
    updated codebook a usage EMA, and codes whose share fell below 1/(8V)
    re-seeded with valid encoder frames of the batch (restarted codes start
    at share 1/V).

    params: {"tok": speech-tokenizer params, "head": [D, n_classes]};
    usage: [V] EMA of code shares (``init_usage``); batch: {"wav16", "len",
    "phn"}. ``step(params, opt_state, usage, batch, generator,
    restart_idx=None) -> (params, opt_state, usage, loss, ce, acc,
    n_used)``; ``restart_idx`` [V] gives the frames the restarts draw."""
    a = audio_cfg
    V = st_cfg.codebook_size

    def step(params, opt_state, usage, batch, generator: Optional[torch.Generator],
             restart_idx: Optional[torch.Tensor] = None):
        def loss_fn(p):
            res = _tokenizer_features(p["tok"], st_cfg, a, batch)
            tmask = res.token_mask
            cb, commit = vq_losses(p["tok"]["codebook"], res.pre_vq, tmask.float())
            logits = res.pre_vq.float() @ p["head"]
            T = min(logits.shape[1], batch["phn"].shape[1])
            ce, acc = _phoneme_ce(logits[:, :T], batch["phn"][:, :T], tmask[:, :T].float(), n_phoneme_classes)
            return cb + commit + aux_weight * ce, (ce.detach(), acc.detach(), res.pre_vq.detach(), tmask)

        loss, (ce, acc, pre_vq, tmask), grads = value_and_grad(loss_fn, params, has_aux=True)
        params, opt_state = apply_optimizer(step, optimizer, detached(params), grads, opt_state)

        with torch.no_grad():
            codebook = params["tok"]["codebook"]
            tokens = st_lib.quantize(codebook, pre_vq)
            slots = torch.where(tmask, tokens.long(), torch.full_like(tokens.long(), V)).reshape(-1)
            hist = torch.zeros((V + 1,), dtype=torch.float32, device=codebook.device).index_add_(
                0, slots, torch.ones_like(slots, dtype=torch.float32))[:V]
            n_used = (hist > 0).sum().to(torch.int32)
            share = hist / torch.clamp(hist.sum(), min=1.0)
            usage = usage_decay * usage + (1.0 - usage_decay) * share
            dead = usage < (1.0 / (8.0 * V))
            flat = pre_vq.reshape(-1, pre_vq.shape[-1]).to(codebook.dtype)
            if restart_idx is None:
                weights = tmask.reshape(-1).float() + 1e-9     # valid frames; the rest at 1e-9
                restart_idx = torch.multinomial(weights, V, replacement=True, generator=generator)
            codebook = torch.where(dead[:, None], flat[restart_idx.long()], codebook)
            params = dict(params, tok=dict(params["tok"], codebook=codebook))
            usage = torch.where(dead, torch.full_like(usage, 1.0 / V), usage)
        return params, opt_state, usage, loss, ce, acc, n_used

    return step


def init_usage(st_cfg, device=None) -> torch.Tensor:
    """Uniform initial code-usage EMA for ``make_tokenizer_step``."""
    V = st_cfg.codebook_size
    return torch.full((V,), 1.0 / V, dtype=torch.float32, device=device)


def init_tokenizer_head(generator: torch.Generator, st_cfg, n_phoneme_classes: int) -> torch.Tensor:
    return normal((st_cfg.dim, n_phoneme_classes), generator, st_cfg.dim ** -0.5)


def make_phn_head_step(st_cfg, audio_cfg, optimizer: GradientTransformation, n_phoneme_classes: int):
    """Fit only a linear phoneme head on a frozen tokenizer: the phoneme
    recognizer of the intelligibility gate. ``step(tok_params, head,
    opt_state, batch) -> (head, opt_state, ce, acc)``."""
    a = audio_cfg

    def step(tok_params, head, opt_state, batch):
        with torch.no_grad():
            res = _tokenizer_features(tok_params, st_cfg, a, batch)
        feats = res.pre_vq.float()
        T = min(feats.shape[1], batch["phn"].shape[1])
        labels = batch["phn"][:, :T]
        lm = res.token_mask[:, :T].float()

        def loss_fn(h):
            ce, acc = _phoneme_ce(feats[:, :T] @ h, labels, lm, n_phoneme_classes)
            return ce, acc.detach()

        ce, acc, grads = value_and_grad(loss_fn, head, has_aux=True)
        head, opt_state = apply_optimizer(step, optimizer, head.detach(), grads, opt_state)
        return head, opt_state, ce, acc

    return step


def vq_losses(codebook: torch.Tensor, pre_vq: torch.Tensor, frame_mask: torch.Tensor,
              beta: float = 0.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codebook loss, commitment loss) of the VQ layer, straight through:
    the codebook is pulled toward the encoder outputs, the encoder commits
    to its chosen codes."""
    tokens = st_lib.quantize(codebook, pre_vq.detach())
    chosen = codebook[tokens.long()]
    m = frame_mask[..., None].float()
    n = torch.clamp(m.sum(), min=1.0)
    cb_loss = (m * (chosen - pre_vq.detach()) ** 2).sum() / n
    commit = (m * (chosen.detach() - pre_vq) ** 2).sum() / n
    return cb_loss, beta * commit


def codebook_usage(tokens: torch.Tensor, codebook_size: int) -> torch.Tensor:
    """Fraction of codebook entries hit in this batch (a collapse monitor)."""
    hits = torch.zeros((codebook_size,), dtype=torch.int64, device=tokens.device)
    hits.index_add_(0, tokens.reshape(-1).long(), torch.ones_like(tokens.reshape(-1), dtype=torch.int64))
    return (hits > 0).float().mean()
