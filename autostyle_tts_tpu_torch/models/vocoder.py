"""Mel -> 24 kHz waveform vocoders, both kinds of the JAX ``models/vocoder.py``.

- ``hifigan``: pre-conv, then per upsampling stage a leaky ReLU (0.1), the
  transposed conv and the multi-receptive-field (MRF) average of the
  resblocks, then the post-conv and tanh (``init_params``, ``apply``).
- ``istft`` (Vocos-class): mel -> ConvNeXt-style frame-rate backbone ->
  (log-magnitude, phase) -> GEMM iSTFT (``init_params_istft``,
  ``apply_istft``).

Both map one mel frame onto ``total_upsample`` output samples. The
convolutions are plain PyTorch (cuDNN on the card), f32 throughout. The
training losses: ``multi_res_stft_loss`` and ``mel_l1_loss``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops.conv import (conv1d, conv1d_init, conv_transpose1d, conv_transpose1d_init,
                        layer_norm, layer_norm_init)
from ..ops.stft import istft_constants, istft_overlap_add, log_mel_spectrogram_plain, power_spectrogram
from ..utils.config import VocoderConfig
from ..weights import uniform

Params = Dict


def _is_istft(cfg: VocoderConfig) -> bool:
    return getattr(cfg, "kind", "hifigan") == "istft"


def init_params(cfg: VocoderConfig, generator: torch.Generator) -> Params:
    if _is_istft(cfg):
        return init_params_istft(cfg, generator)
    n_up = len(cfg.upsample_rates)
    C = cfg.base_channels
    p: Params = {"pre": conv1d_init(generator, cfg.n_mels, C, 7), "ups": []}
    ch = C
    for i in range(n_up):
        out_ch = ch // 2
        up = {"t": conv_transpose1d_init(generator, ch, out_ch, cfg.upsample_kernel_sizes[i]),
              "mrf": []}
        for kern, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations):
            up["mrf"].append({"layers": [
                {"c1": conv1d_init(generator, out_ch, out_ch, kern),
                 "c2": conv1d_init(generator, out_ch, out_ch, kern)}
                for _ in dils]})
        p["ups"].append(up)
        ch = out_ch
    p["post"] = conv1d_init(generator, ch, 1, 7)
    return p


def apply(params: Params, cfg: VocoderConfig, mel: torch.Tensor) -> torch.Tensor:
    """[B, F, n_mels] -> [B, F * total_upsample(cfg)] waveform in [-1, 1]."""
    if _is_istft(cfg):
        return apply_istft(params, cfg, mel)
    h = conv1d(mel.float(), params["pre"])
    for i, up in enumerate(params["ups"]):
        h = F.leaky_relu(h, 0.1)
        h = conv_transpose1d(h, up["t"], stride=cfg.upsample_rates[i],
                             kernel=cfg.upsample_kernel_sizes[i])
        acc = None
        for mrf, dils in zip(up["mrf"], cfg.resblock_dilations):
            r = h
            for layer, d in zip(mrf["layers"], dils):
                x = conv1d(F.leaky_relu(r, 0.1), layer["c1"], dilation=d)
                r = r + conv1d(F.leaky_relu(x, 0.1), layer["c2"])
            acc = r if acc is None else acc + r
        h = acc / len(up["mrf"])
    wav = torch.tanh(conv1d(F.leaky_relu(h, 0.1), params["post"]))
    return wav[..., 0]


def constants(cfg: VocoderConfig, n_frames: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The tensors ``apply`` reads at ``n_frames`` frames besides its
    params and input (the iSTFT kind's kept bases and envelope), which a
    CUDA graph of it has to hold."""
    return istft_constants(device, n_frames, cfg.istft_n_fft, cfg.istft_hop) if _is_istft(cfg) else ()


def total_upsample(cfg: VocoderConfig) -> int:
    if _is_istft(cfg):
        return cfg.istft_hop
    return math.prod(cfg.upsample_rates)


# ----------------------------------------------------------------------- istft kind


def init_params_istft(cfg: VocoderConfig, generator: torch.Generator) -> Params:
    C = cfg.istft_channels
    n_bins = cfg.istft_n_fft // 2 + 1
    dev = generator.device

    def dense(i, o):
        std = 1.0 / math.sqrt(i)
        return {"w": uniform((i, o), generator, -std, std),
                "b": torch.zeros((o,), device=dev)}

    p: Params = {
        "pre": conv1d_init(generator, cfg.n_mels, C, 7),
        "blocks": [],
        "head": dense(C, 2 * n_bins),
    }
    for _ in range(cfg.istft_blocks):
        p["blocks"].append({
            "conv": conv1d_init(generator, C, C, cfg.istft_kernel),
            "ln": layer_norm_init(C, dev),
            "pw1": dense(C, 3 * C),
            "pw2": dense(3 * C, C),
        })
    return p


def apply_istft(params: Params, cfg: VocoderConfig, mel: torch.Tensor) -> torch.Tensor:
    """[B, F, n_mels] -> [B, F * istft_hop] waveform in [-1, 1], f32."""
    n_bins = cfg.istft_n_fft // 2 + 1
    h = conv1d(mel.float(), params["pre"])
    for blk in params["blocks"]:
        x = conv1d(h, blk["conv"], dilation=1)
        x = layer_norm(x, blk["ln"])
        x = F.gelu(x @ blk["pw1"]["w"] + blk["pw1"]["b"], approximate="tanh")
        x = x @ blk["pw2"]["w"] + blk["pw2"]["b"]
        h = h + x
    out = h @ params["head"]["w"] + params["head"]["b"]
    log_mag, phase = out[..., :n_bins], out[..., n_bins:]
    mag = torch.exp(torch.clamp(log_mag, -12.0, 6.0))
    wav = istft_overlap_add(mag * torch.cos(phase), mag * torch.sin(phase),
                            cfg.istft_n_fft, cfg.istft_hop)
    return torch.clamp(wav, -1.0, 1.0)


# ----------------------------------------------------------------------- losses


def multi_res_stft_loss(
    wav_pred: torch.Tensor, wav_true: torch.Tensor,
    resolutions: Tuple[Tuple[int, int, int], ...] = ((512, 128, 512), (1024, 256, 1024), (256, 64, 256)),
) -> torch.Tensor:
    """Spectral convergence + log-magnitude L1, averaged over the STFT
    resolutions (n_fft, hop, win)."""
    loss = 0.0
    for n_fft, hop, win in resolutions:
        sp = torch.sqrt(power_spectrogram(wav_pred, n_fft, hop, win) + 1e-9)
        st = torch.sqrt(power_spectrogram(wav_true, n_fft, hop, win) + 1e-9)
        sc = torch.linalg.norm(st - sp) / torch.clamp(torch.linalg.norm(st), min=1e-9)
        loss = loss + sc + (torch.log(st) - torch.log(sp)).abs().mean()
    return loss / len(resolutions)


def mel_l1_loss(wav_pred: torch.Tensor, wav_true: torch.Tensor, sr: int, n_fft: int, hop: int,
                n_mels: int) -> torch.Tensor:
    """Mean |log-mel(pred) - log-mel(true)| on the plain, differentiable
    spectrogram (``log_mel_spectrogram_plain``): the log-mel kernel has no
    backward."""
    mp = log_mel_spectrogram_plain(wav_pred, sr, n_fft, hop, n_mels=n_mels)
    mt = log_mel_spectrogram_plain(wav_true, sr, n_fft, hop, n_mels=n_mels)
    return (mp - mt).abs().mean()
