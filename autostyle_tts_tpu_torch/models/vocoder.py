"""iSTFT vocoder (Vocos-class): mel -> ConvNeXt-style frame-rate backbone ->
(log-magnitude, phase) -> GEMM iSTFT.

Counterpart of the ``istft`` kind of the JAX ``models/vocoder.py``
(``init_params_istft``, ``apply_istft``). The ``hifigan`` kind is not ported
yet (ROADMAP.md queue A).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..ops.conv import conv1d, conv1d_init, layer_norm, layer_norm_init
from ..ops.stft import istft_overlap_add
from ..utils.config import VocoderConfig
from ..weights import uniform

Params = Dict


def _require_istft(cfg: VocoderConfig) -> None:
    if getattr(cfg, "kind", "hifigan") != "istft":
        raise NotImplementedError(
            f"vocoder kind {cfg.kind!r}: the port has the istft vocoder only; "
            "the hifigan kind is ROADMAP.md queue A"
        )


def init_params(cfg: VocoderConfig, generator: torch.Generator) -> Params:
    _require_istft(cfg)
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


def total_upsample(cfg: VocoderConfig) -> int:
    _require_istft(cfg)
    return cfg.istft_hop


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


def apply(params: Params, cfg: VocoderConfig, mel: torch.Tensor) -> torch.Tensor:
    _require_istft(cfg)
    return apply_istft(params, cfg, mel)
