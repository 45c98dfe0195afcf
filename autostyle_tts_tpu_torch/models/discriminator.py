"""GAN discriminators for vocoder training: multi-period + multi-scale.

Counterpart of the JAX ``models/discriminator.py``, the HiFi-GAN ensemble:

- MPD: per period (2, 3, 5, 7, 11) the waveform folded into [T/p, p]
  planes through strided (5, 1) convolutions;
- MSD: 1-D conv stacks on the waveform average-pooled x1, x2 and x4.

Losses: LSGAN adversarial and feature matching. Weights keep the JAX
layout: a 2-D conv's ``w`` [kh, kw, C_in, C_out], a 1-D conv's
[k, C_in, C_out]; convolutions pad as XLA's SAME rule does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..ops.conv import conv1d, conv1d_init
from ..weights import uniform

PERIODS = (2, 3, 5, 7, 11)


def _conv2d_init(generator: torch.Generator, in_ch: int, out_ch: int, kh: int, kw: int) -> Dict:
    std = 1.0 / math.sqrt(in_ch * kh * kw)
    return {"w": uniform((kh, kw, in_ch, out_ch), generator, -std, std),
            "b": uniform((out_ch,), generator, -std, std)}


def _same(n: int, k: int, stride: int) -> Tuple[int, int]:
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv2d(x: torch.Tensor, p: Dict, stride_h: int = 1) -> torch.Tensor:
    """NHWC in and out, SAME padding, stride (stride_h, 1), f32."""
    kh, kw = p["w"].shape[:2]
    top, bottom = _same(x.shape[1], kh, stride_h)
    left, right = _same(x.shape[2], kw, 1)
    xt = F.pad(x.float().permute(0, 3, 1, 2), (left, right, top, bottom))
    y = F.conv2d(xt, p["w"].float().permute(3, 2, 0, 1), p["b"].float(), stride=(stride_h, 1))
    return y.permute(0, 2, 3, 1).to(x.dtype)


def init_params(generator: torch.Generator) -> Dict:
    p: Dict = {"mpd": [], "msd": []}
    chans = (32, 128, 512, 1024)
    for _ in PERIODS:
        convs, in_ch = [], 1
        for ch in chans:
            convs.append(_conv2d_init(generator, in_ch, ch, 5, 1))
            in_ch = ch
        p["mpd"].append({"convs": convs, "post": _conv2d_init(generator, in_ch, 1, 3, 1)})
    for _ in range(3):
        convs = [conv1d_init(generator, 1, 64, 15), conv1d_init(generator, 64, 128, 41),
                 conv1d_init(generator, 128, 256, 41), conv1d_init(generator, 256, 512, 41),
                 conv1d_init(generator, 512, 512, 5)]
        p["msd"].append({"convs": convs, "post": conv1d_init(generator, 512, 1, 3)})
    return p


def _mpd_one(params: Dict, wav: torch.Tensor, period: int):
    B, T = wav.shape
    x = F.pad(wav, (0, (-T) % period)).reshape(B, -1, period, 1)
    feats = []
    for conv in params["convs"]:
        x = F.leaky_relu(_conv2d(x, conv, stride_h=3), 0.1)
        feats.append(x)
    return _conv2d(x, params["post"]).reshape(B, -1), feats


def _msd_one(params: Dict, wav: torch.Tensor):
    x = wav[..., None]
    feats = []
    for conv, s in zip(params["convs"], (1, 4, 4, 4, 1)):
        x = F.leaky_relu(conv1d(x, conv, stride=s), 0.1)
        feats.append(x)
    return conv1d(x, params["post"]).reshape(wav.shape[0], -1), feats


def _avg_pool2(wav: torch.Tensor) -> torch.Tensor:
    T = wav.shape[-1] // 2 * 2
    return wav[..., :T].reshape(wav.shape[0], -1, 2).mean(-1)


def apply(params: Dict, wav: torch.Tensor) -> List[Tuple[torch.Tensor, list]]:
    """wav [B, T] -> (score map, feature list) of each sub-discriminator."""
    outs = [_mpd_one(sub, wav, period) for sub, period in zip(params["mpd"], PERIODS)]
    x = wav
    for sub in params["msd"]:
        outs.append(_msd_one(sub, x))
        x = _avg_pool2(x)
    return outs


def discriminator_loss(params: Dict, real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    loss = 0.0
    for (dr, _), (df, _) in zip(apply(params, real), apply(params, fake)):
        loss = loss + ((dr - 1.0) ** 2).mean() + (df ** 2).mean()
    return loss


def generator_adversarial_losses(params: Dict, real: torch.Tensor, fake: torch.Tensor):
    """(adversarial loss, feature-matching loss) for the generator."""
    adv, fm = 0.0, 0.0
    for (df, ff), (_, fr) in zip(apply(params, fake), apply(params, real)):
        adv = adv + ((df - 1.0) ** 2).mean()
        for a, b in zip(ff, fr):
            fm = fm + (a - b.detach()).abs().mean()
    return adv, fm
