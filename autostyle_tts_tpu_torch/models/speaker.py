"""Timbre encoder: mel -> L2-normalized speaker embedding (x-vector class).

Counterpart of the JAX ``models/speaker.py``: dilated conv1d (TDNN) trunk,
attentive statistics pooling over time (per channel, masked), linear head.
Padded frames are masked before and after every conv.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.conv import conv1d, conv1d_init, layer_norm, layer_norm_init
from ..utils.config import SpeakerEncoderConfig
from ..weights import normal

Params = Dict
NEG_INF = -1e30


def init_params(cfg: SpeakerEncoderConfig, generator: torch.Generator) -> Params:
    C = cfg.channels
    dev = generator.device
    p: Params = {
        "stem": conv1d_init(generator, cfg.n_mels, C, 5),
        "stem_ln": layer_norm_init(C, dev),
        "blocks": [],
        "att": conv1d_init(generator, C, C, 1),
        "att_v": conv1d_init(generator, C, C, 1),
        "head": {"w": normal((2 * C, cfg.emb_dim), generator, (2 * C) ** -0.5),
                 "b": torch.zeros((cfg.emb_dim,), device=dev)},
    }
    for _ in range(cfg.n_blocks):
        p["blocks"].append({
            "conv1": conv1d_init(generator, C, C, 3),
            "conv2": conv1d_init(generator, C, C, 3),
            "ln1": layer_norm_init(C, dev),
            "ln2": layer_norm_init(C, dev),
        })
    return p


def apply(
    params: Params,
    cfg: SpeakerEncoderConfig,
    mel: torch.Tensor,          # [B, T, n_mels]
    frame_mask: torch.Tensor,   # [B, T] 1 = real frame
) -> torch.Tensor:
    """-> [B, emb_dim] L2-normalized timbre embedding."""
    m = frame_mask[..., None].to(mel.dtype)
    h = conv1d(mel * m, params["stem"])
    h = torch.relu(layer_norm(h, params["stem_ln"])) * m
    for i, blk in enumerate(params["blocks"]):
        r = conv1d(h, blk["conv1"], dilation=2 ** i)
        r = torch.relu(layer_norm(r, blk["ln1"])) * m
        r = conv1d(r, blk["conv2"], dilation=2 ** i)
        r = torch.relu(layer_norm(r, blk["ln2"]))
        h = (h + r) * m
    # attentive statistics pooling: a softmax over TIME for each channel
    att = torch.tanh(conv1d(h, params["att"]))
    scores = conv1d(att, params["att_v"]).float()               # [B, T, C]
    scores = torch.where(m > 0, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=1)
    hf = h.float()
    mean = (w * hf).sum(1)                                      # [B, C]
    var = (w * hf * hf).sum(1) - mean * mean
    std = torch.sqrt(torch.clamp(var, min=1e-6))
    stats = torch.cat([mean, std], dim=-1)                      # [B, 2C]
    emb = stats @ params["head"]["w"] + params["head"]["b"]
    return emb * torch.rsqrt((emb * emb).sum(-1, keepdim=True) + 1e-12)
