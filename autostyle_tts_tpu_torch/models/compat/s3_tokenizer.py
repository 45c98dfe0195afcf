"""Whisper-encoder speech tokenizer compat (speech_tokenizer_v1.onnx).

Counterpart of the JAX ``models/compat/s3_tokenizer.py``. The CosyVoice
release tokenizes prompt wavs with an ONNX export of a Whisper-style audio
encoder + vector quantizer (the "S3 tokenizer"); its converted weights
serve a converted engine from wavs:

    log-mel (16 kHz, 100 Hz frames)
    -> conv1 (k3, s1) + GELU -> conv2 (k3, s2) + GELU        [50 Hz]
    -> + positional table
    -> pre-LN transformer blocks (q/v biased, k unbiased, GELU MLP)
    -> ln_post -> VQ nearest-codebook lookup -> token ids

The log-mel comes from ``ops/stft.log_mel_spectrogram`` (the fused log-mel
kernel on a CUDA tensor), called by ``CosyEngine.tokenize_wav16``.
Geometry is read off the converted tree. GELU is tanh-approximate, as
``jax.nn.gelu`` is by default.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

from ...ops.conv import conv1d

Params = Dict


@dataclass(frozen=True)
class S3TokenizerConfig:
    n_mels: int
    dim: int
    n_layers: int
    n_heads: int
    codebook_size: int
    conv2_stride: int = 2          # 100 Hz mel -> 50 Hz states


def infer_config(tree: Params, n_heads: int = 8) -> S3TokenizerConfig:
    lw = tree["blocks"]["q"]["w"]          # [L, D, D]
    return S3TokenizerConfig(
        n_mels=int(tree["conv1"]["w"].shape[1]),
        dim=int(lw.shape[1]),
        n_layers=int(lw.shape[0]),
        n_heads=n_heads,
        codebook_size=int(tree["codebook"].shape[0]),
    )


def _ln(x, p, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return (((xf - mu) * torch.rsqrt(var + eps)) * p["scale"] + p["bias"]).to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _sinusoid(length: int, dim: int, device) -> torch.Tensor:
    """Whisper's fixed positional table: sin/cos concat, log-spaced."""
    half = dim // 2
    scale = torch.exp(-math.log(10000.0) * torch.arange(half, device=device) / max(half - 1, 1))
    ang = torch.arange(length, device=device)[:, None] * scale[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


@torch.no_grad()
def encode_hidden(
    tree: Params,
    cfg: S3TokenizerConfig,
    mel: torch.Tensor,          # [B, T, n_mels] log-mel at 100 Hz
    mask: torch.Tensor,         # [B, T]
):
    """-> (hidden states before the VQ [B, T//stride, D], token_mask)."""
    # zero padded frames first: the k=3 convs' receptive fields would
    # otherwise leak pad content into the last real tokens
    mel = mel * mask[..., None]
    h = _gelu(conv1d(mel, tree["conv1"]))
    # EXPLICIT (1, 1) padding, not SAME: whisper's stride-2 conv is torch
    # Conv1d(k=3, stride=2, padding=1), whose windows anchor at -1, 1, 3, ...;
    # SAME pads (0, 1) for an even T and anchors at 0, 2, 4, ..., a
    # one-frame shift against the upstream weights
    h = _gelu(conv1d(h, tree["conv2"], stride=cfg.conv2_stride, padding=(1, 1)))
    B, T2, D = h.shape
    # prefer the exported positional table (if the ONNX carried it as an
    # initializer); fall back to the same fixed sinusoid whisper computes
    if "pos_emb" in tree:
        if tree["pos_emb"].shape[0] < T2:
            raise ValueError(f"s3 tokenizer: {T2} frames exceed the positional table's "
                             f"{tree['pos_emb'].shape[0]} rows")
        pe = tree["pos_emb"][:T2]
    else:
        pe = _sinusoid(T2, D, h.device)
    h = h + pe[None].to(h.dtype)
    m2 = mask[:, :: cfg.conv2_stride][:, :T2]
    H, hd = cfg.n_heads, cfg.dim // cfg.n_heads
    valid = m2[:, None, None, :] > 0
    blocks = tree["blocks"]
    for l in range(cfg.n_layers):
        lw = {k: {kk: vv[l] for kk, vv in v.items()} for k, v in blocks.items()}
        n = _ln(h, lw["attn_ln"])
        q = (n @ lw["q"]["w"] + lw["q"]["b"]).reshape(B, T2, H, hd)
        k = (n @ lw["k"]["w"]).reshape(B, T2, H, hd)       # whisper: no k bias
        v = (n @ lw["v"]["w"] + lw["v"]["b"]).reshape(B, T2, H, hd)
        s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / math.sqrt(hd)
        s = torch.where(valid, s, torch.full_like(s, -1e30))
        p = torch.softmax(s, dim=-1)
        att = torch.einsum("bhts,bshd->bthd", p, v.float())
        att = att.reshape(B, T2, D).to(h.dtype)
        h = h + att @ lw["out"]["w"] + lw["out"]["b"]
        n = _ln(h, lw["mlp_ln"])
        h = h + _gelu(n @ lw["mlp1"]["w"] + lw["mlp1"]["b"]) @ lw["mlp2"]["w"] + lw["mlp2"]["b"]
    return _ln(h, tree["ln_post"]), m2


def vq_distances(codebook: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances [B, T, K] of each state to each codebook row,
    as the VQ computes them."""
    cb = codebook.float()                                  # [K, D]
    hf = h.float()
    return (hf ** 2).sum(-1, keepdim=True) - 2.0 * hf @ cb.T + (cb ** 2).sum(-1)[None, None, :]


@torch.no_grad()
def encode(
    tree: Params,
    cfg: S3TokenizerConfig,
    mel: torch.Tensor,          # [B, T, n_mels] log-mel at 100 Hz
    mask: torch.Tensor,         # [B, T]
):
    """-> (tokens [B, T//stride] int32, token_mask [B, T//stride])."""
    h, m2 = encode_hidden(tree, cfg, mel, mask)
    # VQ: nearest codebook row by L2 (ties -> lowest id, like argmin)
    tokens = torch.argmin(vq_distances(tree["codebook"], h), dim=-1).to(torch.int32)
    return tokens * (m2 > 0), m2
