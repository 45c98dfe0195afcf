"""GEMM iSTFT: inverse real DFT as two matmuls plus a windowed overlap-add.

Counterpart of the JAX ``ops/stft.py`` (``_hann``, ``_istft_basis``,
``_ola_envelope``, ``istft_overlap_add``). The bases are built once per size
in numpy, as there.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _hann(n: int) -> np.ndarray:
    """Periodic Hann window."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _istft_basis(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, -sin) synthesis bases [n_bins, n_fft] with Hermitian weights,
    1/N and the Hann synthesis window folded in."""
    n_bins = n_fft // 2 + 1
    w = _hann(n_fft)
    a = np.full(n_bins, 2.0)
    a[0] = 1.0
    if n_fft % 2 == 0:
        a[-1] = 1.0
    k = np.arange(n_bins)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    cos = (a[:, None] * np.cos(ang) / n_fft * w[None, :]).astype(np.float32)
    msin = (-a[:, None] * np.sin(ang) / n_fft * w[None, :]).astype(np.float32)
    return cos, msin


@functools.lru_cache(maxsize=None)
def _ola_envelope(n_frames: int, n_fft: int, hop: int) -> np.ndarray:
    """Overlap-added squared window [(F + R - 1) * hop]."""
    w2 = _hann(n_fft) ** 2
    r = n_fft // hop
    out = np.zeros((n_frames + r - 1) * hop, np.float32)
    for f in range(n_frames):
        out[f * hop : f * hop + n_fft] += w2
    return out


def istft_overlap_add(
    spec_r: torch.Tensor,   # [..., F, n_bins]
    spec_i: torch.Tensor,
    n_fft: int,
    hop: int,
) -> torch.Tensor:
    """-> [..., F * hop] samples; frame f is centred on output block f."""
    if n_fft % hop:
        raise ValueError(f"n_fft {n_fft} must be a multiple of hop {hop}")
    r_chunks = n_fft // hop
    F = spec_r.shape[-2]
    dev = spec_r.device
    cos_b, msin_b = (torch.from_numpy(b).to(dev) for b in _istft_basis(n_fft))
    frames = spec_r.float() @ cos_b + spec_i.float() @ msin_b     # [..., F, n_fft]
    lead = frames.shape[:-2]
    L = (F + r_chunks - 1) * hop
    out = torch.zeros(lead + (L,), dtype=torch.float32, device=dev)
    for r in range(r_chunks):
        seg = frames[..., :, r * hop : (r + 1) * hop].reshape(lead + (F * hop,))
        out[..., r * hop : r * hop + F * hop] += seg
    env = torch.from_numpy(_ola_envelope(F, n_fft, hop)).to(dev)
    out = out / torch.clamp(env, min=1e-8)
    start = (n_fft - hop) // 2
    return out[..., start : start + F * hop]
