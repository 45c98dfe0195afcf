"""Polyphase resampler: one gather into windows plus one batched product.

Counterpart of the JAX ``ops/resample.py``. With (up, down) coprime, output
m uses phase r = m % up and the input window ending at B[r] + q*down for
q = m // up, so the resample is a gather into [Q, up, W] windows and an
einsum against the [up, W] phase-filter bank. ``resample_poly_np`` is the
numpy mirror (same filter, same phase) for host-side wavs.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from ..utils.device import upload


def _kaiser_beta(att_db: float) -> float:
    if att_db > 50:
        return 0.1102 * (att_db - 8.7)
    if att_db >= 21:
        return 0.5842 * (att_db - 21) ** 0.4 + 0.07886 * (att_db - 21)
    return 0.0


def _kaiser(n: int, beta: float) -> np.ndarray:
    return np.i0(beta * np.sqrt(1 - (2 * np.arange(n) / (n - 1) - 1) ** 2)) / np.i0(beta)


@functools.lru_cache(maxsize=None)
def design_lowpass(up: int, down: int, att_db: float = 60.0, width: int = 16) -> np.ndarray:
    """Windowed-sinc lowpass for rational resampling, cutoff at the lower
    Nyquist, gain ``up``. Odd length, centred at (n-1)/2. float64 [n_taps]."""
    cutoff = 0.5 / max(up, down)   # cycles/sample at the upsampled rate
    half = width * max(up, down)
    n = 2 * half + 1
    t = np.arange(n) - half
    h = 2 * cutoff * np.sinc(2 * cutoff * t)
    h *= _kaiser(n, _kaiser_beta(att_db))
    h *= up / np.sum(h)
    return h


def _rational(sr_in: int, sr_out: int) -> Tuple[int, int]:
    g = math.gcd(sr_in, sr_out)
    return sr_out // g, sr_in // g   # (up, down)


@functools.lru_cache(maxsize=None)
def _polyphase_plan(up: int, down: int, t_in: int):
    """(Hp [up, W], B [up], W, t_out, Q, pad_l, pad_r).

    Output m (= q*up + r) is y[m] = conv[half + m*down] of the zero-stuffed
    input with h; only every up-th tap meets a real sample:
        y[m] = sum_t h[phi_r + t*up] * x[b_m - t],
        phi_r = (half + r*down) % up,  b_m = q*down + B[r],
        B[r] = (half + r*down) // up.
    """
    h = design_lowpass(up, down)
    n_taps = len(h)
    half = (n_taps - 1) // 2
    t_out = -(-t_in * up // down)
    Q = -(-t_out // up)
    W = -(-n_taps // up)
    Hp = np.zeros((up, W), np.float32)
    B = np.zeros((up,), np.int64)
    for r in range(up):
        phi = (half + r * down) % up
        taps = h[phi::up]
        Hp[r, : len(taps)] = taps
        B[r] = (half + r * down) // up
    pad_l = W   # covers the negative indices (the least is -(W-1))
    max_idx = (Q - 1) * down + int(B.max())
    pad_r = max(0, max_idx - (t_in - 1))
    return Hp, B, W, t_out, Q, pad_l, pad_r


def _window_index(B: np.ndarray, W: int, Q: int, down: int, pad_l: int) -> np.ndarray:
    """idx[q, r, t] = pad_l + q*down + B[r] - t, the sample of the padded
    input that tap t of phase r meets for output q*up + r."""
    return (pad_l + np.arange(Q)[:, None, None] * down + B[None, :, None]
            - np.arange(W)[None, None, :])


def resample(x: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """[..., T] -> [..., ceil(T*up/down)], in x.dtype."""
    if sr_in == sr_out:
        return x
    up, down = _rational(sr_in, sr_out)
    t_in = x.shape[-1]
    Hp, B, W, t_out, Q, pad_l, pad_r = _polyphase_plan(up, down, t_in)
    lead = x.shape[:-1]
    xp = torch.nn.functional.pad(x.reshape(-1, t_in), (pad_l, pad_r))
    idx = upload(torch.from_numpy(_window_index(B, W, Q, down, pad_l)), x.device)
    windows = xp[:, idx]                                   # [N, Q, up, W]
    y = torch.einsum("nqrt,rt->nqr", windows.float(), upload(torch.from_numpy(Hp), x.device))
    y = y.reshape(-1, Q * up)[:, :t_out]
    return y.reshape(lead + (t_out,)).to(x.dtype)


def resample_poly_np(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Numpy mirror (float64 accumulation) for host-side wav loading."""
    if sr_in == sr_out:
        return x.astype(np.float32)
    up, down = _rational(sr_in, sr_out)
    Hp, B, W, t_out, Q, pad_l, pad_r = _polyphase_plan(up, down, len(x))
    xp = np.pad(x.astype(np.float64), (pad_l, pad_r))
    windows = xp[_window_index(B, W, Q, down, pad_l)]      # [Q, up, W]
    y = np.einsum("qrt,rt->qr", windows, Hp.astype(np.float64))
    return y.reshape(-1)[:t_out].astype(np.float32)
