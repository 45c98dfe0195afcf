"""GEMM-native mel/STFT frontend and iSTFT.

Counterpart of the JAX ``ops/stft.py``: the DFT is two matrix products
against a windowed cos/sin basis, the iSTFT two products plus a windowed
overlap-add. The bases are built once per size in numpy, as there, and
moved to a device once per (device, size).

``log_mel_spectrogram`` has no ``impl=`` switch: it always goes through
``ops/log_mel.fused_log_mel``, which launches the fused kernel for a CUDA
tensor and takes its plain version for a CPU tensor. Both JAX branches
compute this same function. The kernel has no backward: a loss that needs
the mel's gradient takes ``log_mel_spectrogram_plain``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import upload
from .log_mel import fused_log_mel


def _hann(n: int) -> np.ndarray:
    """Periodic Hann window."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_basis(n_fft: int, win_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT basis (cos, sin), each [win_length, n_bins]: a
    periodic Hann window folded in, the window centred inside the n_fft
    frame (np.fft.rfft of the zero-padded windowed frame)."""
    n_bins = n_fft // 2 + 1
    window = _hann(win_length)
    pad = (n_fft - win_length) // 2
    t = np.arange(win_length) + pad
    k = np.arange(n_bins)
    ang = 2.0 * np.pi * np.outer(t, k) / n_fft
    cos = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return cos, sin


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: Optional[float] = None
) -> np.ndarray:
    """Slaney-style triangular mel filterbank [n_bins, n_mels] (area-normed)."""
    fmax = fmax or sr / 2.0
    n_bins = n_fft // 2 + 1
    min_log_hz, min_log_mel, logstep = 1000.0, 15.0, np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                        3.0 * f / 200.0)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        200.0 * m / 3.0)

    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    fb = np.zeros((n_bins, n_mels), dtype=np.float64)
    for m in range(n_mels):
        lo, c, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(c - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - c, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    fb *= (2.0 / (hz_pts[2:] - hz_pts[:-2]))[None, :]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _dft_basis_on(device: torch.device, n_fft: int, win_length: int) -> Tuple[torch.Tensor, torch.Tensor]:
    cos_b, sin_b = _dft_basis(n_fft, win_length)
    return torch.from_numpy(cos_b).to(device), torch.from_numpy(sin_b).to(device)


@functools.lru_cache(maxsize=16)
def _mel_filterbank_on(device: torch.device, sr: int, n_fft: int, n_mels: int, fmin: float,
                       fmax: Optional[float]) -> torch.Tensor:
    return torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(device)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """[..., T] -> [..., n_frames, frame_length] strided frames (a view).
    Callers apply any centre padding themselves."""
    return x.unfold(-1, frame_length, hop)


def num_frames(
    t: int, n_fft: int, hop: int, win_length: Optional[int] = None, center: bool = True
) -> int:
    win_length = win_length or n_fft
    if center:
        t = t + 2 * (n_fft // 2)
    return 1 + (t - win_length) // hop


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis by ``pad`` on both sides (any rank). A pad
    as long as the signal or longer reflects again at each end, as numpy's
    (and so the reference's) ``pad(mode="reflect")`` does."""
    lead, T = x.shape[:-1], x.shape[-1]
    if pad >= T:
        idx = np.pad(np.arange(T), (pad, pad), mode="reflect")
        return x[..., upload(torch.from_numpy(idx), x.device)]
    y = F.pad(x.reshape(-1, 1, T), (pad, pad), mode="reflect")
    return y.reshape(lead + (y.shape[-1],))


def power_spectrogram(
    x: torch.Tensor, n_fft: int, hop: int, win_length: Optional[int] = None,
    center: bool = True,
) -> torch.Tensor:
    """[..., T] -> [..., n_frames, n_bins] power spectrogram via matmul DFT."""
    win_length = win_length or n_fft
    cos_b, sin_b = _dft_basis_on(x.device, n_fft, win_length)
    if center:
        x = _reflect_pad(x, n_fft // 2)
    frames = frame_signal(x.float(), win_length, hop)
    re = torch.matmul(frames, cos_b)
    im = torch.matmul(frames, sin_b)
    return re * re + im * im


def log_mel_spectrogram(
    x: torch.Tensor,
    sr: int,
    n_fft: int,
    hop: int,
    win_length: Optional[int] = None,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    center: bool = True,
    eps: float = 1e-5,
) -> torch.Tensor:
    """[..., T] -> [..., n_frames, n_mels] natural-log mel spectrogram
    through ``fused_log_mel`` (the kernel on a CUDA tensor). The frames are
    the overlapping view of the padded signal (frame stride ``hop``), never
    a copy."""
    win_length = win_length or n_fft
    cos_b, sin_b = _dft_basis_on(x.device, n_fft, win_length)
    fb = _mel_filterbank_on(x.device, sr, n_fft, n_mels, fmin, fmax)
    lead = x.shape[:-1]
    x = x.float().reshape(-1, x.shape[-1])
    if center:   # librosa/torch convention: reflect-pad n_fft//2 each side
        x = _reflect_pad(x, n_fft // 2)
    out = fused_log_mel(frame_signal(x.contiguous(), win_length, hop), cos_b, sin_b, fb, eps=eps)
    return out.reshape(lead + out.shape[-2:])


def log_mel_spectrogram_plain(
    x: torch.Tensor,
    sr: int,
    n_fft: int,
    hop: int,
    win_length: Optional[int] = None,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    center: bool = True,
    eps: float = 1e-5,
) -> torch.Tensor:
    """``log_mel_spectrogram`` in plain PyTorch ops that autograd follows,
    never through the kernel: the training losses' mel (the reference's
    ``impl="xla"`` path). Same function, same arguments."""
    spec = power_spectrogram(x, n_fft, hop, win_length, center)
    fb = _mel_filterbank_on(x.device, sr, n_fft, n_mels, fmin, fmax)
    return torch.log(torch.clamp_min(torch.matmul(spec, fb), eps))


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


@functools.lru_cache(maxsize=8)
def _istft_basis_on(device: torch.device, n_fft: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return tuple(upload(torch.from_numpy(b), device) for b in _istft_basis(n_fft))


@functools.lru_cache(maxsize=32)
def _ola_envelope_on(device: torch.device, n_frames: int, n_fft: int, hop: int) -> torch.Tensor:
    """The overlap-added squared window, floored at 1e-8, on ``device``."""
    return upload(torch.from_numpy(np.maximum(_ola_envelope(n_frames, n_fft, hop), np.float32(1e-8))), device)


def istft_constants(device: torch.device, n_frames: int, n_fft: int, hop: int) -> Tuple[torch.Tensor, ...]:
    """What ``istft_overlap_add`` reads besides its input, kept on
    ``device`` per (device, n_fft) and (device, frames, n_fft, hop): the
    synthesis bases (cos, -sin) and the floored envelope. A CUDA graph
    that replays the iSTFT holds them, since the caches may drop them."""
    return _istft_basis_on(device, n_fft) + (_ola_envelope_on(device, n_frames, n_fft, hop),)


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
    cos_b, msin_b, env = istft_constants(dev, F, n_fft, hop)
    frames = spec_r.float() @ cos_b + spec_i.float() @ msin_b     # [..., F, n_fft]
    lead = frames.shape[:-2]
    L = (F + r_chunks - 1) * hop
    out = torch.zeros(lead + (L,), dtype=torch.float32, device=dev)
    for r in range(r_chunks):
        seg = frames[..., :, r * hop : (r + 1) * hop].reshape(lead + (F * hop,))
        out[..., r * hop : r * hop + F * hop] += seg
    out = out / env
    start = (n_fft - hop) // 2
    return out[..., start : start + F * hop]
