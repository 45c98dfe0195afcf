"""CAM++ speaker-embedding compat (campplus.onnx) via graph execution.

Counterpart of the JAX ``models/compat/campplus.py``. The CosyVoice release
embeds timbre wavs with ``campplus.onnx``, a CAM++ D-TDNN export (upstream:
kaldi fbank(80, 16 kHz, dither 0) -> mean-normalize over time -> campplus
-> 192-d x-vector). Its initializer names cannot be mapped blind into a
rule table, so this compat runs the graph itself through
``ops/onnx_exec.OnnxRunner``: no name assumptions, any campplus-shaped
export whose ops the runner supports.

``kaldi_fbank`` is the kaldi algorithm as the JAX module computes it
(plain PyTorch there and here, outside any kernel): preemphasis 0.97,
25 ms / 10 ms povey-windowed frames (snip edges, per-frame DC removal),
a 512-bin left-aligned DFT as two matrix products, kaldi mel banks
(triangles linear in the mel domain, nyquist excluded), natural log with
the FLT_EPSILON floor, per-utterance mean subtraction, the float wav
consumed unscaled (the torchaudio.compliance.kaldi convention upstream
uses).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ...ops import onnx_exec
from ...ops.stft import frame_signal
from ...utils.onnx_load import OnnxGraph, load_onnx_graph

SAMPLE_RATE = 16000
FRAME_LEN = 400          # 25 ms
HOP = 160                # 10 ms
N_FFT = 512              # kaldi rounds the window up to the next pow2
N_MELS = 80


def _povey(n: int) -> np.ndarray:
    """Kaldi's povey window = hann^0.85."""
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
    return (hann ** 0.85).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mel_kaldi(sr: int, n_fft: int, n_mels: int, fmin: float = 20.0,
               fmax: Optional[float] = None) -> np.ndarray:
    """Kaldi triangular mel bank [n_bins, n_mels] (mel.cc semantics, peak
    1): triangles linear in the mel domain; the nyquist bin carries zero
    weight (kaldi iterates fft bins 0..n_fft/2-1 only)."""
    fmax = fmax or sr / 2.0
    n_bins = n_fft // 2 + 1

    def to_mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)

    mlo, mhi = to_mel(fmin), to_mel(fmax)
    mel_freqs = to_mel(np.arange(n_fft // 2) * sr / float(n_fft))
    delta = (mhi - mlo) / (n_mels + 1)
    fb = np.zeros((n_bins, n_mels), np.float64)
    for m in range(n_mels):
        left, center, right = mlo + m * delta, mlo + (m + 1) * delta, mlo + (m + 2) * delta
        up = (mel_freqs - left) / (center - left)
        down = (right - mel_freqs) / (right - center)
        fb[: n_fft // 2, m] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _fbank_basis():
    """(cos, sin) windowed DFT basis [FRAME_LEN, n_bins] with the povey
    window folded in (frames are not centred in the 512 frame: kaldi
    left-aligns and zero-pads the tail)."""
    n_bins = N_FFT // 2 + 1
    w = _povey(FRAME_LEN)
    t = np.arange(FRAME_LEN)
    k = np.arange(n_bins)
    ang = 2.0 * np.pi * np.outer(t, k) / N_FFT
    cos = (np.cos(ang) * w[:, None]).astype(np.float32)
    sin = (-np.sin(ang) * w[:, None]).astype(np.float32)
    return cos, sin


def kaldi_fbank(wav16: torch.Tensor) -> torch.Tensor:
    """[T] 16 kHz float wav -> [n_frames, 80] mean-normalized log-fbank
    (kaldi conventions: snip edges, per-frame DC removal, preemphasis 0.97,
    povey window, natural log; dither 0 as the upstream frontend sets)."""
    x = wav16.float()
    dev = x.device
    frames = frame_signal(x, FRAME_LEN, HOP)        # [F, 400], snip edges
    frames = frames - frames.mean(-1, keepdim=True)
    pre = torch.cat([frames[:, :1], frames[:, :-1]], dim=-1)
    frames = frames - 0.97 * pre
    cos_b, sin_b = (torch.from_numpy(b).to(dev) for b in _fbank_basis())
    re = frames @ cos_b
    im = frames @ sin_b
    power = re * re + im * im
    mel = power @ torch.from_numpy(_mel_kaldi(SAMPLE_RATE, N_FFT, N_MELS)).to(dev)
    feat = torch.log(torch.clamp(mel, min=1.1921e-07))    # kaldi's FLT_EPSILON
    return feat - feat.mean(0, keepdim=True)              # upstream CMN


class CampPlusCompat:
    """Graph-executed campplus.onnx -> x-vector on ``device``. Input
    convention follows the upstream frontend: feeds [1, n_frames, 80]
    mean-normalized fbank to the graph's (single) input; returns the first
    output flattened."""

    def __init__(self, graph_or_bytes, device="cpu"):
        graph = (
            graph_or_bytes if isinstance(graph_or_bytes, OnnxGraph)
            else load_onnx_graph(graph_or_bytes)
        )
        if len(graph.inputs) != 1:
            raise ValueError(
                f"campplus graph: expected one input, got {graph.inputs}"
            )
        self.graph = graph
        self.device = torch.device(device)
        self.runner = onnx_exec.OnnxRunner(graph, self.device)
        # optional frame-count buckets (tail pad repeats the last frame,
        # which slightly biases the stats pooling — exact length is the
        # default)
        self.frame_buckets = (100, 200, 300, 500, 800, 1200, 2000)

    @property
    def input_name(self) -> str:
        return self.graph.inputs[0]

    @torch.no_grad()
    def embed_fbank(self, feat: torch.Tensor) -> np.ndarray:
        """[n_frames, 80] -> [emb_dim] (no padding — exact frame count)."""
        out = self.runner({self.input_name: feat[None]})[0]
        return out.float().cpu().numpy().reshape(-1)

    def embed_wav16(self, wav16: np.ndarray, bucket: bool = False) -> np.ndarray:
        """16 kHz wav -> x-vector, fbank + graph. bucket=True pads the
        frame count to the bucket family (CMN still runs on the real frames
        only)."""
        wav16 = np.asarray(wav16).reshape(-1)
        if wav16.size < FRAME_LEN:
            raise ValueError(
                f"speaker prompt too short: {wav16.size} samples < one "
                f"{FRAME_LEN}-sample (25 ms @ 16 kHz) analysis frame"
            )
        feat = kaldi_fbank(torch.from_numpy(np.ascontiguousarray(wav16, np.float32)).to(self.device))
        n = feat.shape[0]
        if bucket:
            w = next((b for b in self.frame_buckets if b >= n), None)
            if w is not None and w != n:
                feat = torch.cat([feat, feat[-1:].expand(w - n, feat.shape[1])], dim=0)
        return self.embed_fbank(feat)
