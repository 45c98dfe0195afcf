"""Fused log-mel spectrogram: CUDA kernel and its plain twin.

Counterpart of the JAX ``ops/pallas_mel.py::fused_log_mel``:

    log(max(((frames @ cos)^2 + (frames @ sin)^2) @ fb, eps))

The kernel lives in ``csrc/log_mel.cu`` and keeps the power spectrogram out
of device memory. CPU tensors take ``fused_log_mel_plain`` (three matrix
products); a CUDA tensor launches the kernel or raises.
``fused_log_mel.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import check, function

SMEM_BYTES = 48 * 1024   # dynamic shared memory the kernel may use per block
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


def fused_log_mel_plain(
    frames: torch.Tensor, cos_b: torch.Tensor, sin_b: torch.Tensor, fb: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Same function in plain PyTorch (f32 throughout)."""
    frames = frames.float()
    re = torch.matmul(frames, cos_b)
    im = torch.matmul(frames, sin_b)
    mel = torch.matmul(re * re + im * im, fb)
    return torch.log(torch.clamp_min(mel, eps))


def _launch(frames, cos_b, sin_b, fb, eps) -> torch.Tensor:
    dev = frames.device
    if frames.ndim != 3:
        raise ValueError(f"fused_log_mel: frames must be [B, T, win], got {tuple(frames.shape)}")
    B, T, win = frames.shape
    n_bins, n_mels = fb.shape
    want = {"frames": (frames, (B, T, win)), "cos_b": (cos_b, (win, n_bins)),
            "sin_b": (sin_b, (win, n_bins)), "fb": (fb, (n_bins, n_mels))}
    for name, (a, shape) in want.items():
        if tuple(a.shape) != shape or a.dtype != torch.float32 or a.device != dev or not a.is_contiguous():
            raise ValueError(f"fused_log_mel: {name} must be a contiguous f32 {shape} tensor on {dev}, "
                             f"got {a.dtype} {tuple(a.shape)} on {a.device}")
    if B < 1 or T < 1 or B > 65535:
        raise ValueError(f"fused_log_mel: need 1 <= B <= 65535 and T >= 1, got B={B}, T={T}")
    lib_smem = function("log_mel", "fused_log_mel_smem_bytes", [ctypes.c_int, ctypes.c_int])
    if lib_smem(win, n_mels) > SMEM_BYTES:
        raise ValueError(f"fused_log_mel: window {win} x {n_mels} mels needs {lib_smem(win, n_mels)} "
                         f"bytes of shared memory, the kernel is built for {SMEM_BYTES}")
    out = torch.empty((B, T, n_mels), dtype=torch.float32, device=dev)
    rc = function("log_mel", "fused_log_mel", _ARGTYPES)(
        frames.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(), fb.data_ptr(), out.data_ptr(),
        B, T, win, n_bins, n_mels, float(eps), torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "fused_log_mel")
    fused_log_mel.launches += 1
    return out


def fused_log_mel(
    frames: torch.Tensor,   # [B, T, win] framed signal (the window is folded into the bases)
    cos_b: torch.Tensor,    # [win, n_bins]
    sin_b: torch.Tensor,
    fb: torch.Tensor,       # [n_bins, n_mels]
    eps: float = 1e-5,
) -> torch.Tensor:
    """-> [B, T, n_mels] natural-log mel, f32."""
    if frames.device.type == "cpu":
        return fused_log_mel_plain(frames, cos_b, sin_b, fb, eps)
    return _launch(frames, cos_b, sin_b, fb, eps)


fused_log_mel.launches = 0
