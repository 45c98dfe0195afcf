"""WAV I/O in pure numpy: PCM8/16/24/32 read, PCM16 write.

Counterpart of ``read_wav`` / ``write_wav`` / ``load_wav`` of the JAX
package's ``utils/audio_io.py``; ``load_wav`` is also the counterpart of
its native loader ``utils/native_audio.load_wav_fast`` (decode and resample
in numpy, not through the C++ library).
"""

from __future__ import annotations

import wave
from pathlib import Path
from typing import Tuple, Union

import numpy as np

PathLike = Union[str, Path]


def read_wav(path: PathLike) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono [T] in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def write_wav(path: PathLike, x: np.ndarray, sample_rate: int) -> None:
    """Write float mono [T] (or [1, T]) as PCM16 WAV."""
    x = np.asarray(x)
    if x.ndim == 2:
        x = x[0] if x.shape[0] <= 2 else x[:, 0]
    pcm = (np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def load_wav(path: PathLike, target_sr: int) -> np.ndarray:
    """Read a WAV file and resample it to ``target_sr`` -> float32 [T]."""
    x, sr = read_wav(path)
    if sr != target_sr:
        from ..ops.resample import resample_poly_np

        x = resample_poly_np(x, sr, target_sr)
    return x.astype(np.float32)
