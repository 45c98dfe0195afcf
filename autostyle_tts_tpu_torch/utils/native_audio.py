"""ctypes binding of the native C++ audio loader (``native/asttts_audio.cpp``).

Counterpart of the JAX package's ``utils/native_audio.py``: wav decode,
polyphase resampling and a threaded padded-batch loader in C++, host I/O
ahead of featurization. The port builds its own library from the tracked
source with ``g++`` into ``autostyle_tts_tpu_torch/_build/`` (gitignored),
named by a hash of the source and the flags, at the first call that needs
it, never when this module is imported. It neither runs ``make`` in
``native/`` nor loads the library there (built elsewhere, for another
host's instruction set). The filter taps come from the port's
``ops/resample.design_lowpass``, so the native and the numpy paths share
taps and phase. ``load_wav_fast`` decodes with numpy and resamples in
C++: on the H100's host the C++ resampler is 3.7-8.8 times numpy's and
the C++ decode slower than numpy's (``chip_smoke.py``'s ``wav loader``
line). Where the library cannot be had (``ASTTTS_NATIVE=0``, no ``g++``, a
failed build) it is ``utils/audio_io.load_wav``; ``available()`` says
which is live.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import wave
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..ops.resample import design_lowpass, resample_poly_np
from .audio_io import read_wav

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR.parent / "native" / "asttts_audio.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library for this source and these flags is built."""
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"asttts_audio-{digest}.so"


def _build(out: Path) -> bool:
    """Compile the source into ``out`` (through a file of this process's
    own, so concurrent builds never load a half-written library)."""
    cxx = shutil.which("g++")
    if cxx is None or not SOURCE.exists():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if r.returncode != 0:
        out.with_suffix(".log").write_text(r.stdout + r.stderr)
        return False
    os.replace(tmp, out)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None where it cannot be
    had (then the numpy loader serves)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("ASTTTS_NATIVE", "1") == "0" or not SOURCE.exists():
        return None
    out = library_path()
    if not out.exists() and not _build(out):
        return None
    try:
        lib = ctypes.CDLL(str(out))
    except OSError:
        return None
    f32p, f64p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double)
    lib.asttts_read_wav.restype = ctypes.c_int
    lib.asttts_read_wav.argtypes = [ctypes.c_char_p, f32p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_long)]
    lib.asttts_resample.restype = ctypes.c_int
    lib.asttts_resample.argtypes = [f32p, ctypes.c_long, f64p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
                                    f32p, ctypes.c_long]
    lib.asttts_load_batch.restype = ctypes.c_int
    lib.asttts_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      f64p, ctypes.c_long, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_long,
                                      ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native loader is live (else ``load_wav_fast`` is numpy's)."""
    return get_lib() is not None


def _need() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native audio library unavailable")
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _taps(up: int, down: int) -> np.ndarray:
    return np.ascontiguousarray(design_lowpass(up, down), np.float64)


def read_wav_native(path: str, max_seconds: float = 120.0) -> Tuple[np.ndarray, int]:
    """Native wav decode -> (mono float32, sample rate). Raises on failure."""
    lib = _need()
    # a sample takes at least one byte of the file: a buffer of the file's
    # size holds it (one of 120 s at 192 kHz made a 16 kHz prompt's decode
    # 8 times slower than numpy's on the H100's host)
    max_len = min(int(max_seconds * 192000), os.path.getsize(path))
    out = np.empty(max_len, np.float32)
    sr, n = ctypes.c_int(0), ctypes.c_long(0)
    rc = lib.asttts_read_wav(str(path).encode(), _fptr(out), max_len, ctypes.byref(sr), ctypes.byref(n))
    if rc != 0:
        raise OSError(f"asttts_read_wav({str(path)!r}) failed: {rc}")
    return out[: min(n.value, max_len)].copy(), sr.value


def resample_native(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Native polyphase resample, matching ``ops.resample.resample_poly_np``."""
    lib = _need()
    if sr_in == sr_out:
        return x.astype(np.float32)
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    taps = _taps(up, down)
    x = np.ascontiguousarray(x, np.float32)
    n_out = -(-len(x) * up // down)
    out = np.empty(n_out, np.float32)
    rc = lib.asttts_resample(_fptr(x), len(x), taps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(taps),
                             up, down, _fptr(out), n_out)
    if rc != 0:
        raise RuntimeError(f"asttts_resample failed: {rc}")
    return out


def load_batch_native(paths: List[str], target_sr: int, expect_sr: int, stride: int,
                      n_threads: int = 8) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode and resample a batch into one zero-padded [N, stride] buffer.
    Files at ``expect_sr`` are resampled, files at ``target_sr`` copied, any
    other rate fails for its row. -> (batch, lengths, status; 0 = ok)."""
    lib = _need()
    n = len(paths)
    g = math.gcd(expect_sr, target_sr)
    up, down = target_sr // g, expect_sr // g
    taps = _taps(up, down)
    out = np.zeros((n, stride), np.float32)
    lengths = np.zeros(n, np.int64)
    status = np.zeros(n, np.int32)
    names = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.asttts_load_batch(names, n, target_sr, expect_sr, taps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                          len(taps), up, down, _fptr(out), stride,
                          lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                          status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
    return out, lengths, status


def load_wav_fast(path: str, target_sr: int) -> np.ndarray:
    """A wav at ``target_sr`` (float32 mono): decoded by
    ``utils/audio_io.read_wav`` (IEEE-float files, which the ``wave`` module
    does not read, by the C++ decode where the library is live), resampled
    in C++ where the library is live, else as ``utils/audio_io.load_wav``
    does."""
    try:
        x, sr = read_wav(path)
    except wave.Error:
        if not available():
            raise
        x, sr = read_wav_native(path)
    if sr != target_sr and available():
        return resample_native(x, sr, target_sr)
    return resample_poly_np(x, sr, target_sr)
