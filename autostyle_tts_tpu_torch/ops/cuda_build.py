"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/<name>-<hash>.so`` (the hash covers
the source and the flags, so an edited source rebuilds and a stale library
is never loaded). Sources expose a plain C interface; nothing here includes
PyTorch's headers, so one build takes seconds. ``build`` starts one nvcc per
missing library, all at once, and waits for them together. Nothing is built
or loaded when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNEL_SOURCES = ("flash_attn", "decode_step", "log_mel")

_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], Callable[..., int]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def _target(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Sequence[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Compile (in parallel) and load the named sources; returns the build
    seconds per library that had to be compiled. Raises with nvcc's output
    if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        if name in _loaded:
            continue
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    seconds = {}
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n{out.with_suffix('.log').read_text()}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    for name in names:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(_target(name)))
    return seconds


def library(name: str) -> ctypes.CDLL:
    if name not in _loaded:
        build([name])
    return _loaded[name]


def function(lib: str, name: str, argtypes: Sequence) -> Callable[..., int]:
    """The C entry point ``name`` of library ``lib``, its argument types set
    once (it returns a cudaError_t as int)."""
    key = (lib, name)
    if key not in _functions:
        fn = getattr(library(lib), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return _functions[key]


def build_log(name: str) -> str:
    """nvcc/ptxas output (registers, shared memory, spills) of a library
    built in this checkout, or '' if it was not built here."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(rc: int, what: str) -> None:
    """Raise when a launcher returned a non-zero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def forward_only(what: str, *tensors) -> None:
    """The kernels have no backward: their wrappers hand raw pointers to
    CUDA and return tensors autograd cannot follow, so a gradient through
    them would be cut without a word. A wrapper calls this first, before it
    picks the kernel or the plain version, and raises where grad mode is on
    and an input requires grad (run it under ``torch.no_grad()``, or take the
    plain differentiable function: ``ops/stft.log_mel_spectrogram_plain``,
    ``transformer.forward`` with a ``mask``)."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no backward: an input requires grad under grad mode")
