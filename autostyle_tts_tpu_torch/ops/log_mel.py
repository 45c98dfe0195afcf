"""Fused log-mel spectrogram: CUDA kernel and its plain twin.

Counterpart of the JAX ``ops/pallas_mel.py::fused_log_mel``:

    log(max(((frames @ cos)^2 + (frames @ sin)^2) @ fb, eps))

The kernel lives in ``csrc/log_mel.cu`` and keeps the power spectrogram out
of device memory. It reads the frames by stride (the overlapping ``unfold``
view of a padded signal is not copied), takes the two bases in a packed,
zero-padded form that ``packed_basis`` builds once per pair of basis tensors,
and runs its products on the tensor cores in TF32 with both operands split
into a high and a low TF32 part (three products, f32 sums):
``fused_log_mel_split_emulation`` repeats that arithmetic in plain PyTorch.
CPU tensors take ``fused_log_mel_plain`` (three matrix products); any other
tensor launches the kernel or raises. ``fused_log_mel.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from .cuda_build import check, forward_only, function

# the kernel's tile: rows per block, bins per block, window samples per stage
TILE_ROWS, TILE_BINS, TILE_WIN = 32, 64, 128
PAIR_PAD = 8     # floats after each window pair's 4 * TILE_BINS: the kernel's bank-conflict-free row stride
MAX_MELS = 232   # a chunk's rows of fb lie in shared memory beside the ring of tiles


class _CPlan(ctypes.Structure):
    """``LogMelPlan`` of ``csrc/log_mel.cu``: what one geometry's calls share."""
    _fields_ = [("batch_stride", ctypes.c_longlong), ("frame_stride", ctypes.c_longlong),
                ("packed", ctypes.c_void_p), ("fb", ctypes.c_void_p),
                ("B", ctypes.c_int), ("T", ctypes.c_int), ("win", ctypes.c_int),
                ("n_bins", ctypes.c_int), ("n_mels", ctypes.c_int), ("eps", ctypes.c_float)]


_ARGTYPES = [ctypes.POINTER(_CPlan)] + [ctypes.c_void_p] * 5


class _Plan(NamedTuple):
    """One checked combination of (frames geometry, bases, fb, eps)."""
    refs: Tuple                 # weak references to cos_b, sin_b, fb
    versions: Tuple             # their in-place-change counters when checked
    packed: torch.Tensor        # kept alive: c_plan holds its address
    c_plan: _CPlan
    c_plan_ref: object          # ctypes.byref(c_plan)
    kernel: Callable[..., int]
    device: torch.device
    out_shape: Tuple[int, int, int]
    n_tiles: int
    n_partial: int


_packed: Dict[Tuple, Tuple] = {}     # basis pair -> (weak refs to the pair, packed tensor)
_plans: Dict[Tuple, Tuple] = {}      # checked (frames geometry, bases, fb) -> what a launch needs
_scratch: Dict[Tuple, Tuple] = {}    # (device, stream) -> (ticket counters, partial sums)
_kernel = None
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


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


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo) as the kernel splits an operand: hi is the nearest
    TF32 value (10 mantissa bits, ties away from zero), lo the exact rest
    ``x - hi`` cut to TF32's bits; ``hi + lo`` is ``x`` up to 2^-21 |x|."""
    hi = ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


def split_matmul(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``a @ b`` as the kernel's tensor-core product computes it: both
    operands split by ``tf32_split``, the products lo.hi + hi.lo + hi.hi
    summed in f32 (``passes=1``: hi.hi alone, plain TF32)."""
    (a_hi, a_lo), (b_hi, b_lo) = tf32_split(a), tf32_split(b)
    if passes == 1:
        return a_hi @ b_hi
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def fused_log_mel_split_emulation(frames, cos_b, sin_b, fb, eps: float = 1e-5, passes: int = 3):
    """The plain version with every product rounded as the kernel rounds it."""
    frames = frames.float()
    re = split_matmul(frames, cos_b, passes)
    im = split_matmul(frames, sin_b, passes)
    mel = split_matmul(re * re + im * im, fb, passes)
    return torch.log(torch.clamp_min(mel, eps))


def pack_basis(cos_b: torch.Tensor, sin_b: torch.Tensor) -> torch.Tensor:
    """[win, n_bins] cos and sin -> the kernel's layout
    [bin chunk, window pair, (cos TILE_BINS | sin TILE_BINS) x 2 + PAIR_PAD]:
    zero-padded to whole chunks of bins and whole stages of the window, two
    consecutive window samples of a column side by side, every row padded
    as it lies in shared memory (a stage's tile is one contiguous piece)."""
    win, n_bins = cos_b.shape
    n_chunks = -(-n_bins // TILE_BINS)
    win_pad = -(-win // TILE_WIN) * TILE_WIN
    both = torch.zeros((2, win_pad, n_chunks * TILE_BINS), dtype=torch.float32, device=cos_b.device)
    both[0, :win, :n_bins] = cos_b
    both[1, :win, :n_bins] = sin_b
    p = both.reshape(2, win_pad // 2, 2, n_chunks, TILE_BINS).permute(3, 1, 0, 4, 2)
    return torch.nn.functional.pad(p.reshape(n_chunks, win_pad // 2, 4 * TILE_BINS), (0, PAIR_PAD)).contiguous()


def unpack_basis(packed: torch.Tensor, win: int, n_bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``pack_basis``: -> (cos, sin), each [win, n_bins]."""
    n_chunks, pairs = packed.shape[:2]
    p = packed[..., :4 * TILE_BINS].reshape(n_chunks, pairs, 2, TILE_BINS, 2).permute(2, 1, 4, 0, 3)
    both = p.reshape(2, pairs * 2, n_chunks * TILE_BINS)
    return both[0, :win, :n_bins].contiguous(), both[1, :win, :n_bins].contiguous()


def packed_basis(cos_b: torch.Tensor, sin_b: torch.Tensor) -> torch.Tensor:
    """``pack_basis`` once per pair of basis tensors: the same two tensors,
    unchanged since, give the same packed tensor back."""
    key = (cos_b.data_ptr(), sin_b.data_ptr(), cos_b._version, sin_b._version,
           tuple(cos_b.shape), cos_b.device)
    hit = _packed.get(key)
    if hit is not None and hit[0]() is cos_b and hit[1]() is sin_b:
        return hit[2]
    for k in [k for k, v in _packed.items() if v[0]() is None or v[1]() is None]:
        del _packed[k]      # a freed tensor's address may come back with other values
    packed = pack_basis(cos_b, sin_b)
    _packed[key] = (weakref.ref(cos_b), weakref.ref(sin_b), packed)
    return packed


def _scratch_for(dev: torch.device, stream: int, n_tiles: int, n_partial: int):
    """(ticket counters, partial sums, their addresses) of one (device,
    stream), grown on demand: launches on one stream run in turn, so they
    may share both. The kernel leaves the counters zeroed."""
    have = _scratch.get((dev.index, stream))
    if have is None or have[0].numel() < n_tiles or have[1].numel() < n_partial:
        tickets = torch.zeros(max(n_tiles, 1024), dtype=torch.int32, device=dev)
        partial = torch.empty(max(n_partial, 1 << 20), dtype=torch.float32, device=dev)
        have = _scratch[(dev.index, stream)] = (tickets, partial, tickets.data_ptr(), partial.data_ptr())
    return have


def _entry_point():
    global _kernel
    if _kernel is None:
        layout = function("log_mel", "fused_log_mel_layout", [])()
        if layout != (TILE_ROWS | TILE_BINS << 8 | TILE_WIN << 16 | PAIR_PAD << 24):
            raise RuntimeError(f"fused_log_mel: csrc/log_mel.cu is built for another tile ({layout:#x})")
        _kernel = function("log_mel", "fused_log_mel", _ARGTYPES)
    return _kernel


def _plan(frames, cos_b, sin_b, fb, eps):
    """Check one combination of arguments and keep what a launch needs: the
    next call with the same geometry and the same (unchanged) basis and
    filterbank tensors skips the checks."""
    dev = frames.device
    if frames.ndim != 3 or cos_b.ndim != 2 or fb.ndim != 2:
        raise ValueError(f"fused_log_mel: need frames [B, T, win], bases [win, n_bins], fb [n_bins, n_mels]; got "
                         f"{tuple(frames.shape)}, {tuple(cos_b.shape)}, {tuple(fb.shape)}")
    B, T, win = frames.shape
    n_bins, n_mels = fb.shape
    if tuple(cos_b.shape) != (win, n_bins) or tuple(sin_b.shape) != (win, n_bins):
        raise ValueError(f"fused_log_mel: bases must be [{win}, {n_bins}], got {tuple(cos_b.shape)}, "
                         f"{tuple(sin_b.shape)}")
    for name, a in (("frames", frames), ("cos_b", cos_b), ("sin_b", sin_b), ("fb", fb)):
        if a.dtype != torch.float32 or a.device != dev:
            raise ValueError(f"fused_log_mel: {name} must be an f32 tensor on {dev}, got {a.dtype} on {a.device}")
    if not (cos_b.is_contiguous() and sin_b.is_contiguous() and fb.is_contiguous()):
        raise ValueError("fused_log_mel: cos_b, sin_b and fb must be contiguous")
    if B < 1 or T < 1 or win < 1 or n_bins < 1 or n_mels < 1:
        raise ValueError(f"fused_log_mel: empty shape {tuple(frames.shape)} x {tuple(fb.shape)}")
    if n_mels > MAX_MELS:
        raise ValueError(f"fused_log_mel: n_mels = {n_mels}, the kernel's shared-memory tile holds at most {MAX_MELS}")
    b_stride, t_stride, w_stride = frames.stride()
    if (win > 1 and w_stride != 1) or b_stride < 0 or t_stride < 0:
        raise ValueError(f"fused_log_mel: frames need a sample stride of 1 and batch / frame strides >= 0, "
                         f"got strides {frames.stride()}")
    if dev.type != "cuda":
        raise ValueError(f"fused_log_mel: no kernel for device {dev}")
    packed = packed_basis(cos_b, sin_b)
    c_plan = _CPlan(b_stride, t_stride, packed.data_ptr(), fb.data_ptr(), B, T, win, n_bins, n_mels, eps)
    n_tiles = -(-(B * T) // TILE_ROWS)
    n_partial = -(-n_bins // TILE_BINS) * n_tiles * TILE_ROWS * n_mels
    return _Plan((weakref.ref(cos_b), weakref.ref(sin_b), weakref.ref(fb)),
                 (cos_b._version, sin_b._version, fb._version), packed, c_plan, ctypes.byref(c_plan),
                 _entry_point(), dev, (B, T, n_mels), n_tiles, n_partial)


def _launch(frames, cos_b, sin_b, fb, eps) -> torch.Tensor:
    key = (frames.shape, frames.stride(), frames.dtype, frames.device, id(cos_b), id(sin_b), id(fb), eps)
    plan = _plans.get(key)
    # ids can come back after a tensor is freed: the weak references tell
    if (plan is None or any(ref() is not t for ref, t in zip(plan.refs, (cos_b, sin_b, fb)))
            or plan.versions != (cos_b._version, sin_b._version, fb._version)):
        if len(_plans) >= 64:
            _plans.clear()
        plan = _plans[key] = _plan(frames, cos_b, sin_b, fb, float(eps))
    dev = plan.device
    stream = _raw_stream(dev.index) if _raw_stream is not None else torch.cuda.current_stream(dev).cuda_stream
    _, _, tickets, partial = _scratch_for(dev, stream, plan.n_tiles, plan.n_partial)
    out = torch.empty(plan.out_shape, dtype=torch.float32, device=dev)
    check(plan.kernel(plan.c_plan_ref, frames.data_ptr(), partial, tickets, out.data_ptr(), stream),
          "fused_log_mel")
    fused_log_mel.launches += 1
    return out


def fused_log_mel(
    frames: torch.Tensor,   # [B, T, win] framed signal, any batch / frame stride (the window is folded into the bases)
    cos_b: torch.Tensor,    # [win, n_bins]
    sin_b: torch.Tensor,
    fb: torch.Tensor,       # [n_bins, n_mels]
    eps: float = 1e-5,
) -> torch.Tensor:
    """-> [B, T, n_mels] natural-log mel, f32."""
    forward_only("fused_log_mel", frames, cos_b, sin_b, fb)
    if frames.device.type == "cpu":
        return fused_log_mel_plain(frames, cos_b, sin_b, fb, eps)
    return _launch(frames, cos_b, sin_b, fb, eps)


fused_log_mel.launches = 0
