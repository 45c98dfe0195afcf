"""Causal left-pad-aware flash attention: CUDA kernel and its plain twin.

Counterpart of the JAX ``ops/pallas_attn.py::flash_attention``. The kernel
lives in ``csrc/flash_attn.cu``. A CPU tensor takes ``flash_attention_plain``
(the f32 ``sdpa`` under the causal + offset mask); a CUDA tensor launches the
kernel or raises. ``flash_attention.launches`` counts kernel launches. The
kernel has no backward: under grad mode an input that requires grad raises
(``cuda_build.forward_only``), on either device.
"""

from __future__ import annotations

import ctypes

import torch

from .attention import causal_mask, sdpa
from .cuda_build import check, forward_only, function

HEAD_DIMS = (16, 32, 64, 128)   # head widths the kernel is instantiated for
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, offset: torch.Tensor
) -> torch.Tensor:
    """Same function in plain PyTorch: keys j with offset[b] <= j <= t."""
    T, S = q.shape[1], k.shape[1]
    slot = torch.arange(S, device=q.device)
    valid = slot[None, :] >= offset.to(q.device).long()[:, None]
    mask = causal_mask(T, S, device=q.device) & valid[:, None, None, :]
    return sdpa(q, k, v, mask)


def launch_blocks(B: int, T: int, H: int) -> int:
    """Thread blocks one call launches on the card: one per (batch row,
    head, tile of query rows), the tile height asked of the built library."""
    rows = function("flash_attn", "flash_attn_block_rows", [])()
    return -(-T // rows) * H * B


def _launch(q, k, v, offset) -> torch.Tensor:
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous bf16 CUDA tensor")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd or H % K:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if offset.shape != (B,) or offset.dtype != torch.int32 or offset.device != q.device:
        raise ValueError("flash_attention: offset must be int32 [B] on q's device")
    offset = offset.contiguous()
    out = torch.empty_like(q)
    rc = function("flash_attn", "flash_attn_fwd", _ARGTYPES)(q.data_ptr(), k.data_ptr(), v.data_ptr(), offset.data_ptr(), out.data_ptr(),
            B, T, S, H, K, hd, hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    check(rc, "flash_attn_fwd")
    flash_attention.launches += 1
    return out


def flash_attention(
    q: torch.Tensor,        # [B, T, H, hd]
    k: torch.Tensor,        # [B, S, K, hd]
    v: torch.Tensor,
    offset: torch.Tensor,   # [B] int32, first valid key slot (left pad)
) -> torch.Tensor:
    """Returns [B, T, H, hd] in q.dtype. Rows t < offset[b] are pad rows
    whose values nobody reads."""
    forward_only("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, offset)
    return _launch(q, k, v, offset)


flash_attention.launches = 0

