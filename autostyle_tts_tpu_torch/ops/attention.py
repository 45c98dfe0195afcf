"""Attention helpers: RoPE tables, plain scaled-dot-product attention, masks.

Counterpart of the JAX ``ops/attention.py``. Layout as there: q
``[B, T, H, hd]``, k/v ``[B, S, K, hd]``, ``H % K == 0``. ``sdpa`` is the
plain attention the CFM uses and the flash kernel's plain reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def rope_inv_freq(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """[head_dim//2] rotate-half inverse frequencies (f32), the one definition
    shared by the prefill tables and the decode kernel's in-kernel rows."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_table(
    max_len: int, head_dim: int, theta: float = 10000.0, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables, each [max_len, head_dim//2] f32."""
    inv = rope_inv_freq(head_dim, theta, device)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    ang = torch.outer(t, inv)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(
    x: torch.Tensor,          # [B, T, H, hd]
    cos: torch.Tensor,        # [max_len, hd//2]
    sin: torch.Tensor,
    positions: torch.Tensor,  # [B, T] absolute positions
) -> torch.Tensor:
    """Rotate-half RoPE; computes in f32 and returns x.dtype."""
    c = cos[positions][:, :, None, :]
    s = sin[positions][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, kh, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n_rep, d).reshape(b, s, kh * n_rep, d)


def sdpa(
    q: torch.Tensor,                       # [B, T, H, hd]
    k: torch.Tensor,                       # [B, S, K, hd]
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,   # [B, 1|H, T, S] bool, True = attend
) -> torch.Tensor:
    """Plain attention in f32; returns q.dtype. Masked logits are -1e30, so a
    fully masked row averages its values, as the JAX reference does."""
    h, kh = q.shape[2], k.shape[2]
    k = _repeat_kv(k, h // kh)
    v = _repeat_kv(v, h // kh)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs, v.float())
    return out.to(q.dtype)


def causal_mask(t: int, s: int, offset: int = 0, device=None) -> torch.Tensor:
    """[1, 1, T, S]: query i attends key j iff j <= i + offset."""
    qi = torch.arange(t, device=device)[:, None] + offset
    kj = torch.arange(s, device=device)[None, :]
    return (kj <= qi)[None, None, :, :]
