"""Attention helpers: RoPE tables, plain scaled-dot-product attention over a
bf16 or an int8 KV cache, masks.

Counterpart of the JAX ``ops/attention.py``. Layout as there: q
``[B, T, H, hd]``, k/v ``[B, S, K, hd]``, ``H % K == 0`` (query head
h = k * rep + r reads kv head k). ``sdpa`` is the plain attention the CFM
and the scanned decode use and the flash kernel's plain reference;
``sdpa_quant`` reads an int8 cache written by ``quantize_kv``. A decode
step (T = 1) takes the same formulation: a one-query variant over the
cache's own layout, as the reference has, took 0.39-0.45 ms a call against
0.30-0.32 at a batch of 8 on an H100, with more launches
(``scripts/time_sdpa_decode.py``). A row whose every key is masked averages
its values, as the reference computes it (its logits are all -1e30, not
-inf). ``padding_mask`` is kept for parity with the reference; no path of
either package calls it.
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
    """Plain attention in f32; returns q.dtype. Masked logits are -1e30."""
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


def sdpa_quant(
    q: torch.Tensor,                       # [B, T, H, hd]
    kq: torch.Tensor,                      # [B, S, K, hd] int8
    ks: torch.Tensor,                      # [B, S, K] f32 per-position scales
    vq: torch.Tensor,                      # [B, S, K, hd] int8
    vs: torch.Tensor,                      # [B, S, K] f32
    mask: Optional[torch.Tensor] = None,   # [B, 1|H, T, S]
) -> torch.Tensor:
    """Attention over an int8 KV cache: the dots read the int8 values, k's
    scale applies to the logits after the q.k dot and v's scale to the
    probabilities before the p.v dot. f32; returns q.dtype."""
    rep = q.shape[2] // kq.shape[2]
    kq = _repeat_kv(kq, rep)
    vq = _repeat_kv(vq, rep)
    ks_h = ks.repeat_interleave(rep, dim=2).permute(0, 2, 1)[:, :, None, :]
    vs_h = vs.repeat_interleave(rep, dim=2).permute(0, 2, 1)[:, :, None, :]
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q.float(), kq.float()) * (scale * ks_h)
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1) * vs_h
    out = torch.einsum("bhts,bshd->bthd", probs, vq.float())
    return out.to(q.dtype)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T, K, hd] -> (int8 values, f32 scales [B, T, K]): absmax / 127
    floored at 1e-8, values rounded half to even and clipped to +-127."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def padding_mask(lengths: torch.Tensor, s: int) -> torch.Tensor:
    """[B] lengths -> [B, 1, 1, S] key-padding mask."""
    return (torch.arange(s, device=lengths.device)[None, :] < lengths[:, None])[:, None, None, :]


def causal_mask(t: int, s: int, offset: int = 0, device=None) -> torch.Tensor:
    """[1, 1, T, S]: query i attends key j iff j <= i + offset."""
    qi = torch.arange(t, device=device)[:, None] + offset
    kj = torch.arange(s, device=device)[None, :]
    return (kj <= qi)[None, None, :, :]
