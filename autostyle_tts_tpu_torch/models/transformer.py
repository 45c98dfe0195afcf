"""Decoder-only transformer core: the token LM's prefill.

Counterpart of the parts of the JAX ``models/transformer.py`` the main path
runs: ``rmsnorm``, ``matmul_any`` (int8 ``QTensor``), ``_layer`` (no LoRA, no
attention bias, bf16 cache), ``make_cache``, ``forward`` (prefill with cache
write). The reference's ``flash_ok`` has no counterpart: the prefill always
runs ``flash_attention``, whose wrapper takes the plain version for a CPU
tensor and, on the card, launches the kernel or raises for a shape it was not
built for. Parameters keep the JAX layer-stacked layout
(``layers/wqkv`` [L, D, (H+2K)*hd], ...). Rounding follows the reference:
bf16 activations between ops, f32 norms, projections accumulated in f32 and
rounded to bf16.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ops.attention import apply_rope, rope_table
from ..ops.flash_attn import flash_attention
from ..utils.config import TransformerConfig
from ..weights import QTensor, truncated_normal

Params = Dict

__all__ = ["rmsnorm", "matmul_any", "make_cache", "forward", "init_params"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def init_params(cfg: TransformerConfig, generator: torch.Generator) -> Params:
    """Layer-stacked weights with the JAX init's shapes and scales
    (truncated normal at +-3 sigma, std 1/sqrt(fan_in); norms at one)."""
    L, D, F = cfg.n_layers, cfg.dim, cfg.ffn_dim
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = generator.device

    def dense(fan_in, shape):
        return truncated_normal(shape, generator, fan_in ** -0.5)

    p: Params = {
        "tok_emb": dense(D, (cfg.vocab_size, D)),
        "layers": {
            "attn_norm": torch.ones((L, D), device=dev),
            "wqkv": dense(D, (L, D, (H + 2 * K) * hd)),
            "wo": dense(H * hd, (L, H * hd, D)),
            "mlp_norm": torch.ones((L, D), device=dev),
            "w_gate_up": dense(D, (L, D, 2 * F)),
            "w_down": dense(F, (L, F, D)),
        },
        "final_norm": torch.ones((D,), device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense(D, (D, cfg.vocab_size))
    return p


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    nrm = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (nrm * w).to(x.dtype)


def matmul_any(x: torch.Tensor, w) -> torch.Tensor:
    """x @ dequant(w) -> f32 for an int8 QTensor: the contraction in f32
    (exact products of bf16 activations and int8 weights), the per-channel
    scale after it, as the reference folds it."""
    if not isinstance(w, QTensor):
        raise NotImplementedError(
            "dense (non-int8) LM weights: the port serves the int8 LM only "
            "(ROADMAP.md, queue A: scanned non-int8 / B>1 decode)"
        )
    return torch.matmul(x.float(), w.q.float()) * w.s.float()


def _proj(x: torch.Tensor, w) -> torch.Tensor:
    return matmul_any(x, w).to(x.dtype)


def make_cache(cfg: TransformerConfig, batch: int, max_len: int, device,
               dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _layer(
    h: torch.Tensor, lp: Params, cfg: TransformerConfig,
    cos: torch.Tensor, sin: torch.Tensor, positions: torch.Tensor,
    offset: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One prefill layer; returns (h, k, v) with k/v [B, T, K, hd] for the
    cache."""
    B, T, D = h.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = rmsnorm(h, lp["attn_norm"], cfg.norm_eps)
    qkv = _proj(x, lp["wqkv"])
    q, k, v = torch.split(qkv, [H * hd, K * hd, K * hd], dim=-1)
    q = apply_rope(q.reshape(B, T, H, hd), cos, sin, positions)
    k = apply_rope(k.reshape(B, T, K, hd), cos, sin, positions)
    v = v.reshape(B, T, K, hd)
    attn = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), offset)
    h = h + _proj(attn.reshape(B, T, H * hd), lp["wo"])
    x = rmsnorm(h, lp["mlp_norm"], cfg.norm_eps)
    gate, up = _proj(x, lp["w_gate_up"]).chunk(2, dim=-1)
    h = h + _proj(torch.nn.functional.silu(gate) * up, lp["w_down"])
    return h, k, v


def _layer_params(stacked: Params, l: int) -> Params:
    out = {}
    for name, w in stacked.items():
        out[name] = QTensor(q=w.q[l], s=w.s[l]) if isinstance(w, QTensor) else w[l]
    return out


def forward(
    params: Params,
    cfg: TransformerConfig,
    *,
    inputs_embeds: torch.Tensor,           # [B, T, D]
    positions: torch.Tensor,               # [B, T] RoPE positions
    offset: torch.Tensor,                  # [B] int32 first valid slot (left pad)
    cache: Dict[str, torch.Tensor],        # make_cache(...): written at [0, T)
) -> torch.Tensor:
    """Prefill: runs every layer over the T prefix slots under the causal +
    left-pad mask, writes k/v into ``cache`` slots [0, T) in place, and
    returns the final-norm hidden states [B, T, D] (compute dtype)."""
    dt = _DTYPES[cfg.dtype]
    h = inputs_embeds.to(dt)
    B, T = h.shape[:2]
    cos, sin = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, device=h.device)
    for l in range(cfg.n_layers):
        h, k, v = _layer(h, _layer_params(params["layers"], l), cfg, cos, sin, positions, offset)
        cache["k"][l, :, :T] = k.to(cache["k"].dtype)
        cache["v"][l, :, :T] = v.to(cache["v"].dtype)
    return rmsnorm(h, params["final_norm"], cfg.norm_eps)
