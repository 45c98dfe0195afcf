"""Decoder-only transformer core: the token LM's prefill and decode steps.

Counterpart of the JAX ``models/transformer.py``: ``rmsnorm``,
``matmul_any`` (dense or int8 ``QTensor`` weights), ``_layer``,
``make_cache`` (bf16, or int8 with per-(position, head) scales) and
``forward``. ``forward`` runs one of two modes:

- prefill (no ``mask``): the T prefix slots under the causal + left-pad
  mask through ``flash_attention``, whose wrapper takes the plain version
  for a CPU tensor and, on the card, launches the kernel or raises for a
  shape it was not built for (the reference's ``flash_ok`` has no
  counterpart);
- decode (an explicit ``mask`` over the cache's S_max slots): the new keys
  and values are written at ``cache_start`` (one slot, or one slot a row)
  and attention reads the whole cache through ``sdpa`` or, for an int8
  cache, ``sdpa_quant``.

Parameters keep the JAX layer-stacked layout (``layers/wqkv``
[L, D, (H+2K)*hd], ...). Rounding follows the reference: bf16 activations
between ops, f32 norms, projections accumulated in f32 and rounded to bf16.
LoRA adapters and the attention bias are not ported and raise, naming
their ROADMAP.md item.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ..ops.attention import apply_rope, quantize_kv, rope_table, sdpa, sdpa_quant
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
    """x @ w -> f32. An int8 QTensor: the contraction in f32 (exact products
    of bf16 activations and int8 weights), the per-channel scale after it,
    as the reference folds it. A dense weight is cast to the activation
    dtype first, as the reference does, and the product of the two kept in
    f32 (a bf16 x bf16 product on the card would round its result to bf16).
    Either way the weight is widened to f32 on every call."""
    if isinstance(w, QTensor):
        return torch.matmul(x.float(), w.q.float()) * w.s.float()
    return torch.matmul(x.float(), w.to(x.dtype).float())


def _proj(x: torch.Tensor, w) -> torch.Tensor:
    return matmul_any(x, w).to(x.dtype)


def make_cache(cfg: TransformerConfig, batch: int, max_len: int, device,
               dtype=torch.bfloat16, quantized: bool = False) -> Dict[str, torch.Tensor]:
    """k/v [L, B, S, K, hd] in ``dtype``; ``quantized``: int8 k/v plus f32
    ``k_scale`` / ``v_scale`` [L, B, S, K]."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if quantized:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _layer(
    h: torch.Tensor, lp: Params, cfg: TransformerConfig,
    cos: torch.Tensor, sin: torch.Tensor, positions: torch.Tensor,
    cache: Dict[str, torch.Tensor], start: Union[int, torch.Tensor],
    offset: Optional[torch.Tensor], mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """One layer over T new slots. ``cache`` holds this layer's views
    ([B, S, K, hd], and [B, S, K] scales when int8); the new keys and values
    are written at slots [start, start + T) in place, or, for a ``start``
    of [B] slots (T = 1), row b's at slot start[b]. Without ``mask``
    (prefill) attention is the flash kernel over the T new keys; with it,
    attention reads the whole cache under ``mask`` [B, 1, T, S]."""
    B, T, D = h.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = rmsnorm(h, lp["attn_norm"], cfg.norm_eps)
    qkv = _proj(x, lp["wqkv"])
    q, k, v = torch.split(qkv, [H * hd, K * hd, K * hd], dim=-1)
    q = apply_rope(q.reshape(B, T, H, hd), cos, sin, positions)
    k = apply_rope(k.reshape(B, T, K, hd), cos, sin, positions)
    v = v.reshape(B, T, K, hd)
    quant = "k_scale" in cache
    if isinstance(start, torch.Tensor):     # one slot a row: index, not a slice
        at, new = (torch.arange(B, device=h.device), start.long()), (lambda x: x[:, 0])
    else:
        at, new = (slice(None), slice(start, start + T)), (lambda x: x)
    for name, t in (("k", k), ("v", v)):
        if quant:
            qt, scale = quantize_kv(t)
            cache[name][at], cache[name + "_scale"][at] = new(qt), new(scale)
        else:
            cache[name][at] = new(t).to(cache[name].dtype)
    if mask is None:
        attn = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), offset)
    elif quant:
        attn = sdpa_quant(q, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"], mask)
    else:
        attn = sdpa(q, cache["k"], cache["v"], mask)
    h = h + _proj(attn.reshape(B, T, H * hd), lp["wo"])
    x = rmsnorm(h, lp["mlp_norm"], cfg.norm_eps)
    gate, up = _proj(x, lp["w_gate_up"]).chunk(2, dim=-1)
    return h + _proj(torch.nn.functional.silu(gate) * up, lp["w_down"])


def _layer_params(stacked: Params, l: int) -> Params:
    out = {}
    for name, w in stacked.items():
        out[name] = QTensor(q=w.q[l], s=w.s[l]) if isinstance(w, QTensor) else w[l]
    return out


def forward(
    params: Params,
    cfg: TransformerConfig,
    *,
    inputs_embeds: torch.Tensor,               # [B, T, D]
    positions: torch.Tensor,                   # [B, T] RoPE positions
    cache: Dict[str, torch.Tensor],            # make_cache(...), written in place
    offset: Optional[torch.Tensor] = None,     # [B] int32 first valid slot (prefill)
    mask: Optional[torch.Tensor] = None,       # [B, 1, T, S_max] True = attend (decode)
    cache_start: Union[int, torch.Tensor] = 0,
) -> torch.Tensor:
    """Runs every layer over the T new slots, writes their k/v into
    ``cache`` slots [cache_start, cache_start + T) and returns the
    final-norm hidden states [B, T, D] (compute dtype). Prefill (no
    ``mask``) needs ``offset`` and cache_start 0; a decode step passes the
    ``mask`` over the whole cache, and ``cache_start`` may then be [B]
    slots, one a row (T = 1: each row at its own position). The reference
    writes that case as a select over the whole cache, because a scatter
    serializes on its accelerator; here it is one indexed write."""
    if "bqkv" in params["layers"] or any(n.endswith("_lora_a") for n in params["layers"]):
        raise NotImplementedError("attention bias and LoRA adapters are not ported yet "
                                  "(ROADMAP.md: queue A item 6, RAG embedder)")
    per_row = isinstance(cache_start, torch.Tensor) and cache_start.ndim == 1
    start = cache_start if per_row else int(cache_start)
    if per_row and (mask is None or inputs_embeds.shape[1] != 1
                    or cache_start.shape[0] != inputs_embeds.shape[0]):
        raise ValueError("forward: per-row cache writes are one decode slot a row ([B] starts, T = 1)")
    if mask is None and (offset is None or start != 0):
        raise ValueError("forward: a prefill (no mask) needs offset and cache_start 0")
    dt = _DTYPES[cfg.dtype]
    h = inputs_embeds.to(dt)
    cos, sin = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, device=h.device)
    for l in range(cfg.n_layers):
        h = _layer(h, _layer_params(params["layers"], l), cfg, cos, sin, positions,
                   {name: t[l] for name, t in cache.items()}, start, offset, mask)
    return rmsnorm(h, params["final_norm"], cfg.norm_eps)
