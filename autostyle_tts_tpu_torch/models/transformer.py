"""Decoder-only transformer core: the token LM's and the RAG embedder's trunk.

Counterpart of the JAX ``models/transformer.py``: ``init_params``,
``init_params_quantized``, ``init_lora`` (drawn from a JAX-compatible key,
``utils/rng``), ``rmsnorm``, ``matmul_any`` (dense, int8 ``QTensor`` or
packed int4 ``Q4Tensor`` weights), ``_proj`` (with a LoRA pair),
``_layer``, ``make_cache`` (bf16, or int8 with per-(position, head)
scales), ``forward``, ``mean_pool_hidden``, ``embed_text``, ``left_pad``
and ``generate``. ``forward`` runs one of three modes:

- prefill into a cache (``cache`` and ``offset``, no ``mask``): the T
  prefix slots under the causal + left-pad mask through
  ``flash_attention``, whose wrapper takes the plain version for a CPU
  tensor and, on the card, launches the kernel or raises for a shape it
  was not built for (the reference's ``flash_ok`` has no counterpart);
- prefill without a cache (``offset`` or ``mask``, no ``cache``): the
  embedder's trunk, attention over the T new keys by ``flash_attention``
  or, under an explicit ``mask``, by ``sdpa``;
- decode (``cache`` and an explicit ``mask`` over its S_max slots): the
  new keys and values are written at ``cache_start`` (one slot, or one
  slot a row) and attention reads the whole cache through ``sdpa`` or,
  for an int8 cache, ``sdpa_quant``.

Parameters keep the JAX layer-stacked layout (``layers/wqkv``
[L, D, (H+2K)*hd], ...; a Qwen2-family ``layers/bqkv`` [L, (H+2K)*hd]);
a LoRA tree holds ``layers/<name>_lora_a`` [L, fan_in, r] and
``_lora_b`` [L, r, fan_out]. Rounding follows the reference: activations
in the compute dtype between ops, f32 norms, projections accumulated in
f32 and rounded to the compute dtype.

Where the reference gathers out of range it clamps (a JAX gather does):
token ids past the vocabulary read its last row and RoPE positions past
``max_seq_len`` its last angle. The port computes the same (a torch index
would raise); at the configurations' own widths neither happens.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils.checkpoint

from ..ops.attention import apply_rope, causal_mask, quantize_kv, rope_table, sdpa, sdpa_quant
from ..ops.flash_attn import flash_attention
from ..ops.sampling import SamplerConfig, sample
from ..utils import rng
from ..utils.config import TransformerConfig
from ..weights import Q4Tensor, QTensor, is_quantized, q4matmul, quantize, quantize4

Params = Dict

__all__ = ["rmsnorm", "matmul_any", "make_cache", "forward", "init_params", "init_params_quantized",
           "init_lora", "proj_shapes", "mean_pool_hidden", "embed_text", "left_pad", "generate"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def proj_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[int, int]]:
    """(fan_in, fan_out) of each layer projection."""
    D, F, H, K, hd = cfg.dim, cfg.ffn_dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wqkv": (D, (H + 2 * K) * hd), "wo": (H * hd, D), "w_gate_up": (D, 2 * F), "w_down": (F, D)}


def _dense_init(key: torch.Tensor, fan_in: int, shape) -> torch.Tensor:
    """Truncated normal on [-3, 3] times 1/sqrt(fan_in), on the key's device."""
    return rng.truncated_normal(key, -3, 3, shape) * float(np.float32(1.0 / math.sqrt(fan_in)))


def init_params(cfg: TransformerConfig, key: torch.Tensor) -> Params:
    """Layer-stacked weights drawn as the JAX ``init_params(key, cfg)``
    draws them (``utils/rng``: the same key gives the same values): norms
    at one, every projection stack from its own key of ``split(key, 12)``."""
    keys = rng.split(key, 12)
    L, D, dev = cfg.n_layers, cfg.dim, key.device
    shapes = proj_shapes(cfg)

    def stack(k, name):
        fan_in, fan_out = shapes[name]
        return _dense_init(k, fan_in, (L, fan_in, fan_out))

    p: Params = {
        "tok_emb": _dense_init(keys[0], D, (cfg.vocab_size, D)),
        "layers": {
            "attn_norm": torch.ones((L, D), device=dev),
            "wqkv": stack(keys[1], "wqkv"),
            "wo": stack(keys[4], "wo"),
            "mlp_norm": torch.ones((L, D), device=dev),
            "w_gate_up": stack(keys[5], "w_gate_up"),
            "w_down": stack(keys[7], "w_down"),
        },
        "final_norm": torch.ones((D,), device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = _dense_init(keys[8], D, (D, cfg.vocab_size))
    return p


def init_params_quantized(cfg: TransformerConfig, key: torch.Tensor, bits: int = 8) -> Params:
    """Init and weight-only quantization without ever holding the f32 tree,
    as the JAX ``init_params_quantized(key, cfg, bits)`` draws it: each
    projection stack's key is split into one key a layer, and each layer is
    drawn and quantized on the key's device in turn (the live f32
    temporary is one layer's matrix). The embedding stays f32 and
    ``lm_head`` is quantized, as the reference's name rules have it.
    ``bits=8`` gives ``QTensor`` projections, ``bits=4`` packed
    ``Q4Tensor`` ones, their scales as the reference's jitted draw rounds
    them (``fold_reciprocal``)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def qfn(w):
        return (quantize if bits == 8 else quantize4)(w, fold_reciprocal=True)

    keys = rng.split(key, 12)
    L, D, dev = cfg.n_layers, cfg.dim, key.device
    shapes = proj_shapes(cfg)

    def stack(k, name):
        fan_in, fan_out = shapes[name]
        out = None
        for l, lk in enumerate(rng.split(k, L)):
            t = qfn(_dense_init(lk, fan_in, (fan_in, fan_out)))
            if out is None:
                out = type(t)(*(torch.empty((L, *f.shape), dtype=f.dtype, device=dev) for f in t))
            for dst, f in zip(out, t):
                dst[l] = f
        return out

    p: Params = {
        "tok_emb": _dense_init(keys[0], D, (cfg.vocab_size, D)),
        "layers": {
            "attn_norm": torch.ones((L, D), device=dev),
            "wqkv": stack(keys[1], "wqkv"),
            "wo": stack(keys[4], "wo"),
            "mlp_norm": torch.ones((L, D), device=dev),
            "w_gate_up": stack(keys[5], "w_gate_up"),
            "w_down": stack(keys[7], "w_down"),
        },
        "final_norm": torch.ones((D,), device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = qfn(_dense_init(keys[8], D, (D, cfg.vocab_size)))
    return p


def init_lora(cfg: TransformerConfig, r: int, key: torch.Tensor) -> Params:
    """Stacked LoRA pairs for every projection ('all-linear'), as the JAX
    ``init_lora(key, cfg, r)`` draws them: ``a`` from the projection's key
    of ``split(key, 7)``, ``b`` zero, so the adapted model starts equal to
    the base."""
    keys = rng.split(key, 7)
    L = cfg.n_layers
    out: Params = {"layers": {}}
    for k, (name, (fi, fo)) in zip(keys, proj_shapes(cfg).items()):
        out["layers"][name + "_lora_a"] = _dense_init(k, fi, (L, fi, r))
        out["layers"][name + "_lora_b"] = torch.zeros((L, r, fo), device=key.device)
    return out


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
    Either way the weight is widened to f32 on every call. A packed int4
    Q4Tensor: ``q4matmul`` (two half-contraction products), rounded to the
    activation dtype and returned as f32, as the reference's branch does."""
    if isinstance(w, QTensor):
        return torch.matmul(x.float(), w.q.float()) * w.s.float()
    if isinstance(w, Q4Tensor):
        return q4matmul(x, w).float()
    return torch.matmul(x.float(), w.to(x.dtype).float())


def _proj(x: torch.Tensor, w, lora: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
          scale: float = 0.0) -> torch.Tensor:
    """x @ w, plus ``scale * (x @ a) @ b`` for a LoRA pair (a, b), in the
    reference's rounding order: x @ a in f32, rounded to x's dtype, @ b in
    f32, scaled and added in f32, the sum rounded to x's dtype."""
    y = matmul_any(x, w)
    if lora is not None:
        a, b = lora
        ax = torch.matmul(x.float(), a.to(x.dtype).float()).to(x.dtype)
        y = y + scale * torch.matmul(ax.float(), b.to(x.dtype).float())
    return y.to(x.dtype)


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
    h: torch.Tensor, lp: Params, lo: Optional[Params], lora_scale: float, cfg: TransformerConfig,
    cos: torch.Tensor, sin: torch.Tensor, positions: torch.Tensor,
    cache: Optional[Dict[str, torch.Tensor]], start: Union[int, torch.Tensor],
    offset: Optional[torch.Tensor], mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """One layer over T new slots. ``cache`` holds this layer's views
    ([B, S, K, hd], and [B, S, K] scales when int8); the new keys and values
    are written at slots [start, start + T) in place, or, for a ``start``
    of [B] slots (T = 1), row b's at slot start[b]. Without ``mask``
    attention is the flash kernel over the T new keys, as the cache stores
    them when there is one (the reference's masked prefill reads them back
    from its cache; for a model in the cache's dtype they are the same
    values); with a ``mask`` it reads the whole cache, or the T new keys
    when there is no cache. ``lo``: this layer's LoRA pairs."""
    B, T, D = h.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def pair(name):
        return None if lo is None else (lo[name + "_lora_a"], lo[name + "_lora_b"])

    x = rmsnorm(h, lp["attn_norm"], cfg.norm_eps)
    qkv = _proj(x, lp["wqkv"], pair("wqkv"), lora_scale)
    if "bqkv" in lp:      # Qwen2-family attention bias, added in the activation dtype
        qkv = qkv + lp["bqkv"].to(qkv.dtype)
    q, k, v = torch.split(qkv, [H * hd, K * hd, K * hd], dim=-1)
    q = apply_rope(q.reshape(B, T, H, hd), cos, sin, positions)
    k = apply_rope(k.reshape(B, T, K, hd), cos, sin, positions)
    v = v.reshape(B, T, K, hd)
    quant = cache is not None and "k_scale" in cache
    if cache is not None:
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
        if cache is not None and not quant:
            k, v = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
        attn = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), offset)
    elif cache is None:
        attn = sdpa(q, k, v, mask)
    elif quant:
        attn = sdpa_quant(q, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"], mask)
    else:
        attn = sdpa(q, cache["k"], cache["v"], mask)
    h = h + _proj(attn.reshape(B, T, H * hd), lp["wo"], pair("wo"), lora_scale)
    x = rmsnorm(h, lp["mlp_norm"], cfg.norm_eps)
    gate, up = _proj(x, lp["w_gate_up"], pair("w_gate_up"), lora_scale).chunk(2, dim=-1)
    return h + _proj(torch.nn.functional.silu(gate) * up, lp["w_down"], pair("w_down"), lora_scale)


def _layer_params(stacked: Params, l: int) -> Params:
    out = {}
    for name, w in stacked.items():
        out[name] = type(w)(*(f[l] for f in w)) if is_quantized(w) else w[l]
    return out


def forward(
    params: Params,
    cfg: TransformerConfig,
    tokens: Optional[torch.Tensor] = None,     # [B, T] int ids (instead of inputs_embeds)
    *,
    inputs_embeds: Optional[torch.Tensor] = None,   # [B, T, D]
    positions: Optional[torch.Tensor] = None,  # [B, T] RoPE positions (default 0..T-1)
    cache: Optional[Dict[str, torch.Tensor]] = None,  # make_cache(...), written in place
    offset: Optional[torch.Tensor] = None,     # [B] int32 first valid slot (prefill)
    mask: Optional[torch.Tensor] = None,       # [B, 1, T, S] True = attend
    cache_start: Union[int, torch.Tensor] = 0,
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
    remat: bool = False,
) -> torch.Tensor:
    """Runs every layer over the T new slots and returns the final-norm
    hidden states [B, T, D] (compute dtype). With a ``cache`` their k/v are
    written into slots [cache_start, cache_start + T): a prefill (no
    ``mask``) needs ``offset`` and cache_start 0; a decode step passes the
    ``mask`` over the whole cache, and ``cache_start`` may then be [B]
    slots, one a row (T = 1: each row at its own position). The reference
    writes that case as a select over the whole cache, because a scatter
    serializes on its accelerator; here it is one indexed write. Without a
    cache, attention covers the T new keys under ``offset`` (flash) or
    ``mask`` (plain). ``remat`` (under grad mode): each layer through
    ``torch.utils.checkpoint`` (``use_reentrant=False``), so the backward
    recomputes a layer's activations, its weights widened to f32 among them,
    instead of holding them all from the forward; the gradients are the
    same."""
    if (tokens is None) == (inputs_embeds is None):
        raise ValueError("forward: pass tokens or inputs_embeds")
    dt = _DTYPES[cfg.dtype]
    if tokens is not None:
        h = params["tok_emb"][tokens.long().clamp(max=cfg.vocab_size - 1)].to(dt)
    else:
        h = inputs_embeds.to(dt)
    B, T = h.shape[:2]
    per_row = isinstance(cache_start, torch.Tensor) and cache_start.ndim == 1
    start = cache_start if per_row else int(cache_start)
    if per_row and (cache is None or mask is None or T != 1 or cache_start.shape[0] != B):
        raise ValueError("forward: per-row cache writes are one decode slot a row ([B] starts, T = 1)")
    if mask is None and (offset is None or start != 0):
        raise ValueError("forward: a prefill (no mask) needs offset and cache_start 0")
    if positions is None:
        positions = torch.arange(T, device=h.device)[None, :].expand(B, T)
    positions = positions.clamp(max=cfg.max_seq_len - 1)
    cos, sin = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, device=h.device)
    lora_layers = None if lora is None else lora["layers"]
    layer = _layer
    if remat and torch.is_grad_enabled():
        layer = lambda *a: torch.utils.checkpoint.checkpoint(_layer, *a, use_reentrant=False)
    for l in range(cfg.n_layers):
        h = layer(h, _layer_params(params["layers"], l),
                  None if lora_layers is None else _layer_params(lora_layers, l), lora_scale,
                  cfg, cos, sin, positions,
                  None if cache is None else {name: t[l] for name, t in cache.items()}, start, offset, mask)
    return rmsnorm(h, params["final_norm"], cfg.norm_eps)


def _head(params: Params) -> Union[torch.Tensor, QTensor, Q4Tensor]:
    return params["lm_head"] if "lm_head" in params else params["tok_emb"].T


# ----------------------------------------------------------------------------- embeddings


def mean_pool_hidden(hidden: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
    """Mean of the final hidden states over the real tokens -> [B, D] f32."""
    m = attn_mask[..., None].float()
    return (hidden.float() * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


def embed_text(params: Params, cfg: TransformerConfig, tokens: torch.Tensor, attn_mask: torch.Tensor,
               lora: Optional[Params] = None, lora_scale: float = 0.0, prefix_mask: bool = True) -> torch.Tensor:
    """[B, T] padded tokens -> [B, D] mean-pooled embedding (no logits).

    With ``prefix_mask`` (right-padded rows: the real tokens of a row are a
    causal prefix) plain causal attention is exact on the real rows, so the
    prefill runs ``flash_attention`` with zero offsets; the pad rows'
    outputs are finite values the mean-pool multiplies by 0.
    ``prefix_mask=False`` takes an arbitrary mask through the plain
    attention."""
    B, T = tokens.shape
    if prefix_mask:
        hidden = forward(params, cfg, tokens, offset=torch.zeros((B,), dtype=torch.int32, device=tokens.device),
                         lora=lora, lora_scale=lora_scale)
    else:
        mask = causal_mask(T, T, device=tokens.device) & attn_mask.bool()[:, None, None, :]
        hidden = forward(params, cfg, tokens, mask=mask, lora=lora, lora_scale=lora_scale)
    return mean_pool_hidden(hidden, attn_mask)


# ----------------------------------------------------------------------------- generate


class GenerateResult(NamedTuple):
    tokens: torch.Tensor      # [B, max_new] int32 (pad_id after EOS)
    lengths: torch.Tensor     # [B] real tokens generated (EOS excluded)
    cache: Dict[str, torch.Tensor]


def left_pad(seqs: Sequence[Sequence[int]], pad_id: int, width: Optional[int] = None):
    """Host helper: 1-D id sequences -> ([B, P] left-padded int32, [B]
    lengths). Left padding keeps every row flush against the decode slots,
    so prefill and decode share one cache layout."""
    lens = [len(s) for s in seqs]
    P = width or max(lens)
    out = np.full((len(seqs), P), pad_id, np.int32)
    for i, s in enumerate(seqs):
        out[i, P - len(s):] = np.asarray(s, np.int32)
    return out, np.asarray(lens, np.int32)


def generate(
    params: Params,
    cfg: TransformerConfig,
    prompt: torch.Tensor,         # [B, P] LEFT-padded (see left_pad)
    prompt_len: torch.Tensor,     # [B] real lengths
    cache: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
    *,
    max_new_tokens: int,
    sampler: SamplerConfig,
    eos_id: int,
    pad_id: int = 0,
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
) -> GenerateResult:
    """Prefill, then a decode loop of up to ``max_new_tokens`` steps.

    Row b's prompt occupies slots [P - len_b, P); decode step i writes slot
    P + i of every row; the RoPE position of slot s is s - (P - len_b). The
    prefill runs ``flash_attention`` with the left-pad offsets; a step
    attends the row's valid slots up to P + i. After its EOS a row draws
    ``pad_id``; ``lengths`` count the tokens before EOS. The loop stops when
    every row is done (the reference scans all steps; the rows it would
    add are pad)."""
    B, P = prompt.shape
    dev = prompt.device
    S_max = cache["k"].shape[2]
    slot = torch.arange(S_max, device=dev)
    offset = (P - prompt_len.to(dev)).to(torch.int32)
    valid = slot[None, :] >= offset[:, None].long()
    pos = torch.clamp(torch.arange(P, device=dev)[None, :] - offset[:, None].long(), min=0)
    hidden = forward(params, cfg, prompt, positions=pos, cache=cache, offset=offset,
                     lora=lora, lora_scale=lora_scale)
    head = _head(params)
    cur = matmul_any(hidden[:, -1], head)
    toks = torch.full((B, max_new_tokens), pad_id, dtype=torch.int32, device=dev)
    gen_len = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for i in range(max_new_tokens):
        tok = torch.where(done, torch.full_like(gen_len, pad_id), sample(cur, sampler, generator))
        is_eos = tok == eos_id
        gen_len += (~done & ~is_eos).to(torch.int32)
        done = done | is_eos
        toks[:, i] = tok
        if i + 1 == max_new_tokens or bool(done.all()):
            break
        mask = (valid & (slot[None, :] <= P + i))[:, None, None, :]
        hidden = forward(params, cfg, tok[:, None], positions=(P + i - offset.long())[:, None], mask=mask,
                         cache=cache, cache_start=P + i, lora=lora, lora_scale=lora_scale)
        cur = matmul_any(hidden[:, 0], head)
    return GenerateResult(tokens=toks, lengths=gen_len, cache=cache)
