"""wenet/espnet-style conformer and transformer encoders (compat family).

Counterpart of the JAX ``models/compat/wenet_conformer.py``. The
CosyVoice-300M release builds its token LM from wenet encoder stacks:
``llm.pt`` holds a ConformerEncoder over text and a TransformerEncoder LM
trunk, ``flow.pt`` another ConformerEncoder over speech tokens, all with
espnet relative-position multi-headed attention (``pos_bias_u/v`` +
``linear_pos``), macaron feed-forward and a depthwise-conv module where
configured. Layers are leading-[L] stacked (the converted trees' layout)
and run as a loop over L; convs are channels-last; attention scores in f32.
The causal decode keeps a KV cache and a rel-position table indexed by
distance to the past, so the LM trunk decodes one step at a time
(``cosy_llm.generate`` drives it from the host).

Plain PyTorch: the JAX module is XLA code, no Pallas kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict


@dataclass(frozen=True)
class WenetEncoderConfig:
    """Geometry of one wenet encoder stack (inferred from converted shapes
    by ``cosy_llm._enc_config``)."""

    input_dim: int
    dim: int
    n_layers: int
    n_heads: int
    ffn_dim: int
    macaron: bool = False          # feed_forward_macaron halves
    use_cnn: bool = False          # conv module + norm_final
    cnn_kernel: int = 15
    in_norm: bool = True           # LayerNorm after the input Linear
    activation: str = "silu"       # wenet 'swish' == silu; transformer: relu
    norm_eps: float = 1e-5
    max_rel: int = 4096            # rel-position table extent for decode

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def _act(name: str):
    # jax.nn.gelu is tanh-approximate by default
    return {"silu": F.silu, "relu": torch.relu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def _ln(x, scale, bias, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _lin(x, p):
    return x @ p["w"] + p["b"]


def _layer(layers: Params, l: int) -> Params:
    """Layer l's slice of a leading-[L] stacked tree."""
    return {k: (_layer(v, l) if isinstance(v, dict) else v[l]) for k, v in layers.items()}


# ------------------------------------------------------------------ rel-pos


def relpos_table(rel: torch.Tensor, dim: int) -> torch.Tensor:
    """espnet RelPositionalEncoding rows for signed relative positions
    `rel` [N] -> [N, dim], sin at even dims / cos at odd dims (interleaved,
    matching the layout linear_pos was trained on upstream)."""
    inv = torch.exp(-math.log(10000.0) * torch.arange(0, dim, 2, dtype=torch.float32, device=rel.device) / dim)
    ang = rel.float()[:, None] * inv[None, :]
    pe = torch.zeros((rel.shape[0], dim), dtype=torch.float32, device=rel.device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def _relpos_attn_full(
    x: torch.Tensor,          # [B, T, D] (already layer-normed)
    lw: Params,               # one layer's attention weights
    cfg: WenetEncoderConfig,
    attn_mask: torch.Tensor,  # [B, 1, T, T] bool (True = attend)
    pe: torch.Tensor,         # [2T-1, D] rel table, index j <-> rel = T-1-j
) -> torch.Tensor:
    B, T, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = _lin(x, lw["q"]).reshape(B, T, H, hd)
    k = _lin(x, lw["k"]).reshape(B, T, H, hd)
    v = _lin(x, lw["v"]).reshape(B, T, H, hd)
    p = (pe @ lw["pos"]["w"]).reshape(-1, H, hd)          # [2T-1, H, hd]
    qu = q + lw["pos_bias_u"][None, None]
    qv = q + lw["pos_bias_v"][None, None]
    ac = torch.einsum("bthd,bshd->bhts", qu.float(), k.float())
    bd_all = torch.einsum("bthd,jhd->bhtj", qv.float(), p.float())
    # pe index j for query t / key s: rel = t - s, j = (T-1) - rel
    t_i = torch.arange(T, device=x.device)[:, None]
    s_i = torch.arange(T, device=x.device)[None, :]
    j = (T - 1) - (t_i - s_i)                              # [T, T]
    bd = torch.gather(bd_all, -1, j[None, None].expand(B, H, T, T))
    scores = (ac + bd) / math.sqrt(hd)
    scores = torch.where(attn_mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs, v.float())
    return _lin(out.reshape(B, T, D).to(x.dtype), lw["out"])


def _conv_module(x, lw, cfg, pad_mask):
    """Conformer conv module: pointwise(2C)+GLU -> depthwise -> LN -> swish
    -> pointwise. Channels-last; padded frames zeroed so the depthwise taps
    never read pad content."""
    B, T, D = x.shape
    x = x * pad_mask[..., None]
    h = _lin(x, lw["conv_pw1"])                            # [B, T, 2D] (K=1)
    a, b = torch.chunk(h, 2, dim=-1)
    h = a * torch.sigmoid(b)
    w = lw["conv_dw"]["w"]                                 # [K, 1, D]
    K = w.shape[0]
    # SAME at stride 1: (K - 1) split with the odd sample on the right
    hp = F.pad(h.float().transpose(1, 2), ((K - 1) // 2, K - 1 - (K - 1) // 2))
    h = F.conv1d(hp, w.float().permute(2, 1, 0), groups=D).transpose(1, 2).to(h.dtype) + lw["conv_dw"]["b"]
    h = _ln(h, lw["conv_norm"]["scale"], lw["conv_norm"]["bias"], cfg.norm_eps)
    h = F.silu(h)
    return _lin(h, lw["conv_pw2"])


def _ff(x, w1, w2, act):
    return _lin(act(_lin(x, w1)), w2)


def _embed_in(params: Params, cfg: WenetEncoderConfig, x: torch.Tensor) -> torch.Tensor:
    h = _lin(x, params["in_proj"])
    if cfg.in_norm:
        h = _ln(h, params["in_norm"]["scale"], params["in_norm"]["bias"], cfg.norm_eps)
    return h * math.sqrt(cfg.dim)        # espnet xscale


def apply_encoder(
    params: Params,
    cfg: WenetEncoderConfig,
    x: torch.Tensor,                 # [B, T, input_dim]
    pad_mask: torch.Tensor,          # [B, T] 1 = real frame
    causal: bool = False,
) -> torch.Tensor:
    """Full-sequence encoder forward -> [B, T, dim] (after after_norm).
    normalize_before=True layer layout (the upstream default)."""
    act = _act(cfg.activation)
    eps = cfg.norm_eps
    h = _embed_in(params, cfg, x)
    B, T, _ = h.shape
    dev = h.device
    pe = relpos_table(torch.arange(T - 1, -T, -1, device=dev), cfg.dim)
    attn_mask = pad_mask[:, None, None, :] > 0
    if causal:
        attn_mask = attn_mask & (torch.arange(T, device=dev)[:, None] >= torch.arange(T, device=dev)[None, :])
    for l in range(cfg.n_layers):
        lw = _layer(params["layers"], l)
        if cfg.macaron:
            n = _ln(h, lw["norm_ff_macaron"]["scale"], lw["norm_ff_macaron"]["bias"], eps)
            h = h + 0.5 * _ff(n, lw["ffm_w1"], lw["ffm_w2"], act)
        n = _ln(h, lw["norm_mha"]["scale"], lw["norm_mha"]["bias"], eps)
        h = h + _relpos_attn_full(n, lw, cfg, attn_mask, pe)
        if cfg.use_cnn:
            n = _ln(h, lw["norm_conv"]["scale"], lw["norm_conv"]["bias"], eps)
            h = h + _conv_module(n, lw, cfg, pad_mask)
        n = _ln(h, lw["norm_ff"]["scale"], lw["norm_ff"]["bias"], eps)
        scale = 0.5 if cfg.macaron else 1.0
        h = h + scale * _ff(n, lw["ff_w1"], lw["ff_w2"], act)
        if cfg.use_cnn:
            h = _ln(h, lw["norm_final"]["scale"], lw["norm_final"]["bias"], eps)
    h = _ln(h, params["after_norm"]["scale"], params["after_norm"]["bias"], eps)
    return h * pad_mask[..., None]


# ------------------------------------------------------------------ causal decode


def prefill(
    params: Params,
    cfg: WenetEncoderConfig,
    x: torch.Tensor,                 # [B, P, input_dim] embedded prefix
    pad_mask: torch.Tensor,          # [B, P]
    s_max: int,
) -> Tuple[torch.Tensor, Params]:
    """Causal full-prefix pass; returns the hidden states [B, P, dim] and
    a KV cache dict sized s_max for decode_step. The cache stores k/v per
    layer without position: rel-position attention adds position at score
    time (the bd term), so cached keys are position-free and the cache is
    filled in one shot."""
    act = _act(cfg.activation)
    eps = cfg.norm_eps
    B, P, _ = x.shape
    H, hd, L = cfg.n_heads, cfg.head_dim, cfg.n_layers
    dev = x.device
    h = _embed_in(params, cfg, x)
    pe = relpos_table(torch.arange(P - 1, -P, -1, device=dev), cfg.dim)
    causal = torch.arange(P, device=dev)[:, None] >= torch.arange(P, device=dev)[None, :]
    attn_mask = (pad_mask[:, None, None, :] > 0) & causal
    kc = torch.zeros((L, B, s_max, H, hd), dtype=h.dtype, device=dev)
    vc = torch.zeros_like(kc)
    for l in range(L):
        lw = _layer(params["layers"], l)
        if cfg.macaron:
            n = _ln(h, lw["norm_ff_macaron"]["scale"], lw["norm_ff_macaron"]["bias"], eps)
            h = h + 0.5 * _ff(n, lw["ffm_w1"], lw["ffm_w2"], act)
        n = _ln(h, lw["norm_mha"]["scale"], lw["norm_mha"]["bias"], eps)
        kc[l, :, :P] = _lin(n, lw["k"]).reshape(B, P, H, hd)
        vc[l, :, :P] = _lin(n, lw["v"]).reshape(B, P, H, hd)
        h = h + _relpos_attn_full(n, lw, cfg, attn_mask, pe)
        n = _ln(h, lw["norm_ff"]["scale"], lw["norm_ff"]["bias"], eps)
        h = h + _ff(n, lw["ff_w1"], lw["ff_w2"], act)
    return h, {"k": kc, "v": vc}


def decode_step(
    params: Params,
    cfg: WenetEncoderConfig,
    cache: Params,
    x_t: torch.Tensor,               # [B, input_dim] embedded current token
    pos: int,                        # current absolute position
    kv_len: torch.Tensor,            # [B] valid cache rows incl. this token
    pe_dec: torch.Tensor,            # [max_rel, D] rel table rows rel=0..max
) -> Tuple[torch.Tensor, Params]:
    """One causal step: write k/v at `pos` (into ``cache``, in place), attend
    over rel = pos - s, return ([B, dim] hidden, the cache). Macaron/conv
    variants are not needed for the LM trunk (upstream uses a plain
    transformer there)."""
    act = _act(cfg.activation)
    eps = cfg.norm_eps
    B = x_t.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    S = cache["k"].shape[2]
    dev = x_t.device
    h = _embed_in(params, cfg, x_t)
    s_i = torch.arange(S, device=dev)
    valid = s_i[None, :] < kv_len[:, None]                 # [B, S]
    rel = torch.clamp(pos - s_i, 0, pe_dec.shape[0] - 1)   # [S]
    pe_rel = pe_dec[rel]
    for l in range(cfg.n_layers):
        lw = _layer(params["layers"], l)
        kc, vc = cache["k"][l], cache["v"][l]
        n = _ln(h, lw["norm_mha"]["scale"], lw["norm_mha"]["bias"], eps)
        q = _lin(n, lw["q"]).reshape(B, H, hd)
        kc[:, pos] = _lin(n, lw["k"]).reshape(B, H, hd)
        vc[:, pos] = _lin(n, lw["v"]).reshape(B, H, hd)
        p = (pe_rel @ lw["pos"]["w"]).reshape(S, H, hd)
        qu = (q + lw["pos_bias_u"][None]).float()
        qv = (q + lw["pos_bias_v"][None]).float()
        ac = torch.einsum("bhd,bshd->bhs", qu, kc.float())
        bd = torch.einsum("bhd,shd->bhs", qv, p.float())
        scores = (ac + bd) / math.sqrt(hd)
        scores = torch.where(valid[:, None, :], scores, torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhs,bshd->bhd", probs, vc.float())
        h = h + _lin(out.reshape(B, -1).to(h.dtype), lw["out"])
        n = _ln(h, lw["norm_ff"]["scale"], lw["norm_ff"]["bias"], eps)
        h = h + _ff(n, lw["ff_w1"], lw["ff_w2"], act)
    return h, cache
