"""Conditional flow-matching mel decoder: DiT vector field + Euler solve.

Counterpart of the JAX ``models/cfm.py`` (``init_params``, ``_t_embed``,
``_ln``, ``_frame_pos_embed``, ``vector_field``, ``upsample_tokens``,
``sample_mel``, the training objective ``cfm_loss``). Trunk matmuls run in
``cfg.dtype``; layer-norm statistics, softmax, the adaLN modulation and the
ODE state stay f32, as there.

Under an active mesh (``parallel/``) the estimator runs on this rank's
slices, as the JAX rules shard it: ``wq`` / ``wk`` / ``wv`` and ``w_up``
column-parallel (the local heads and F / tp), ``wo`` / ``w_down``
row-parallel (``transformer.row_proj``: their partial products, in the
trunk dtype, summed over the model group in f32), ``tok_emb``
vocab-sharded (``transformer.embed``); every other leaf whole.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops.attention import sdpa
from ..parallel import comm
from ..utils.config import CFMConfig
from .transformer import dense_product, embed, row_proj
from ..weights import normal

Params = Dict
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def init_params(cfg: CFMConfig, generator: torch.Generator) -> Params:
    D, M, Fd, L = cfg.dim, cfg.n_mels, cfg.ffn_dim, cfg.n_layers
    dev = generator.device

    def dense(fan_in, shape):
        return normal(shape, generator, 1.0 / math.sqrt(fan_in))

    return {
        "in_proj": dense(2 * M + 1, (2 * M + 1, D)),
        "tok_emb": dense(D, (cfg.token_vocab_size, D)),
        "spk_proj": dense(cfg.spk_dim, (cfg.spk_dim, D)),
        "t_proj1": dense(256, (256, D)),
        "t_proj2": dense(D, (D, D)),
        "layers": {
            "mod": torch.zeros((L, D, 6 * D), device=dev),
            "wq": dense(D, (L, D, D)),
            "wk": dense(D, (L, D, D)),
            "wv": dense(D, (L, D, D)),
            "wo": dense(D, (L, D, D)),
            "w_up": dense(D, (L, D, Fd)),
            "w_down": dense(Fd, (L, Fd, D)),
        },
        "out_norm_scale": torch.ones((D,), device=dev),
        "out_proj": torch.zeros((D, M), device=dev),
    }


def _t_embed(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """Sinusoidal embedding of flow time t in [0, 1] -> [B, dim]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device) / half)
    ang = t[:, None] * 1000.0 * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def _frame_pos_embed(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Absolute-position sinusoid [B, F] -> [B, F, dim]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def vector_field(
    params: Params, cfg: CFMConfig,
    x_t: torch.Tensor,          # [B, F, M]
    t: torch.Tensor,            # [B]
    token_cond: torch.Tensor,   # [B, F, D]
    spk: torch.Tensor,          # [B, spk_dim]
    prompt_mel: torch.Tensor,   # [B, F, M]
    prompt_mask: torch.Tensor,  # [B, F]
    frame_mask: torch.Tensor,   # [B, F]
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    B, Fr, M = x_t.shape
    D = cfg.dim
    dt = _DTYPES[cfg.dtype]
    h = torch.cat([x_t, prompt_mel, prompt_mask[..., None]], dim=-1) @ params["in_proj"]
    if positions is None:
        positions = torch.arange(Fr, device=x_t.device)[None, :].expand(B, Fr)
    h = h + token_cond + (spk @ params["spk_proj"])[:, None, :]
    h = (h + _frame_pos_embed(positions, D).to(h.dtype)).to(dt)
    temb = F.silu(_t_embed(t) @ params["t_proj1"]) @ params["t_proj2"]
    hd = D // cfg.n_heads
    attn_mask = (frame_mask[:, None, None, :] > 0) & (frame_mask[:, None, :, None] > 0)
    lp = params["layers"]
    n_heads = lp["wq"].shape[-1] // hd            # this rank's heads under a mesh
    attn_cut, mlp_cut = n_heads < cfg.n_heads, lp["w_up"].shape[-1] < cfg.ffn_dim
    for l in range(cfg.n_layers):
        mod = F.silu(temb) @ lp["mod"][l]
        sh1, sc1, g1, sh2, sc2, g2 = (m.to(dt) for m in mod.chunk(6, dim=-1))
        x = _ln(h) * (1 + sc1[:, None]) + sh1[:, None]
        xa = comm.copy_to_model(x) if attn_cut else x
        q = (xa @ lp["wq"][l].to(dt)).reshape(B, Fr, n_heads, hd)
        k = (xa @ lp["wk"][l].to(dt)).reshape(B, Fr, n_heads, hd)
        v = (xa @ lp["wv"][l].to(dt)).reshape(B, Fr, n_heads, hd)
        att = sdpa(q, k, v, attn_mask).reshape(B, Fr, n_heads * hd)
        h = h + g1[:, None] * row_proj(att, lp["wo"][l], D, product=dense_product)
        x = _ln(h) * (1 + sc2[:, None]) + sh2[:, None]
        xm = comm.copy_to_model(x) if mlp_cut else x
        up = F.gelu(xm @ lp["w_up"][l].to(dt), approximate="tanh")
        h = h + g2[:, None] * row_proj(up, lp["w_down"][l], cfg.ffn_dim, product=dense_product)
    h = _ln(h).float() * params["out_norm_scale"]
    return h @ params["out_proj"]


def upsample_tokens(params: Params, tokens: torch.Tensor, upsample: int, vocab: int) -> torch.Tensor:
    """[B, T_tok] -> [B, T_tok * upsample, D] token conditioning. ``vocab``
    is the config's ``token_vocab_size``: under a mesh ``tok_emb`` may hold
    a slice of it (``transformer.embed``)."""
    return torch.repeat_interleave(embed(params["tok_emb"], tokens, vocab), upsample, dim=1)


class CFMLoss(NamedTuple):
    loss: torch.Tensor
    pred: torch.Tensor


def cfm_draws(generator: torch.Generator, mel: torch.Tensor, cond_drop_prob: float) -> Dict[str, torch.Tensor]:
    """The random draws of one ``cfm_loss``: noise ``x0`` [B, F, M], flow
    times ``t`` [B] in [0, 1) and the conditioning-drop flags ``drop`` [B]."""
    B = mel.shape[0]
    dev = mel.device
    return {"x0": torch.randn(mel.shape, generator=generator, device=dev, dtype=mel.dtype),
            "t": torch.rand((B,), generator=generator, device=dev, dtype=mel.dtype),
            "drop": torch.rand((B,), generator=generator, device=dev) < cond_drop_prob}


def cfm_loss(
    params: Params, cfg: CFMConfig,
    generator: Optional[torch.Generator],
    mel: torch.Tensor,            # [B, F, M] target mel
    token_cond: torch.Tensor,     # [B, F, D]
    spk: torch.Tensor,
    prompt_mask: torch.Tensor,    # [B, F] frames given as prompt
    frame_mask: torch.Tensor,     # [B, F] real frames
    cond_drop_prob: float = 0.2,
    draws: Optional[Dict[str, torch.Tensor]] = None,
) -> CFMLoss:
    """OT-CFM objective: x_t = (1 - (1 - s) t) x0 + t x1, target
    u = x1 - (1 - s) x0 (sigma_min = s); conditioning dropout trains the
    unconditional branch for guidance. ``draws`` (``cfm_draws``' keys)
    replaces the draws from ``generator``. Prompt frames are not scored."""
    M = mel.shape[-1]
    d = draws if draws is not None else cfm_draws(generator, mel, cond_drop_prob)
    x0, t, drop = d["x0"].to(mel.dtype), d["t"].to(mel.dtype), d["drop"].bool()
    s = cfg.sigma_min
    x_t = (1 - (1 - s) * t)[:, None, None] * x0 + t[:, None, None] * mel
    target = mel - (1 - s) * x0
    tc = torch.where(drop[:, None, None], torch.zeros_like(token_cond), token_cond)
    prompt_mel = mel * prompt_mask[..., None]
    pred = vector_field(params, cfg, x_t, t, tc, spk, prompt_mel, prompt_mask, frame_mask)
    w = (frame_mask * (1 - prompt_mask))[..., None]
    loss = (w * (pred - target) ** 2).sum() / torch.clamp(w.sum() * M, min=1.0)
    return CFMLoss(loss=loss, pred=pred)


def sample_mel(
    params: Params, cfg: CFMConfig,
    generator: Optional[torch.Generator],
    token_cond: torch.Tensor,   # [B, F, D]
    spk: torch.Tensor,
    prompt_mel: torch.Tensor,   # [B, F, M]
    prompt_mask: torch.Tensor,  # [B, F]
    frame_mask: torch.Tensor,   # [B, F]
    use_cfg: bool = True,
    positions: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fixed-step Euler solve t: 0 -> 1 from ``noise`` (drawn from
    ``generator`` when not given), optionally with classifier-free guidance
    batched as one 2B estimator call per step. Prompt frames are overwritten
    with the given mel."""
    B, Fr, _ = token_cond.shape
    M = cfg.n_mels
    dev = token_cond.device
    if noise is None:
        x = torch.randn((B, Fr, M), generator=generator, device=dev, dtype=torch.float32)
    else:
        x = noise.to(device=dev, dtype=torch.float32)
    dt = 1.0 / cfg.n_steps
    if positions is None:
        positions = torch.arange(Fr, device=dev)[None, :].expand(B, Fr)
    if use_cfg:
        tc2 = torch.cat([token_cond, torch.zeros_like(token_cond)], dim=0)
        spk2 = torch.cat([spk, spk], dim=0)
        pm2 = torch.cat([prompt_mel, prompt_mel], dim=0)
        pk2 = torch.cat([prompt_mask, prompt_mask], dim=0)
        fm2 = torch.cat([frame_mask, frame_mask], dim=0)
        pos2 = torch.cat([positions, positions], dim=0)
        for i in range(cfg.n_steps):
            t = torch.full((2 * B,), float(i), dtype=torch.float32, device=dev) * dt
            v2 = vector_field(params, cfg, torch.cat([x, x], dim=0), t, tc2, spk2,
                              pm2, pk2, fm2, pos2)
            v = (1 + cfg.cfg_scale) * v2[:B] - cfg.cfg_scale * v2[B:]
            x = x + dt * v
    else:
        for i in range(cfg.n_steps):
            t = torch.full((B,), float(i), dtype=torch.float32, device=dev) * dt
            v = vector_field(params, cfg, x, t, token_cond, spk, prompt_mel,
                             prompt_mask, frame_mask, positions)
            x = x + dt * v
    pm = prompt_mask[..., None]
    return x * (1 - pm) + prompt_mel * pm
