"""Matcha-style conv U-Net CFM estimator + MaskedDiffWithXvec flow compat.

Counterpart of the JAX ``models/compat/matcha_unet.py``. The CosyVoice-300M
``flow.pt`` holds the mel decoder: a conformer encoder over speech tokens,
a linear-interpolation length regulator, a speaker affine, and a
conditional-flow-matching decoder whose vector-field estimator is a 1-D
conv U-Net (resnet blocks + transformer blocks, down / mid / up with skip
concat). Everything is channels-last [B, T, C]. The U-Net's stage
structure is read off the converted tree; only the attention head count is
a config knob (not recoverable from weight shapes).

``solve`` takes its initial noise ``x0`` as an argument when given (the
tests inject the JAX draw), else draws it from a ``torch.Generator``.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.conv import conv1d, conv_transpose1d
from . import wenet_conformer as wc

Params = Dict


@dataclass(frozen=True)
class MatchaFlowConfig:
    n_mels: int = 80
    n_heads: int = 4               # estimator attention heads (not inferable)
    n_steps: int = 10              # Euler steps (upstream n_timesteps)
    cfg_rate: float = 0.7          # upstream inference_cfg_rate
    token_mel_ratio: int = 2       # 25 Hz tokens -> 50 Hz mel frames
    temperature: float = 1.0


def _idx(d: Params):
    """Iterate a {"0": ..., "1": ...} int-keyed dict in index order."""
    return [d[k] for k in sorted(d, key=int)]


def _mish(x):
    return x * torch.tanh(F.softplus(x))


def _group_norm(x, scale, bias, groups, eps=1e-5):
    """torch GroupNorm over channels-last [B, T, C]: stats per (sample,
    group) over (T, C/G)."""
    B, T, C = x.shape
    xg = x.reshape(B, T, groups, C // groups).float()
    mu = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=(1, 3), keepdim=True)
    xn = ((xg - mu) * torch.rsqrt(var + eps)).reshape(B, T, C)
    return (xn * scale + bias).to(x.dtype)


def _block1d(x, p, mask):
    """Matcha Block1D: conv3 -> GroupNorm(8) -> Mish, mask-aware."""
    h = conv1d(x * mask[..., None], p["conv"])
    h = _group_norm(h, p["norm"]["scale"], p["norm"]["bias"], groups=8)
    return _mish(h)


def _resnet(x, p, mask, temb):
    h = _block1d(x, {"conv": p["b1_conv"], "norm": p["b1_norm"]}, mask)
    h = h + (_mish(temb) @ p["mlp"]["w"] + p["mlp"]["b"])[:, None, :]
    h = _block1d(h, {"conv": p["b2_conv"], "norm": p["b2_norm"]}, mask)
    return h + conv1d(x * mask[..., None], p["res_conv"])


def _ln(x, p, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return (((xf - mu) * torch.rsqrt(var + eps)) * p["scale"] + p["bias"]).to(x.dtype)


def _tf_block(x, p, mask, n_heads):
    """diffusers BasicTransformerBlock: LN -> MHA (no qkv bias) -> LN ->
    GEGLU feed-forward, both residual."""
    B, T, C = x.shape
    inner = p["q"]["w"].shape[1]
    hd = inner // n_heads
    n = _ln(x, p["norm1"])
    q = (n @ p["q"]["w"]).reshape(B, T, n_heads, hd)
    k = (n @ p["k"]["w"]).reshape(B, T, n_heads, hd)
    v = (n @ p["v"]["w"]).reshape(B, T, n_heads, hd)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / math.sqrt(hd)
    valid = mask[:, None, None, :] > 0
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    att = torch.einsum("bhts,bshd->bthd", probs, v.float())
    att = att.reshape(B, T, inner).to(x.dtype)
    x = x + att @ p["out"]["w"] + p["out"]["b"]
    n = _ln(x, p["norm3"])
    proj = n @ p["ff_proj"]["w"] + p["ff_proj"]["b"]
    a, gate = torch.chunk(proj, 2, dim=-1)
    h = a * F.gelu(gate, approximate="tanh")      # jax.nn.gelu's default
    return x + h @ p["ff_out"]["w"] + p["ff_out"]["b"]


def _sinu_t(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Matcha SinusoidalPosEmb: scale 1000, (half-1) exponent denominator,
    concat [sin, cos]."""
    half = dim // 2
    emb = math.log(10000.0) / max(half - 1, 1)
    freqs = torch.exp(-emb * torch.arange(half, dtype=torch.float32, device=t.device))
    ang = 1000.0 * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def estimator_apply(
    est: Params,
    cfg: MatchaFlowConfig,
    x: torch.Tensor,            # [B, T, M] noisy mel
    mask: torch.Tensor,         # [B, T]
    mu: torch.Tensor,           # [B, T, M] encoder output (0 = uncond)
    t: torch.Tensor,            # [B]
    spk: torch.Tensor,          # [B, M] projected speaker vector
    cond: torch.Tensor,         # [B, T, M] prompt-mel conditioning
) -> torch.Tensor:
    """U-Net vector field. T must be divisible by 2**(n_down_stages-1)."""
    B, T, M = x.shape
    h = torch.cat([x, mu, spk[:, None, :].expand(B, T, M), cond], dim=-1)
    in_ch = h.shape[-1]
    temb = _sinu_t(t, in_ch)
    temb = F.silu(temb @ est["time_mlp"]["l1"]["w"] + est["time_mlp"]["l1"]["b"])
    temb = temb @ est["time_mlp"]["l2"]["w"] + est["time_mlp"]["l2"]["b"]

    downs = _idx(est["down"])
    ups = _idx(est["up"])
    hiddens = []
    masks = [mask]
    for i, stage in enumerate(downs):
        m = masks[-1]
        h = _resnet(h, stage["res"], m, temb)
        for tf in _idx(stage["tf"]):
            h = _tf_block(h, tf, m, cfg.n_heads)
        hiddens.append(h)
        last = i == len(downs) - 1
        # diffusers Downsample1D is torch Conv1d(k=3, stride=2, padding=1):
        # explicit (1, 1), not SAME, which pads (0, 1) for an even T and
        # shifts every window one frame against the upstream weights
        h = conv1d(h * m[..., None], stage["down"],
                   stride=1 if last else 2,
                   padding="SAME" if last else (1, 1))
        masks.append(m[:, ::2])
    masks = masks[:-1]
    m_mid = masks[-1]
    for stage in _idx(est["mid"]):
        h = _resnet(h, stage["res"], m_mid, temb)
        for tf in _idx(stage["tf"]):
            h = _tf_block(h, tf, m_mid, cfg.n_heads)
    for i, stage in enumerate(ups):
        m = masks.pop()
        skip = hiddens.pop()
        h = torch.cat([h[:, : skip.shape[1]], skip], dim=-1)
        h = _resnet(h, stage["res"], m, temb)
        for tf in _idx(stage["tf"]):
            h = _tf_block(h, tf, m, cfg.n_heads)
        last = i == len(ups) - 1
        if last:
            h = conv1d(h * m[..., None], stage["up"])
        else:
            k = stage["up"]["w"].shape[0]
            h = conv_transpose1d(h * m[..., None], stage["up"], stride=2, kernel=k)
    m = mask
    h = _block1d(h, est["final_block"], m)
    out = conv1d(h * m[..., None], est["final_proj"])
    return out * m[..., None]


# ------------------------------------------------------------------ flow wrapper


@functools.lru_cache(maxsize=64)
def _linear_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of ``jax.image.resize(method="linear")`` along
    one axis (half-pixel sample points, a triangle kernel widened by the
    scale when downsampling, each column renormalized over the inputs it
    reaches, columns whose sample point lies outside the input zeroed)."""
    scale = np.float32(n_out) / np.float32(n_in)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _resize_linear(h: torch.Tensor, target_len: int) -> torch.Tensor:
    """[B, T, C] -> [B, target_len, C], as ``jax.image.resize`` (linear)."""
    w = torch.from_numpy(_linear_resize_weights(h.shape[1], target_len)).to(h.device)
    return torch.einsum("btc,tu->buc", h.float(), w).to(h.dtype)


def _length_regulator(lr: Params, h: torch.Tensor, target_len: int) -> torch.Tensor:
    """InterpolateRegulator: linear-resample [B, T, C] to target_len frames,
    then the Sequential conv/GroupNorm(1)/Mish stack + final 1x1 conv.
    Items are told apart by weight rank (3D conv vs 1D norm scale)."""
    h = _resize_linear(h, target_len)
    items = _idx(lr["seq"])
    i = 0
    while i < len(items):
        p = items[i]
        if "w" in p and p["w"].ndim == 3:
            nxt = items[i + 1] if i + 1 < len(items) else None
            if nxt is not None and "scale" in nxt:
                h = _mish(_group_norm(conv1d(h, p), nxt["scale"], nxt["bias"], groups=1))
                i += 2
            else:
                h = conv1d(h, p)   # final projection (no norm/act after)
                i += 1
        else:
            i += 1
    return h


def encode_tokens(
    params: Params,
    enc_cfg: wc.WenetEncoderConfig,
    tokens: torch.Tensor,       # [B, T_tok] int32
    tok_mask: torch.Tensor,     # [B, T_tok]
    n_frames: int,
) -> torch.Tensor:
    """input_embedding -> conformer -> encoder_proj -> length-regulate to
    n_frames mel frames -> mu [B, n_frames, M]."""
    emb = params["input_embedding"][tokens.long()]
    h = wc.apply_encoder(params["encoder"], enc_cfg, emb, tok_mask)
    h = h @ params["encoder_proj"]["w"] + params["encoder_proj"]["b"]
    return _length_regulator(params["length_regulator"], h, n_frames)


@torch.no_grad()
def solve(
    params: Params,
    cfg: MatchaFlowConfig,
    mu: torch.Tensor,           # [B, F, M]
    spk: torch.Tensor,          # [B, spk_dim] raw x-vector
    cond: torch.Tensor,         # [B, F, M] prompt mel (0 beyond prompt)
    mask: torch.Tensor,         # [B, F]
    generator: Optional[torch.Generator] = None,
    x0: Optional[torch.Tensor] = None,   # [B, F, M] standard-normal noise
) -> torch.Tensor:
    """Euler CFM solve with the upstream cosine time schedule
    t = 1 - cos(pi/2 * linspace) and classifier-free guidance that zeroes
    mu, spk and cond on the unconditional branch. Both branches run as ONE
    2B-batched estimator call per step. The initial noise is ``x0`` times
    the temperature (drawn from ``generator`` when ``x0`` is None)."""
    B, Fr, M = mu.shape
    spk_n = spk / torch.clamp(torch.linalg.norm(spk, dim=-1, keepdim=True), min=1e-6)
    spk_p = spk_n @ params["spk_affine"]["w"] + params["spk_affine"]["b"]
    if x0 is None:
        x0 = torch.randn((B, Fr, M), generator=generator, device=mu.device)
    x = x0.float() * cfg.temperature
    # linspace(0, 1) as jnp.linspace rounds it in f32 (torch.linspace parts
    # from it by an ulp at some points)
    lin = torch.arange(cfg.n_steps + 1, dtype=torch.float32, device=mu.device) * (1.0 / cfg.n_steps)
    ts = 1.0 - torch.cos(lin * 0.5 * math.pi)

    mu2 = torch.cat([mu, torch.zeros_like(mu)], dim=0)
    spk2 = torch.cat([spk_p, torch.zeros_like(spk_p)], dim=0)
    cond2 = torch.cat([cond, torch.zeros_like(cond)], dim=0)
    mask2 = torch.cat([mask, mask], dim=0)
    for i in range(cfg.n_steps):
        dt = ts[i + 1] - ts[i]
        tb = ts[i].expand(2 * B)
        v2 = estimator_apply(params["estimator"], cfg, torch.cat([x, x], dim=0), mask2, mu2, tb, spk2, cond2)
        v = (1 + cfg.cfg_rate) * v2[:B] - cfg.cfg_rate * v2[B:]
        x = x + dt * v
    return x * mask[..., None]
