"""Speech tokenizer: 16 kHz mel -> 25 Hz discrete speech tokens.

Counterpart of the JAX ``models/speech_tokenizer.py``: strided-conv
subsampling (100 Hz mel -> 25 Hz) into a bidirectional transformer encoder
and a VQ layer (nearest codebook entry, argmax on the device). Padded frames
are masked before and after every conv, so tokens do not depend on the
padding bucket.

Under an active mesh (``parallel/``) each block runs on this rank's
slices: ``wq`` / ``wk`` / ``wv`` / ``w_up`` column-parallel, ``wo`` /
``w_down`` row-parallel with their partial products summed over the model
group in f32; the convolutions, norms and codebook stay whole.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from ..ops.attention import sdpa
from ..ops.conv import conv1d, conv1d_init, layer_norm, layer_norm_init
from ..parallel import comm
from ..utils.config import SpeechTokenizerConfig
from .transformer import dense_product, row_proj
from ..weights import normal

Params = Dict


def init_params(cfg: SpeechTokenizerConfig, generator: torch.Generator) -> Params:
    D = cfg.dim
    dev = generator.device
    p: Params = {"sub": [], "enc": [], "codebook": None}
    in_ch = cfg.n_mels
    for _ in cfg.strides:
        p["sub"].append({"conv": conv1d_init(generator, in_ch, D, 4), "ln": layer_norm_init(D, dev)})
        in_ch = D
    s = D ** -0.5
    for _ in range(cfg.n_layers):
        p["enc"].append({
            "ln1": layer_norm_init(D, dev),
            "wq": normal((D, D), generator, s),
            "wk": normal((D, D), generator, s),
            "wv": normal((D, D), generator, s),
            "wo": normal((D, D), generator, s),
            "ln2": layer_norm_init(D, dev),
            "w_up": normal((D, cfg.ffn_dim), generator, s),
            "w_down": normal((cfg.ffn_dim, D), generator, cfg.ffn_dim ** -0.5),
        })
    p["codebook"] = normal((cfg.codebook_size, D), generator)
    return p


class TokenizeResult(NamedTuple):
    tokens: torch.Tensor        # [B, T_tok] int32
    token_mask: torch.Tensor    # [B, T_tok] bool
    pre_vq: torch.Tensor        # [B, T_tok, D] encoder output


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")   # the reference's default form


def apply(
    params: Params,
    cfg: SpeechTokenizerConfig,
    mel: torch.Tensor,          # [B, T, n_mels] (100 Hz frames)
    frame_mask: torch.Tensor,   # [B, T]
) -> TokenizeResult:
    m = frame_mask
    h = mel * m[..., None].to(mel.dtype)
    for sub, stride in zip(params["sub"], cfg.strides):
        h = conv1d(h, sub["conv"], stride=stride)
        m = m[:, ::stride][:, : h.shape[1]]
        h = _gelu(layer_norm(h, sub["ln"])) * m[..., None].to(h.dtype)
    B, T, D = h.shape
    hd = D // cfg.n_heads
    attn_mask = (m[:, None, None, :] > 0) & (m[:, None, :, None] > 0)
    for blk in params["enc"]:
        n_heads = blk["wq"].shape[-1] // hd         # this rank's heads under a mesh
        attn_cut, mlp_cut = n_heads < cfg.n_heads, blk["w_up"].shape[-1] < cfg.ffn_dim
        x = layer_norm(h, blk["ln1"])
        xa = comm.copy_to_model(x) if attn_cut else x
        q = (xa @ blk["wq"].to(x.dtype)).reshape(B, T, n_heads, hd)
        k = (xa @ blk["wk"].to(x.dtype)).reshape(B, T, n_heads, hd)
        v = (xa @ blk["wv"].to(x.dtype)).reshape(B, T, n_heads, hd)
        att = sdpa(q, k, v, attn_mask).reshape(B, T, n_heads * hd)
        h = h + row_proj(att, blk["wo"], D, product=dense_product)
        x = layer_norm(h, blk["ln2"])
        xm = comm.copy_to_model(x) if mlp_cut else x
        h = h + row_proj(_gelu(xm @ blk["w_up"].to(x.dtype)), blk["w_down"], cfg.ffn_dim, product=dense_product)
    tokens = quantize(params["codebook"], h)
    return TokenizeResult(tokens=tokens, token_mask=m > 0, pre_vq=h)


def vq_scores(codebook: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """[B, T, C] scores whose argmax is the nearest codebook entry by L2:
    ||h - c||^2 = ||h||^2 - 2 h.c + ||c||^2, and ||h||^2 is constant per
    frame."""
    cb = codebook.float()
    return 2.0 * torch.einsum("btd,cd->btc", h.float(), cb) - (cb * cb).sum(-1)


def quantize(codebook: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Nearest codebook entry by L2: one matmul + argmax on the device."""
    return torch.argmax(vq_scores(codebook, h), dim=-1).to(torch.int32)


def codebook_lookup(codebook: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return codebook[tokens.long()]
