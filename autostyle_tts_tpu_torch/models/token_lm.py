"""Speech-token LM: (text, style prompt, timbre) -> discrete speech tokens.

Counterpart of the JAX ``models/token_lm.py`` on the main path:
``core_config``, ``init_params``, ``build_prefix``, ``pad_prefix``,
``generate_speech(_from_ids)`` with the decode loop of ``_generate_fused``
over the decode-step kernel, and ``mega_decode_params`` (int8) in the
kernel's output-major layout. Prefix layout, as there:

    [SPK] [text: prompt_text ++ tts_text] [BOS_s] [style speech tokens] | gen...

The decode loop runs on the host: one decode-step op per token and one
host read of the sampled token for the EOS check.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..ops.attention import rope_inv_freq
from ..ops.decode_step import decode_scratch, mega_decode_step
from ..ops.sampling import SamplerConfig, sample
from ..utils.config import TokenLMConfig, TransformerConfig
from ..utils.timing import Stopwatch
from ..weights import QTensor, normal
from . import transformer as core

Params = Dict
NEG_INF = -1e30


def core_config(cfg: TokenLMConfig) -> TransformerConfig:
    """The trunk reuses the shared core with the TEXT vocab; it always
    computes in bf16."""
    return TransformerConfig(
        vocab_size=cfg.text_vocab_size, dim=cfg.dim, n_layers=cfg.n_layers,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, ffn_dim=cfg.ffn_dim,
        max_seq_len=cfg.max_seq_len, rope_theta=cfg.rope_theta,
        norm_eps=cfg.norm_eps, dtype="bfloat16",
    )


def init_params(cfg: TokenLMConfig, generator: torch.Generator) -> Params:
    D = cfg.dim
    p = core.init_params(core_config(cfg), generator)
    p["speech_emb"] = normal((cfg.speech_vocab_size, D), generator, D ** -0.5)
    p["speech_head"] = normal((D, cfg.speech_vocab_size), generator, D ** -0.5)
    p["spk_proj"] = normal((cfg.spk_dim, D), generator, cfg.spk_dim ** -0.5)
    return p


def mega_decode_params(params: Params, cfg: TokenLMConfig) -> Dict[str, torch.Tensor]:
    """The int8 weights in the decode kernel's layout, built once: every
    projection output-major ([rows, in], one contiguous int8 row per output
    channel) with its scales as [L, rows]; gate rows then up rows; the
    speech embedding in bf16; the RoPE inverse frequencies."""
    lp = params["layers"]
    for name in ("wqkv", "wo", "w_gate_up", "w_down"):
        if not isinstance(lp[name], QTensor):
            raise NotImplementedError(
                "the decode kernel takes int8 weights only (quantize_lm_int8=True); "
                "the scanned non-int8 decode is ROADMAP.md queue A"
            )

    def out_major(t: QTensor):
        return t.q.transpose(-1, -2).contiguous(), t.s.squeeze(-2).contiguous()

    mp = {}
    mp["wqkv"], mp["wqs"] = out_major(lp["wqkv"])
    mp["wo"], mp["wos"] = out_major(lp["wo"])
    mp["wgu"], mp["wgus"] = out_major(lp["w_gate_up"])
    mp["wd"], mp["wds"] = out_major(lp["w_down"])
    mp["head"], mp["head_s"] = out_major(params["speech_head"])
    dev = mp["wqkv"].device
    mp["emb"] = params["speech_emb"].to(torch.bfloat16).contiguous()
    mp["invf"] = rope_inv_freq(cfg.head_dim, cfg.rope_theta, device=dev)
    mp["attn_norm"] = lp["attn_norm"].float().contiguous()
    mp["mlp_norm"] = lp["mlp_norm"].float().contiguous()
    mp["final_norm"] = params["final_norm"].float().contiguous()
    return mp


_SHARED = {"wqkv": ("wqkv", "wqs"), "wo": ("wo", "wos"),
           "w_gate_up": ("wgu", "wgus"), "w_down": ("wd", "wds")}


def share_decode_weights(params: Params, mp: Dict[str, torch.Tensor]) -> Params:
    """``params`` with the int8 projections the prefill reads (layers and
    speech head) rebound to transposed views of their output-major copies
    in ``mp``, so one int8 copy of the LM serves prefill and decode."""
    layers = dict(params["layers"])
    for name, (q, s) in _SHARED.items():
        layers[name] = QTensor(q=mp[q].transpose(-1, -2), s=mp[s].unsqueeze(-2))
    out = dict(params, layers=layers)
    out["speech_head"] = QTensor(q=mp["head"].transpose(-1, -2), s=mp["head_s"].unsqueeze(-2))
    return out


# ----------------------------------------------------------------------- prefix building


class Prefix(NamedTuple):
    embeds: torch.Tensor    # [B, P, D] LEFT-padded prefix embeddings
    length: torch.Tensor    # [B] real lengths


def build_prefix(
    params: Params, cfg: TokenLMConfig,
    text: torch.Tensor,          # [B, T_txt] right-padded text ids
    text_len: torch.Tensor,      # [B]
    style_tokens: torch.Tensor,  # [B, T_sty] right-padded speech tokens
    style_len: torch.Tensor,     # [B]
    spk: torch.Tensor,           # [B, spk_dim]
) -> Prefix:
    """[SPK][text][BOS_s][style tokens], LEFT-padded, placed by index
    arithmetic."""
    B, T_txt = text.shape
    T_sty = style_tokens.shape[1]
    dev = text.device
    P = 1 + T_txt + 1 + T_sty
    text_len = text_len.long()
    style_len = style_len.long()
    total = 2 + text_len + style_len
    pad = P - total
    r = torch.arange(P, device=dev)[None, :] - pad[:, None]
    in_text = (r >= 1) & (r <= text_len[:, None])
    is_spk = r == 0
    is_bos = r == (text_len + 1)[:, None]
    in_style = (r >= (text_len + 2)[:, None]) & (r < total[:, None])
    text_idx = torch.clamp(r - 1, 0, T_txt - 1)
    style_idx = torch.clamp(r - (text_len + 2)[:, None], 0, T_sty - 1)
    text_e = params["tok_emb"][torch.gather(text.long(), 1, text_idx)]
    style_e = params["speech_emb"][torch.gather(style_tokens.long(), 1, style_idx)]
    spk_e = (spk.float() @ params["spk_proj"])[:, None, :]
    bos_e = params["speech_emb"][cfg.speech_bos][None, None, :]
    emb = torch.zeros_like(text_e)
    emb = torch.where(is_spk[..., None], spk_e, emb)
    emb = torch.where(in_text[..., None], text_e, emb)
    emb = torch.where(is_bos[..., None], bos_e, emb)
    emb = torch.where(in_style[..., None], style_e, emb)
    return Prefix(embeds=emb, length=total)


def pad_prefix(prefix: Prefix, multiple: int = 128) -> Prefix:
    """Extend the LEFT padding so P is a multiple of ``multiple``."""
    B, P, D = prefix.embeds.shape
    extra = (-P) % multiple
    if extra == 0:
        return prefix
    pad = prefix.embeds.new_zeros((B, extra, D))
    return Prefix(embeds=torch.cat([pad, prefix.embeds], dim=1), length=prefix.length)


# ----------------------------------------------------------------------- generate


class SpeechGen(NamedTuple):
    tokens: torch.Tensor    # [B, max_new] int32 (pad after EOS)
    lengths: torch.Tensor   # [B] tokens before EOS
    decode_steps: int       # decode-step ops run (tokens 1.. of the loop)


def _mask_logits(logits: torch.Tensor, cfg: TokenLMConfig, suppress_eos: bool) -> torch.Tensor:
    logits = logits.clone()
    logits[:, cfg.speech_pad] = NEG_INF
    logits[:, cfg.speech_bos] = NEG_INF
    if suppress_eos:
        logits[:, cfg.speech_eos] = NEG_INF
    return logits


def generate_speech(
    params: Params,
    cfg: TokenLMConfig,
    prefix: Prefix,
    generator: Optional[torch.Generator],
    *,
    max_new_tokens: int,
    decode_params: Dict[str, torch.Tensor],
    sampler: SamplerConfig = SamplerConfig(temperature=1.0, top_k=25),
    min_tokens: int = 2,
    clock: Optional[Stopwatch] = None,
) -> SpeechGen:
    """B=1 prefill (flash attention) + decode over the decode-step op.

    Token 0 comes from the prefill logits through ``sample``; tokens 1..
    from the decode step, which samples in its kernel. The loop stops after
    EOS (later slots stay pad); ``lengths`` counts the tokens before EOS;
    EOS is masked while fewer than ``min_tokens`` were drawn. The cache is
    bf16 (an int8 KV cache is not used on this path, as in the reference's
    fused decode)."""
    ccfg = core_config(cfg)
    B, P, D = prefix.embeds.shape
    if B != 1:
        raise NotImplementedError("B>1 generation: ROADMAP.md queue A (batched staged path)")
    if ccfg.n_heads != ccfg.n_kv_heads:
        raise NotImplementedError("GQA token LM (H != K): ROADMAP.md queue A (scanned decode)")
    if not sampler.greedy and sampler.top_p < 1.0:
        raise NotImplementedError("top-p decode: ROADMAP.md queue A (scanned decode)")
    dev = prefix.embeds.device
    clock = clock or Stopwatch(dev)
    S_max = -(-(P + max_new_tokens + 1) // 8) * 8
    eos, padt = cfg.speech_eos, cfg.speech_pad
    with clock.span("prefill"):
        cache = core.make_cache(ccfg, B, S_max, dev)
        offset = (P - prefix.length).to(torch.int32)
        pos = torch.clamp(torch.arange(P, device=dev)[None, :] - offset[:, None], min=0)
        hidden = core.forward(
            params, ccfg, inputs_embeds=prefix.embeds, positions=pos,
            offset=offset, cache=cache,
        )
        next_logits = core.matmul_any(hidden[:, -1], params["speech_head"])
        tok = sample(_mask_logits(next_logits, cfg, 0 < min_tokens), sampler, generator)
        off0 = int(offset[0])
        seeds = torch.randint(0, 2 ** 31 - 1, (max_new_tokens,), generator=generator,
                              device=dev).tolist()
    L = ccfg.n_layers
    k_all = cache["k"].view(L, S_max, -1)
    v_all = cache["v"].view(L, S_max, -1)
    toks = [int(tok[0])]
    with clock.span("decode"):
        tok_prev = tok.to(torch.int32).reshape(1)
        scratch = decode_scratch(decode_params, ccfg.n_heads, ccfg.head_dim, dev)
        i = 1
        while i < max_new_tokens and toks[-1] != eos:
            _, tok_prev = mega_decode_step(
                tok_prev, decode_params, k_all, v_all, P + i - 1, off0,
                i < min_tokens, seeds[i],
                n_heads=ccfg.n_heads, head_dim=ccfg.head_dim, eps=ccfg.norm_eps,
                pad_id=padt, bos_id=cfg.speech_bos, eos_id=eos,
                greedy=sampler.greedy, temperature=sampler.temperature,
                top_k=sampler.top_k, scratch=scratch,
            )
            toks.append(int(tok_prev[0]))
            i += 1
    gen_len = sum(1 for t in toks if t != eos)
    out = torch.full((1, max_new_tokens), padt, dtype=torch.int32)
    out[0, : len(toks)] = torch.tensor(toks, dtype=torch.int32)
    return SpeechGen(tokens=out.to(dev), lengths=torch.tensor([gen_len], dtype=torch.int32, device=dev),
                     decode_steps=len(toks) - 1)


def generate_speech_from_ids(
    params: Params,
    cfg: TokenLMConfig,
    text: torch.Tensor,
    text_len: torch.Tensor,
    style_tokens: torch.Tensor,
    style_len: torch.Tensor,
    spk: torch.Tensor,
    generator: Optional[torch.Generator],
    *,
    max_new_tokens: int,
    decode_params: Dict[str, torch.Tensor],
    sampler: SamplerConfig = SamplerConfig(temperature=1.0, top_k=25),
    min_tokens: int = 2,
    pad_multiple: int = 128,
    clock: Optional[Stopwatch] = None,
) -> SpeechGen:
    """build_prefix + pad_prefix + generate_speech."""
    pre = build_prefix(params, cfg, text, text_len, style_tokens, style_len, spk)
    pre = pad_prefix(pre, multiple=pad_multiple)
    return generate_speech(
        params, cfg, pre, generator, max_new_tokens=max_new_tokens,
        decode_params=decode_params, sampler=sampler, min_tokens=min_tokens,
        clock=clock,
    )
