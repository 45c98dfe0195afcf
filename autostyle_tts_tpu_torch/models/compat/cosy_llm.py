"""CosyVoice TransformerLM compat: converted llm.pt -> speech tokens.

Counterpart of the JAX ``models/compat/cosy_llm.py``: a conformer text
encoder + affine, sos/task embeddings, a speaker affine over the
normalized x-vector, a speech-token embedding, a causal transformer trunk,
and a (speech_vocab+1)-way decoder head whose last class is EOS. Prefix
layout (upstream inference order):

    [sos_eos] [spk] [text_encoder(text) @ affine] [task] [speech_emb(prompt)]

``generate`` is a prefill over the padded prefix, then a host loop of
``wenet_conformer.decode_step`` that stops when every row has drawn EOS
(one host read a step). Geometry is never hardcoded: ``infer_config``
reads it off the converted tree. Sampling draws from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import torch

from ...ops.sampling import SamplerConfig, sample
from . import wenet_conformer as wc

Params = Dict


@dataclass(frozen=True)
class CosyLLMConfig:
    text_vocab: int
    speech_vocab: int                  # upstream speech_token_size; EOS id
    llm_dim: int
    spk_dim: int
    text_enc: wc.WenetEncoderConfig
    llm: wc.WenetEncoderConfig
    sos_eos: int = 0
    task_id: int = 1


def _enc_config(tree: Params, input_dim: int, activation: str) -> wc.WenetEncoderConfig:
    lw = tree["layers"]
    L, D, _ = lw["q"]["w"].shape
    F = lw["ff_w1"]["w"].shape[-1]
    H = lw["pos_bias_u"].shape[1]
    return wc.WenetEncoderConfig(
        input_dim=input_dim, dim=D, n_layers=L, n_heads=H, ffn_dim=F,
        macaron="ffm_w1" in lw, use_cnn="conv_pw1" in lw,
        cnn_kernel=lw["conv_dw"]["w"].shape[1] if "conv_pw1" in lw else 15,
        in_norm="in_norm" in tree, activation=activation,
    )


def infer_config(tree: Params, spk_dim: int = 192) -> CosyLLMConfig:
    """Read the whole LLM geometry off a converted param tree."""
    text_vocab, text_in = tree["text_embedding"].shape
    llm_dim = tree["llm_embedding"].shape[1]
    head_out = tree["llm_decoder"]["w"].shape[1]
    return CosyLLMConfig(
        text_vocab=text_vocab,
        speech_vocab=head_out - 1,     # +1 head class = EOS
        llm_dim=llm_dim,
        spk_dim=tree["spk_affine"]["w"].shape[0],
        text_enc=_enc_config(tree["text_encoder"], text_in, "silu"),
        llm=_enc_config(tree["llm"], llm_dim, "relu"),
    )


class Generated(NamedTuple):
    tokens: torch.Tensor    # [B, max_new] int32 (pad = speech_vocab)
    lengths: torch.Tensor   # [B]


def encode_text(params: Params, cfg: CosyLLMConfig, text_ids, text_mask):
    emb = params["text_embedding"][text_ids.long()]
    h = wc.apply_encoder(params["text_encoder"], cfg.text_enc, emb, text_mask)
    return h @ params["text_encoder_affine"]["w"] + params["text_encoder_affine"]["b"]


def _norm_spk(spk: torch.Tensor) -> torch.Tensor:
    return spk / torch.clamp(torch.linalg.norm(spk, dim=-1, keepdim=True), min=1e-6)


def build_prefix(
    params: Params,
    cfg: CosyLLMConfig,
    text_ids: torch.Tensor,      # [B, Wt] int32, left-aligned
    text_lens: torch.Tensor,     # [B]
    prompt_tokens: torch.Tensor, # [B, Wp] int32 prompt speech tokens
    prompt_lens: torch.Tensor,   # [B]
    spk: torch.Tensor,           # [B, spk_dim]
):
    """-> (prefix_emb [B, P, llm_dim], prefix_mask [B, P], prefix_lens [B]).
    P = 3 + Wt + Wp. Content is left-compacted per row (no pad gaps inside)
    so decode positions continue at prefix_lens."""
    B, Wt = text_ids.shape
    Wp = prompt_tokens.shape[1]
    P = 3 + Wt + Wp
    D = cfg.llm_dim
    dev = text_ids.device
    t_mask = (torch.arange(Wt, device=dev)[None, :] < text_lens[:, None]).float()
    text_h = encode_text(params, cfg, text_ids, t_mask)     # [B, Wt, D]
    spk_e = _norm_spk(spk) @ params["spk_affine"]["w"] + params["spk_affine"]["b"]
    sos = params["llm_embedding"][cfg.sos_eos][None, None].expand(B, 1, D)
    task = params["llm_embedding"][cfg.task_id][None, None]
    sp_emb = params["speech_embedding"][prompt_tokens.long()]    # [B, Wp, D]

    # slot map: [sos | spk | text(0..lt) | task | prompt(0..lp)], compacted
    lt = text_lens[:, None]
    lp = prompt_lens[:, None]
    pos = torch.arange(P, device=dev)[None, :]              # [1, P]
    prefix_lens = 3 + text_lens + prompt_lens
    in_text = (pos >= 2) & (pos < 2 + lt)
    is_task = pos == 2 + lt
    in_prompt = (pos > 2 + lt) & (pos < 3 + lt + lp)
    text_idx = torch.clamp(pos - 2, 0, Wt - 1).expand(B, P)
    prompt_idx = torch.clamp(pos - 3 - lt, 0, Wp - 1)
    text_g = torch.gather(text_h, 1, text_idx[..., None].expand(B, P, D))
    prompt_g = torch.gather(sp_emb, 1, prompt_idx[..., None].expand(B, P, D))
    zero = torch.zeros((), dtype=text_h.dtype, device=dev)
    emb = torch.where(
        (pos == 0)[..., None], sos,
        torch.where(
            (pos == 1)[..., None], spk_e[:, None, :],
            torch.where(
                in_text[..., None], text_g,
                torch.where(
                    is_task[..., None], task.expand(B, P, D),
                    torch.where(in_prompt[..., None], prompt_g, zero),
                ),
            ),
        ),
    )
    mask = (pos < prefix_lens[:, None]).float()
    return emb * mask[..., None], mask, prefix_lens


@torch.no_grad()
def generate(
    params: Params,
    cfg: CosyLLMConfig,
    text_ids: torch.Tensor,
    text_lens: torch.Tensor,
    prompt_tokens: torch.Tensor,
    prompt_lens: torch.Tensor,
    spk: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    max_new_tokens: int = 128,
    sampler: SamplerConfig = SamplerConfig(top_k=25),
) -> Generated:
    """Prefix build + prefill + a decode loop that stops once every row
    has drawn EOS. Upstream samples top-k 25 over (speech_vocab+1) classes
    and stops on the EOS class; emitted ids are < speech_vocab. Draws come
    from ``generator`` (unused when ``sampler.greedy``)."""
    if sampler.top_k and sampler.top_k >= cfg.speech_vocab + 1:
        # tiny synthetic vocabs can undercut the upstream top-k 25 default
        sampler = dataclasses.replace(sampler, top_k=0)
    B, Wt = text_ids.shape
    dev = text_ids.device
    P = 3 + Wt + prompt_tokens.shape[1]
    s_max = P + max_new_tokens
    emb, pmask, prefix_lens = build_prefix(
        params, cfg, text_ids, text_lens, prompt_tokens, prompt_lens, spk
    )
    h_all, cache = wc.prefill(params["llm"], cfg.llm, emb, pmask, s_max)
    # hidden at the last REAL prefix slot per row
    h_last = torch.gather(h_all, 1, (prefix_lens - 1).long()[:, None, None].expand(B, 1, h_all.shape[-1]))[:, 0]
    pe_dec = wc.relpos_table(torch.arange(cfg.llm.max_rel, device=dev), cfg.llm.dim)
    eos = cfg.speech_vocab
    tokens = torch.full((B, max_new_tokens), eos, dtype=torch.int32, device=dev)
    lens = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    # B=1-style position: every row decodes at row 0's next slot, as the
    # reference's loop does (its serving shape is B = 1)
    pos0 = int(prefix_lens[0])
    for i in range(max_new_tokens):
        logits = h_last @ params["llm_decoder"]["w"] + params["llm_decoder"]["b"]   # [B, Vs+1]
        tok = sample(logits, sampler, generator).to(torch.int32)
        is_eos = tok >= eos
        tok_emit = torch.where(done | is_eos, torch.full_like(tok, eos), tok)
        tokens[:, i] = tok_emit
        lens = torch.where(done | is_eos, lens, lens + 1)
        done = done | is_eos
        if bool(done.all()):
            break
        emb_t = params["speech_embedding"][torch.clamp(tok_emit, 0, eos).long()]
        h_last, cache = wc.decode_step(params["llm"], cfg.llm, cache, emb_t, pos0 + i,
                                       prefix_lens + i + 1, pe_dec)
    return Generated(tokens=tokens, lengths=lens)
