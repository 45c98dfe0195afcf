"""Speech-token LM: (text, style prompt, timbre) -> discrete speech tokens.

Counterpart of the JAX ``models/token_lm.py``: ``core_config``,
``init_params``, ``build_prefix``, ``pad_prefix``,
``generate_speech(_from_ids)`` with the reference's scanned decode and
both flavours of the decode loop of its ``_generate_fused``,
``mega_decode_params`` (int8, or int4 with ``bits=4``) in the kernels'
output-major layout and ``unstack_decode_params`` (per-layer views of it),
and continuous batching's ``build_prefix_padded``, ``prefill_prefix``,
``_chunk_tick`` and ``decode_chunk``. Prefix layout, as there:

    [SPK] [text: prompt_text ++ tts_text] [BOS_s] [style speech tokens] | gen...

Every decode loop runs on the host, as a generator (``start_decode``) that
hands out each step's tokens as it draws them, so a stream can render
audio while the LM goes on; ``generate_speech`` runs it to its end. The
scanned decode (any B, GQA, dense or int8 weights, a bf16 or int8 KV
cache, any sampler) runs the transformer core one token a step for every
row and reads the step's tokens to the host to stop once every row has
emitted EOS. With a dict of ``mega_decode_params`` (B=1) it is one
decode-step op per token, which samples in its kernel, and one host read of
the token for the EOS check. With a list of ``unstack_decode_params`` it is
an ``attn_step`` and an ``mlp_step`` per layer and token, the speech head in
plain PyTorch and the host sampler. ``lm_loss`` is the training objective.
"""

from __future__ import annotations

from typing import Dict, Generator, List, NamedTuple, Optional, Tuple, Union

import torch

from ..ops.attention import apply_rope, causal_mask, quantize_kv, rope_inv_freq, rope_table
from ..ops.decode_step import (WEIGHT_KEYS, attn_step, decode_scratch, mega_decode_step,
                               mlp_step, pack4, part_shape, weight_bits)
from ..ops.sampling import SamplerConfig, sample, transform_logits
from ..utils.config import TokenLMConfig, TransformerConfig
from ..utils.timing import Stopwatch
from ..weights import QTensor, normal, truncated_normal
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


def _trunk_init(ccfg: TransformerConfig, generator: torch.Generator) -> Params:
    """The trunk with the core's shapes and scales (truncated normal at +-3
    sigma, std 1/sqrt(fan_in); norms at one), drawn from the engine's
    generator: the engine's weights come from a ``torch.Generator``, not
    from a JAX key (no tracked artifact was trained over a drawn engine)."""
    L, D, dev = ccfg.n_layers, ccfg.dim, generator.device

    def dense(fan_in, shape):
        return truncated_normal(shape, generator, fan_in ** -0.5)

    tok_emb = dense(D, (ccfg.vocab_size, D))
    proj = {name: dense(fi, (L, fi, fo)) for name, (fi, fo) in core.proj_shapes(ccfg).items()}
    return {
        "tok_emb": tok_emb,
        "layers": {"attn_norm": torch.ones((L, D), device=dev), "wqkv": proj["wqkv"], "wo": proj["wo"],
                   "mlp_norm": torch.ones((L, D), device=dev), "w_gate_up": proj["w_gate_up"],
                   "w_down": proj["w_down"]},
        "final_norm": torch.ones((D,), device=dev),
        "lm_head": dense(D, (D, ccfg.vocab_size)),
    }


def init_params(cfg: TokenLMConfig, generator: torch.Generator) -> Params:
    D = cfg.dim
    p = _trunk_init(core_config(cfg), generator)
    p["speech_emb"] = normal((cfg.speech_vocab_size, D), generator, D ** -0.5)
    p["speech_head"] = normal((D, cfg.speech_vocab_size), generator, D ** -0.5)
    p["spk_proj"] = normal((cfg.spk_dim, D), generator, cfg.spk_dim ** -0.5)
    return p


def mega_decode_params(params: Params, cfg: TokenLMConfig, bits: int = 8) -> Dict[str, torch.Tensor]:
    """The int8 weights in the decode kernel's layout, built once: every
    projection output-major ([rows, in], one contiguous int8 row per output
    channel) with its scales as [L, rows]; gate rows then up rows; the
    speech embedding in bf16; the RoPE inverse frequencies. ``bits=4``
    re-quantizes every weight stream to 4 bits (``requantize_int4``)."""
    if bits not in (8, 4):
        raise ValueError(f"mega_decode_params: bits must be 8 or 4, got {bits}")
    lp = params["layers"]
    for name in ("wqkv", "wo", "w_gate_up", "w_down"):
        if not isinstance(lp[name], QTensor):
            raise ValueError(
                "the decode kernel takes int8 weights only (quantize_lm_int8=True); "
                "a dense LM takes the scanned decode (decode_params=None)"
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
    return mp if bits == 8 else requantize_int4(mp)


_SCALE_OF = {"wqkv": "wqs", "wo": "wos", "wgu": "wgus", "wd": "wds", "head": "head_s"}


def requantize4(q8: torch.Tensor, s8: torch.Tensor):
    """One int8 stream [..., rows, C] with scales [..., rows] at 4 bits:
    w = q8 * s8, s4 = max(absmax over the contraction, 1e-8) / 7 per output
    channel, q4 = clip(round(w / s4), -7, 7). The values equal the JAX
    packer's (``_pack4_lanes``; its shared down-projection scale is this
    same absmax over the whole contraction). Returns (q4 int8, s4 f32)."""
    w = q8.float() * s8.float()[..., None]
    s4 = torch.clamp(w.abs().amax(dim=-1), min=1e-8) / 7.0
    q4 = torch.clamp(torch.round(w / s4[..., None]), -7, 7).to(torch.int8)
    return q4, s4


def requantize_int4(mp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """int8 ``mega_decode_params`` -> the same dict with every weight
    stream (qkv, wo, gate|up, down, head) re-quantized to 4 bits and packed
    two contraction elements a byte (``ops/decode_step.pack4``): half the
    weight bytes per step. Embedding, norms and scales stay bf16 / f32. The
    port's own rule replaces the reference's lane rule: every contraction
    width must be even (the kernel asks for multiples of 32 on the card);
    anything else raises, nothing falls back to int8."""
    if weight_bits(mp) != 8:
        raise ValueError("requantize_int4: the params are packed already")
    out = dict(mp)
    for name in WEIGHT_KEYS:
        q4, out[_SCALE_OF[name]] = requantize4(mp[name], mp[_SCALE_OF[name]])
        out[name] = pack4(q4).contiguous()
    return out


def unstack_decode_params(params: Params, cfg: TokenLMConfig) -> List[Dict[str, torch.Tensor]]:
    """Per-layer int8 weights for ``attn_step`` / ``mlp_step``, output-major.
    When ``params`` went through ``share_decode_weights`` these are views of
    the decode kernel's one int8 copy; otherwise each projection is
    transposed into a copy here."""
    lp = params["layers"]
    for name in ("wqkv", "wo", "w_gate_up", "w_down"):
        if not isinstance(lp[name], QTensor):
            raise ValueError(
                "the decode kernels take int8 weights only (quantize_lm_int8=True); "
                "a dense LM takes the scanned decode (decode_params=None)"
            )

    def row_major(t: QTensor, l: int):
        return t.q[l].transpose(-1, -2).contiguous(), t.s[l].squeeze(-2).contiguous()

    layers = []
    for l in range(cfg.n_layers):
        lw = {"attn_norm": lp["attn_norm"][l].float().contiguous(),
              "mlp_norm": lp["mlp_norm"][l].float().contiguous()}
        lw["wqkv"], lw["wqs"] = row_major(lp["wqkv"], l)
        lw["wo"], lw["wos"] = row_major(lp["wo"], l)
        lw["wgu"], lw["wgus"] = row_major(lp["w_gate_up"], l)
        lw["wd"], lw["wds"] = row_major(lp["w_down"], l)
        layers.append(lw)
    return layers


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


DecodeParams = Union[Dict[str, torch.Tensor], List[Dict[str, torch.Tensor]]]
# a decode loop: yields each step's tokens (one host int a row), returns the SpeechGen
DecodeLoop = Generator[List[int], None, SpeechGen]


def start_decode(
    params: Params,
    cfg: TokenLMConfig,
    prefix: Prefix,
    generator: Optional[torch.Generator],
    *,
    max_new_tokens: int,
    decode_params: Optional[DecodeParams] = None,
    sampler: SamplerConfig = SamplerConfig(temperature=1.0, top_k=25),
    min_tokens: int = 2,
    kv_int8: bool = False,
    fused: bool = True,
    clock: Optional[Stopwatch] = None,
) -> DecodeLoop:
    """Runs the prefill (flash attention) now, under ``clock``'s "prefill"
    span, and returns the decode loop: a generator that draws one token a
    row each time it is advanced, yields them as host ints (``[B]``, one
    device read a step) and, once it has ended, returns the ``SpeechGen``.
    EOS and BOS are masked (pad always), EOS while fewer than
    ``min_tokens`` were drawn; a row that drew EOS draws pad after it, and
    the loop ends once every row has drawn EOS or after
    ``max_new_tokens`` steps. ``lengths`` counts the tokens before EOS.

    ``decode_params`` with ``fused`` picks the decode kernels, as the
    reference does (B=1, int8 weights, H = K; the cache is bf16 and
    ``kv_int8`` is ignored): a dict (``mega_decode_params``) runs one
    decode-step op per token; a list (``unstack_decode_params``) runs the
    per-layer ``attn_step`` / ``mlp_step`` pair with the plain head and the
    host sampler. A dict with a top-p sampler, no ``decode_params`` or
    ``fused=False`` take the scanned decode (``_decode_scan``). The loop
    holds no span of ``clock`` across its yields: the caller times it."""
    ccfg = core_config(cfg)
    B, P, D = prefix.embeds.shape
    if isinstance(decode_params, dict) and not sampler.greedy and sampler.top_p < 1.0:
        fused = False     # the decode-step kernel samples greedy / temperature / top-k only
    kernels = fused and decode_params is not None
    if kernels and (B != 1 or ccfg.n_heads != ccfg.n_kv_heads):
        raise ValueError(f"the decode kernels serve B=1 and H = K (got B={B}, "
                         f"H={ccfg.n_heads}, K={ccfg.n_kv_heads}); pass decode_params=None")
    dev = prefix.embeds.device
    clock = clock or Stopwatch(dev)
    S_max = -(-(P + max_new_tokens + 1) // 8) * 8
    with clock.span("prefill"):
        cache = core.make_cache(ccfg, B, S_max, dev, quantized=kv_int8 and not kernels)
        offset = (P - prefix.length).to(torch.int32)
        pos = torch.clamp(torch.arange(P, device=dev)[None, :] - offset[:, None], min=0)
        hidden = core.forward(params, ccfg, inputs_embeds=prefix.embeds, positions=pos,
                              offset=offset, cache=cache)
        next_logits = core.matmul_any(hidden[:, -1], params["speech_head"])
    kw = dict(P=P, max_new_tokens=max_new_tokens, sampler=sampler, min_tokens=min_tokens)
    if not kernels:
        return _decode_scan(params, cfg, ccfg, cache, next_logits, generator, offset, **kw)
    L = ccfg.n_layers
    k_all = cache["k"].view(L, S_max, -1)
    v_all = cache["v"].view(L, S_max, -1)
    loop = _decode_mega if isinstance(decode_params, dict) else _decode_layers
    return loop(params, decode_params, cfg, ccfg, k_all, v_all, next_logits, generator,
                off0=int(offset[0]), **kw)


def take(loop: DecodeLoop, n: int) -> Tuple[List[List[int]], Optional["SpeechGen"]]:
    """Advance a decode loop by up to ``n`` steps: (the steps' tokens, the
    loop's ``SpeechGen`` if it has ended, else None)."""
    out: List[List[int]] = []
    try:
        while len(out) < n:
            out.append(next(loop))
    except StopIteration as stop:
        return out, stop.value
    return out, None


def finish(loop: DecodeLoop) -> "SpeechGen":
    """Run a decode loop to its end and return its ``SpeechGen``."""
    while True:
        _, gen = take(loop, 1 << 30)
        if gen is not None:
            return gen


def generate_speech(
    params: Params,
    cfg: TokenLMConfig,
    prefix: Prefix,
    generator: Optional[torch.Generator],
    *,
    max_new_tokens: int,
    decode_params: Optional[DecodeParams] = None,
    sampler: SamplerConfig = SamplerConfig(temperature=1.0, top_k=25),
    min_tokens: int = 2,
    kv_int8: bool = False,
    fused: bool = True,
    clock: Optional[Stopwatch] = None,
) -> SpeechGen:
    """Prefill + decode to the end (``start_decode``, then its loop under
    the "decode" span)."""
    clock = clock or Stopwatch(prefix.embeds.device)
    loop = start_decode(params, cfg, prefix, generator, max_new_tokens=max_new_tokens,
                        decode_params=decode_params, sampler=sampler, min_tokens=min_tokens,
                        kv_int8=kv_int8, fused=fused, clock=clock)
    with clock.span("decode"):
        return finish(loop)


def _decode_scan(params, cfg, ccfg, cache, next_logits, generator, offset, *, P,
                 max_new_tokens, sampler, min_tokens) -> DecodeLoop:
    """The reference's scanned decode, one host iteration a step: sample
    token i of every row from the previous logits (rows already done emit
    pad), yield the row's tokens (the one device read of the step), then
    run the core on them at cache slot P + i under the mask of the row's
    valid slots, and take the head's f32 logits. The loop ends after
    ``max_new_tokens`` steps or once every row is done; ``decode_steps``
    counts the core's runs."""
    B = next_logits.shape[0]
    dev = next_logits.device
    eos, padt = cfg.speech_eos, cfg.speech_pad
    S_max = cache["k"].shape[2]
    slot = torch.arange(S_max, device=dev)
    valid = slot[None, :] >= offset.long()[:, None]
    toks = torch.full((B, max_new_tokens), padt, dtype=torch.int32, device=dev)
    gen_len = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    head, emb = params["speech_head"], params["speech_emb"]
    cur = next_logits
    steps = 0
    for i in range(max_new_tokens):
        tok = sample(_mask_logits(cur, cfg, i < min_tokens), sampler, generator)
        tok = torch.where(done, torch.full_like(tok, padt), tok)
        is_eos = tok == eos
        gen_len += (~done & ~is_eos).to(torch.int32)
        done |= is_eos
        toks[:, i] = tok
        drawn = tok.tolist()
        yield drawn
        # a row that is not done draws neither pad nor, unless it ends, EOS
        if all(t in (eos, padt) for t in drawn):
            break
        mask = (valid & (slot[None, :] <= P + i))[:, None, None, :]
        hidden = core.forward(params, ccfg, inputs_embeds=emb[tok.long()][:, None, :],
                              positions=(P + i - offset.long())[:, None], mask=mask,
                              cache=cache, cache_start=P + i)
        cur = core.matmul_any(hidden[:, 0], head)
        steps += 1
    return SpeechGen(tokens=toks, lengths=gen_len, decode_steps=steps)


def _from_list(toks: List[int], cfg: TokenLMConfig, max_new_tokens: int, dev, steps: int) -> SpeechGen:
    """One row's drawn tokens (EOS last when drawn) as a ``SpeechGen``."""
    gen_len = sum(1 for t in toks if t != cfg.speech_eos)
    out = torch.full((1, max_new_tokens), cfg.speech_pad, dtype=torch.int32)
    out[0, : len(toks)] = torch.tensor(toks, dtype=torch.int32)
    return SpeechGen(tokens=out.to(dev), lengths=torch.tensor([gen_len], dtype=torch.int32, device=dev),
                     decode_steps=steps)


def _decode_mega(params, decode_params, cfg, ccfg, k_all, v_all, next_logits, generator, *,
                 P, off0, max_new_tokens, sampler, min_tokens) -> DecodeLoop:
    """Token 0 from the prefill logits through ``sample``; tokens 1.. from
    the decode step, which samples in its kernel: the step for token i feeds
    token i-1 at cache slot P + i - 1. The steps' seeds are drawn from
    ``generator`` at once, before token 1, as ``max_new_tokens`` values."""
    dev = k_all.device
    eos = cfg.speech_eos
    tok = sample(_mask_logits(next_logits, cfg, 0 < min_tokens), sampler, generator)
    seeds = torch.randint(0, 2 ** 31 - 1, (max_new_tokens,), generator=generator,
                          device=dev).tolist()
    toks = [int(tok[0])]
    yield toks[-1:]
    tok_prev = tok.to(torch.int32).reshape(1)
    # the kernel's buffers and plan; the plain step (a CPU cache) takes none
    scratch = decode_scratch(decode_params, ccfg.n_heads, ccfg.head_dim, dev) if dev.type == "cuda" else None
    i = 1
    while i < max_new_tokens and toks[-1] != eos:
        _, tok_prev = mega_decode_step(
            tok_prev, decode_params, k_all, v_all, P + i - 1, off0,
            i < min_tokens, seeds[i],
            n_heads=ccfg.n_heads, head_dim=ccfg.head_dim, eps=ccfg.norm_eps,
            pad_id=cfg.speech_pad, bos_id=cfg.speech_bos, eos_id=eos,
            greedy=sampler.greedy, temperature=sampler.temperature,
            top_k=sampler.top_k, scratch=scratch,
        )
        toks.append(int(tok_prev[0]))
        yield toks[-1:]
        i += 1
    return _from_list(toks, cfg, max_new_tokens, dev, steps=len(toks) - 1)


def _decode_layers(params, decode_params, cfg, ccfg, k_all, v_all, next_logits, generator, *,
                   P, off0, max_new_tokens, sampler, min_tokens) -> DecodeLoop:
    """The per-layer flavour: token i is sampled on the host from the
    previous logits (the caller's generator is the random stream), then the
    layers run it at cache slot P + i and the head gives the next logits.
    After EOS nothing more runs."""
    dev = k_all.device
    eos = cfg.speech_eos
    if len(decode_params) != ccfg.n_layers:
        raise ValueError(f"decode_params has {len(decode_params)} layers, the LM {ccfg.n_layers}")
    invf = rope_inv_freq(ccfg.head_dim, ccfg.rope_theta, device=dev)
    emb = params["speech_emb"]
    kw = dict(n_heads=ccfg.n_heads, head_dim=ccfg.head_dim, eps=ccfg.norm_eps)
    toks: List[int] = []
    cur_logits = next_logits
    lw0 = decode_params[0]
    scratch = None     # the kernels' buffers; the plain half-layers (a CPU cache) take none
    if dev.type == "cuda":
        scratch = {"qkv": torch.empty((lw0["wqkv"].shape[0],), dtype=torch.float32, device=dev),
                   "part": torch.empty(part_shape(ccfg.n_heads, ccfg.head_dim), dtype=torch.float32,
                                       device=dev),
                   "act": torch.empty((lw0["wd"].shape[1],), dtype=torch.bfloat16, device=dev)}
    for i in range(max_new_tokens):
        tok = sample(_mask_logits(cur_logits, cfg, i < min_tokens), sampler, generator)
        toks.append(int(tok[0]))
        yield toks[-1:]
        if toks[-1] == eos:
            break
        h = emb[toks[-1]].to(torch.bfloat16)[None].contiguous()
        for l, lw in enumerate(decode_params):
            attn_step(h, lw["attn_norm"], lw["wqkv"], lw["wqs"], lw["wo"], lw["wos"], invf,
                      k_all[l], v_all[l], P + i, off0, scratch=scratch, **kw)
            mlp_step(h, lw["mlp_norm"], lw["wgu"], lw["wgus"], lw["wd"], lw["wds"],
                     eps=ccfg.norm_eps, scratch=scratch)
        hf = core.rmsnorm(h, params["final_norm"], ccfg.norm_eps)
        cur_logits = core.matmul_any(hf, params["speech_head"])
    return _from_list(toks, cfg, max_new_tokens, dev, steps=sum(1 for t in toks if t != eos))


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
    decode_params: Optional[DecodeParams] = None,
    sampler: SamplerConfig = SamplerConfig(temperature=1.0, top_k=25),
    min_tokens: int = 2,
    kv_int8: bool = False,
    fused: bool = True,
    pad_multiple: int = 128,
    clock: Optional[Stopwatch] = None,
) -> SpeechGen:
    """build_prefix + pad_prefix + generate_speech."""
    pre = build_prefix(params, cfg, text, text_len, style_tokens, style_len, spk)
    pre = pad_prefix(pre, multiple=pad_multiple)
    return generate_speech(
        params, cfg, pre, generator, max_new_tokens=max_new_tokens,
        decode_params=decode_params, sampler=sampler, min_tokens=min_tokens,
        kv_int8=kv_int8, fused=fused, clock=clock,
    )


# ----------------------------------------------------------------------- speculative decode


class SpecGen(NamedTuple):
    tokens: torch.Tensor    # [1, max_new] int32 (pad after EOS)
    lengths: torch.Tensor   # [1] tokens before EOS
    n_verify: int           # verify forwards run
    n_commit: int           # tokens committed (= lengths unless EOS)


def _lookup_draft(ctx: torch.Tensor, w: int, gamma: int) -> torch.Tensor:
    """Prompt-lookup drafting (no draft model): the ``gamma`` tokens that
    followed the most recent earlier occurrence of the last bigram of
    ``ctx[:w]``, else the last token repeated. A match near the tail would
    read past the known region, so the indices clamp to the last known
    token (a constant run drafts the constant). Drafts are verified by the
    target model: a bad draft costs acceptance, never correctness."""
    W = ctx.shape[0]
    j = torch.arange(W, device=ctx.device)
    last = max(w - 1, 0)
    a2, b2 = ctx[max(w - 2, 0)], ctx[last]
    prev = torch.cat([ctx[:1], ctx[:-1]])             # prev[j] = ctx[j-1]
    match = (prev == a2) & (ctx == b2) & (j >= 1) & (j < w - 1) & (w >= 2)
    jm = torch.where(match, j, torch.full_like(j, -1)).max()
    idx = torch.clamp(jm + 1 + torch.arange(gamma, device=ctx.device), 0, last)
    return torch.where(match.any(), ctx[idx], ctx[last])


def generate_speech_spec(
    params: Params,
    cfg: TokenLMConfig,
    prefix: Prefix,
    style_tokens: torch.Tensor,     # [1, T_sty] the lookup corpus seed
    style_len: torch.Tensor,        # [1]
    generator: Optional[torch.Generator] = None,   # required unless sampler.greedy
    *,
    max_new_tokens: int,
    gamma: int = 4,
    min_tokens: int = 2,
    kv_int8: bool = False,
    sampler: SamplerConfig = SamplerConfig(greedy=True),
    clock: Optional[Stopwatch] = None,
) -> SpecGen:
    """Decode by prompt-lookup speculative verification, B=1, as the
    reference's ``generate_speech_spec`` does. The prefill (flash attention)
    runs under ``clock``'s "prefill" span, the loop under "decode". Each
    iteration drafts ``gamma`` tokens from the speech context (style prompt
    + tokens so far), runs one ``gamma + 1``-position verify forward of the
    core at ``cache_start = t_cache`` (plain PyTorch, the reference's XLA
    code) under the standard masking (pad and BOS always, EOS before
    ``min_tokens``) and commits the verified prefix plus one model-chosen
    token, up to the ``max_new_tokens`` budget; EOS stays in the token
    buffer at index ``length``, as in the standard loop.

    Greedy: a draft is accepted while it equals the model's argmax, so the
    tokens are those of greedy ``generate_speech`` but where the verify
    forward and the one-token step round a top-2 near-tie differently.
    Sampled: exact rejection sampling against the sampler's distribution p
    (a draft is a point mass: accepted with probability p(d); on the first
    rejection the token is drawn from p with the draft removed, or is the
    draft itself when that residual's mass is <= 1e-9; full acceptance
    earns the bonus token), so each token's law is the standard sampled
    path's; ``generator`` is the random stream. The loop runs on the host:
    each iteration reads the accepted count, the tokens kept and the EOS
    flag in one ``tolist``, and nothing else."""
    ccfg = core_config(cfg)
    B, P, _ = prefix.embeds.shape
    if B != 1:
        raise ValueError(f"speculative decode is the B=1 latency path (got B={B})")
    if generator is None and not sampler.greedy:
        raise ValueError("generate_speech_spec: a torch.Generator is required with a non-greedy "
                         "sampler (a fixed seed would make every 'sampled' run deterministic)")
    dev = prefix.embeds.device
    clock = clock or Stopwatch(dev)
    eos, padt = cfg.speech_eos, cfg.speech_pad
    head, emb = params["speech_head"], params["speech_emb"]
    S_max = -(-(P + max_new_tokens + gamma + 2) // 8) * 8
    Q = gamma + 1
    qj = torch.arange(Q, device=dev)

    def masked(logits: torch.Tensor, n_before: int) -> torch.Tensor:
        """[Q, V] logits under the standard rules; ``n_before`` tokens were
        committed before the window's first position."""
        late = (n_before + torch.arange(logits.shape[0], device=dev)) < min_tokens
        out = _mask_logits(logits, cfg, False)
        out[:, eos] = torch.where(late, torch.full_like(out[:, eos], NEG_INF), out[:, eos])
        return out

    def draw(ml: torch.Tensor) -> torch.Tensor:
        if sampler.greedy:
            return torch.argmax(ml, dim=-1).to(torch.int32)
        return sample(ml, sampler, generator)

    with clock.span("prefill"):
        cache = core.make_cache(ccfg, 1, S_max, dev, quantized=kv_int8)
        offset = (P - prefix.length).to(torch.int32)
        pos = torch.clamp(torch.arange(P, device=dev)[None, :] - offset[:, None], min=0)
        hidden = core.forward(params, ccfg, inputs_embeds=prefix.embeds, positions=pos,
                              offset=offset, cache=cache)
        g0 = draw(masked(core.matmul_any(hidden[:, -1], head), 0))[0]
        g0_h, w = torch.stack([g0, style_len[0].to(torch.int32)]).tolist()
    slot = torch.arange(S_max, device=dev)
    valid = slot >= offset.long()[0]
    vj = torch.arange(cfg.speech_vocab_size, device=dev)
    T_sty = style_tokens.shape[1]
    ctx = torch.zeros((T_sty + max_new_tokens + Q,), dtype=torch.int32, device=dev)
    ctx[:T_sty] = style_tokens[0]
    ctx[w] = g0
    toks = torch.full((max_new_tokens + Q,), padt, dtype=torch.int32, device=dev)
    toks[0] = g0       # EOS kept, as in the standard loop
    done = g0_h == eos
    n_gen = 0 if done else 1
    w += n_gen
    pending, t_cache, n_verify = g0.reshape(1), P, 0
    with clock.span("decode"):
        while not done and n_gen < max_new_tokens:
            d = _lookup_draft(ctx, w, gamma)
            ids = torch.cat([pending, d]).long()
            mask = (valid[None, :] & (slot[None, :] <= (t_cache + qj)[:, None]))[None, None]
            o = core.forward(params, ccfg, inputs_embeds=emb[ids][None],
                             positions=(t_cache + qj - offset[0].long())[None], mask=mask,
                             cache=cache, cache_start=t_cache)
            ml = masked(core.matmul_any(o[0], head), n_gen)
            if sampler.greedy:
                gvec = draw(ml)
                a = torch.cumprod((d == gvec[:gamma]).to(torch.int32), 0).sum()
            else:
                p = torch.softmax(transform_logits(ml, sampler), dim=-1)
                u = torch.rand((gamma,), generator=generator, device=dev)
                p_d = p[:gamma].gather(1, d.long()[:, None])[:, 0]
                a = torch.cumprod((u < p_d).to(torch.int32), 0).sum()
                d_a = d[torch.clamp(a, max=gamma - 1)]
                # p with the rejected draft removed (a == gamma keeps p: the bonus draw)
                res = torch.where((a < gamma) & (vj == d_a), torch.zeros_like(p[0]), p[a])
                safe = res.sum() > 1e-9
                pick = torch.multinomial(torch.where(safe, res, torch.ones_like(res)), 1,
                                         generator=generator)[0].to(torch.int32)
                boundary = torch.where(safe, pick, d_a)
                gvec = torch.where(qj < a, torch.cat([d, d[-1:]]), boundary)
            n_commit = torch.clamp(a + 1, max=max_new_tokens - n_gen)
            is_eos = (gvec == eos) & (qj < n_commit)
            any_eos = is_eos.any()
            n_keep = torch.where(any_eos, torch.argmax(is_eos.to(torch.int32)), n_commit)
            toks[n_gen : n_gen + Q] = torch.where(qj < n_keep + any_eos.long(), gvec,
                                                  torch.full_like(gvec, padt))
            ctx[w : w + Q] = torch.where(qj < n_keep, gvec, torch.zeros_like(gvec))
            pending = gvec[a].reshape(1)
            a_h, keep_h, eos_h = torch.stack([a, n_keep, any_eos.long()]).tolist()
            n_gen += keep_h
            w += keep_h
            done = bool(eos_h)
            t_cache += a_h + 1
            n_verify += 1
    lengths = torch.tensor([n_gen], dtype=torch.int32, device=dev)
    return SpecGen(tokens=toks[None, :max_new_tokens], lengths=lengths, n_verify=n_verify, n_commit=n_gen)


def generate_speech_spec_from_ids(
    params: Params,
    cfg: TokenLMConfig,
    text: torch.Tensor,
    text_len: torch.Tensor,
    style_tokens: torch.Tensor,
    style_len: torch.Tensor,
    spk: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    max_new_tokens: int,
    gamma: int = 4,
    min_tokens: int = 2,
    kv_int8: bool = False,
    pad_multiple: int = 128,
    sampler: SamplerConfig = SamplerConfig(greedy=True),
    clock: Optional[Stopwatch] = None,
) -> SpecGen:
    """build_prefix + pad_prefix + generate_speech_spec."""
    pre = build_prefix_padded(params, cfg, text, text_len, style_tokens, style_len, spk,
                              pad_multiple=pad_multiple)
    return generate_speech_spec(
        params, cfg, pre, style_tokens, style_len, generator, max_new_tokens=max_new_tokens,
        gamma=gamma, min_tokens=min_tokens, kv_int8=kv_int8, sampler=sampler, clock=clock,
    )


# ----------------------------------------------------------------------- continuous batching


def build_prefix_padded(
    params: Params, cfg: TokenLMConfig, text: torch.Tensor, text_len: torch.Tensor,
    style_tokens: torch.Tensor, style_len: torch.Tensor, spk: torch.Tensor, *,
    pad_multiple: int = 128,
) -> Prefix:
    """build_prefix + pad_prefix (the reference jits the two as one
    program; here they are the same eager ops)."""
    pre = build_prefix(params, cfg, text, text_len, style_tokens, style_len, spk)
    return pad_prefix(pre, multiple=pad_multiple)


def prefill_prefix(params: Params, cfg: TokenLMConfig, prefix: Prefix, *, s_max: int,
                   kv_int8: bool = False) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Prefill a batch of prefixes into a fresh ``[L, B, s_max, K, hd]``
    cache (int8 values with f32 scales under ``kv_int8``): -> (cache, next
    logits [B, V] f32, offset [B] int32). Attention is the prefill's
    ``flash_attention`` over the P new keys; slots past P stay zero. The
    admission half of continuous batching (``pipeline/continuous.py``)."""
    ccfg = core_config(cfg)
    B, P, _ = prefix.embeds.shape
    dev = prefix.embeds.device
    cache = core.make_cache(ccfg, B, s_max, dev, quantized=kv_int8)
    offset = (P - prefix.length).to(torch.int32)
    pos = torch.clamp(torch.arange(P, device=dev)[None, :] - offset[:, None], min=0)
    hidden = core.forward(params, ccfg, inputs_embeds=prefix.embeds, positions=pos,
                          offset=offset, cache=cache)
    return cache, core.matmul_any(hidden[:, -1], params["speech_head"]), offset


def _chunk_tick(cfg: TokenLMConfig, sampler: SamplerConfig, min_tokens: int, S_eff: int,
                logits: torch.Tensor, t: torch.Tensor, done: torch.Tensor, steps: torch.Tensor,
                generator: Optional[torch.Generator]):
    """One step's sampling and bookkeeping in ``decode_chunk``: pad and BOS
    masked, EOS masked for rows that drew fewer than ``min_tokens``; done
    rows draw pad; a row retires at EOS or when its next slot would pass
    ``S_eff - 2``. -> (tokens, done, steps)."""
    eos, padt = cfg.speech_eos, cfg.speech_pad
    lg = logits.clone()
    lg[:, padt] = NEG_INF
    lg[:, cfg.speech_bos] = NEG_INF
    lg[:, eos] = torch.where(steps < min_tokens, torch.full_like(lg[:, eos], NEG_INF), lg[:, eos])
    tok = sample(lg, sampler, generator)
    tok = torch.where(done, torch.full_like(tok, padt), tok)
    done = done | (tok == eos) | (t >= S_eff - 2)
    return tok, done, steps + (tok != padt).to(steps.dtype)


def _attn_2seg(q, main, app, main_valid, a_valid, rep):
    """One query a row over [main cache | this chunk's append rows] with one
    softmax across both. q [B, 1, H, hd]; ``main`` / ``app`` are (k, v) or,
    for an int8 cache, (k, k_scale, v, v_scale), in the caches' own
    [B, S, K, hd] layout; k's scale multiplies the finished dot and v's the
    probabilities. -> [B, H * hd] f32."""
    B, _, H, hd = q.shape
    K = H // rep
    qf = q.float().reshape(B, K, rep, hd) * hd ** -0.5

    def segment(kv, valid):
        k, v = kv[0], kv[len(kv) // 2]
        logits = torch.einsum("bkrd,bskd->bskr", qf, k.float())
        if len(kv) == 4:
            logits = logits * kv[1][..., None]
        return torch.where(valid, logits, torch.full_like(logits, NEG_INF)), v

    lm, vm = segment(main, main_valid[:, :, None, None])
    la, va = segment(app, a_valid[None, :, None, None])
    mx = torch.maximum(lm.amax(1), la.amax(1))[:, None]
    pm, pa = torch.exp(lm - mx), torch.exp(la - mx)
    den = torch.clamp(pm.sum(1) + pa.sum(1), min=1e-30)
    if len(main) == 4:
        pm, pa = pm * main[3][..., None], pa * app[3][..., None]
    num = torch.einsum("bskr,bskd->bkrd", pm, vm.float()) + torch.einsum("bskr,bskd->bkrd", pa, va.float())
    return (num / den[..., None]).reshape(B, H * hd)


def decode_chunk(
    params: Params, cfg: TokenLMConfig, cache: Dict[str, torch.Tensor],
    cur_logits: torch.Tensor,    # [B, V] logits for each slot's next token
    t: torch.Tensor,             # [B] cache slot each slot's next token writes
    offset: torch.Tensor,        # [B] left pad per slot
    done: torch.Tensor,          # [B] bool (idle and finished slots draw pad)
    steps: torch.Tensor,         # [B] tokens each slot has drawn
    generator: Optional[torch.Generator], *,
    n_steps: int,
    sampler: SamplerConfig = SamplerConfig(temperature=1.0, top_k=25),
    min_tokens: int = 2,
):
    """Advance every slot of a continuous batch by ``n_steps`` tokens, each
    slot at its own position, as the reference's ``decode_chunk`` does: the
    main cache is only read during the chunk; the chunk's new keys and
    values go to append buffers ``[L, B, n_steps, K, hd]`` (int8 with scales
    for an int8 cache, quantized as they are appended); attention takes one
    softmax over both segments; at the end the append rows are written into
    each slot's home slots ``[t0, t0 + n_steps)`` at once. The cache's last
    ``n_steps`` slots are the spare room that keeps this in bounds
    (``S_eff = S_tot - n_steps``). The cache is updated in place. ->
    (cache, cur_logits, t, done, steps, tokens [B, n_steps])."""
    ccfg = core_config(cfg)
    B = cur_logits.shape[0]
    L, H, K, hd = ccfg.n_layers, ccfg.n_heads, ccfg.n_kv_heads, ccfg.head_dim
    dev = cur_logits.device
    S_tot = cache["k"].shape[2]
    S_eff = S_tot - n_steps
    lp, head, emb = params["layers"], params["speech_head"], params["speech_emb"]
    dt, eps = torch.bfloat16, ccfg.norm_eps
    cos, sin = rope_table(ccfg.max_seq_len, hd, ccfg.rope_theta, device=dev)
    quant = "k_scale" in cache
    t0 = t
    slot = torch.arange(S_tot, device=dev)
    main_valid = (slot[None, :] >= offset.long()[:, None]) & (slot[None, :] < t0.long()[:, None])
    app_idx = torch.arange(n_steps, device=dev)
    app = {name: torch.zeros((L, B, n_steps) + buf.shape[3:], dtype=buf.dtype, device=dev)
           for name, buf in cache.items()}

    def lw(w, l):
        return QTensor(q=w.q[l], s=w.s[l]) if isinstance(w, QTensor) else w[l]

    segs = ("k", "k_scale", "v", "v_scale") if quant else ("k", "v")
    toks = []
    for i in range(n_steps):
        tok, done, steps = _chunk_tick(cfg, sampler, min_tokens, S_eff, cur_logits, t, done, steps, generator)
        toks.append(tok)
        h = emb[tok.long()].to(dt)
        pos = torch.clamp(t.long() - offset.long(), min=0)[:, None]
        a_valid = app_idx <= i
        for l in range(L):
            x = core.rmsnorm(h, lp["attn_norm"][l], eps)
            qkv = core.matmul_any(x, lw(lp["wqkv"], l)).to(dt)
            q, k_new, v_new = torch.split(qkv, [H * hd, K * hd, K * hd], dim=-1)
            q = apply_rope(q.reshape(B, 1, H, hd), cos, sin, pos)
            k_new = apply_rope(k_new.reshape(B, 1, K, hd), cos, sin, pos)
            v_new = v_new.reshape(B, 1, K, hd)
            for name, new in (("k", k_new), ("v", v_new)):
                if quant:
                    # quantized as the one-shot int8 cache writes them, so reads
                    # within the chunk see what the next chunk reads from the cache
                    q8, s8 = quantize_kv(new)
                    app[name][l, :, i], app[name + "_scale"][l, :, i] = q8[:, 0], s8[:, 0]
                else:
                    app[name][l, :, i] = new[:, 0].to(dt)
            attn = _attn_2seg(q, tuple(cache[n][l] for n in segs), tuple(app[n][l] for n in segs),
                              main_valid, a_valid, H // K).to(dt)
            h = h + core.matmul_any(attn, lw(lp["wo"], l)).to(dt)
            x = core.rmsnorm(h, lp["mlp_norm"][l], eps)
            g, u = core.matmul_any(x, lw(lp["w_gate_up"], l)).chunk(2, dim=-1)
            h = h + core.matmul_any((torch.nn.functional.silu(g) * u).to(dt), lw(lp["w_down"], l)).to(dt)
        cur_logits = core.matmul_any(core.rmsnorm(h, params["final_norm"], eps), head)
        t = torch.clamp(t + 1, max=S_eff - 1)
    # each slot's append rows into its home slots, one indexed write a buffer
    home = torch.clamp(t0.long(), max=S_tot - n_steps)[:, None] + app_idx[None, :]
    rows = torch.arange(B, device=dev)[:, None]
    for name, buf in cache.items():
        buf[:, rows, home] = app[name]
    return cache, cur_logits, t, done, steps, torch.stack(toks, dim=1)


# ----------------------------------------------------------------------- training


def lm_loss(
    params: Params, cfg: TokenLMConfig, prefix: Prefix,
    speech_targets: torch.Tensor,   # [B, T_s] right-padded target speech tokens
    target_len: torch.Tensor,       # [B]
    remat: bool = False,
) -> torch.Tensor:
    """Teacher-forced next-token cross-entropy on the speech continuation:
    one forward over [prefix ++ targets ++ EOS] (the prefix LEFT-padded,
    attention under the causal and left-pad mask, plain ``sdpa``), scored
    from the last prefix slot on, EOS step included."""
    ccfg = core_config(cfg)
    B, P, _ = prefix.embeds.shape
    T_s = speech_targets.shape[1]
    dev = prefix.embeds.device
    target_len = target_len.long().to(dev)
    tgt = torch.cat([speech_targets.long(),
                     torch.full((B, 1), cfg.speech_eos, dtype=torch.long, device=dev)], dim=1)
    idx = torch.arange(T_s + 1, device=dev)[None, :]
    tgt = torch.where(idx == target_len[:, None], torch.full_like(tgt, cfg.speech_eos), tgt)
    tgt = torch.where(idx > target_len[:, None], torch.full_like(tgt, cfg.speech_pad), tgt)
    emb = torch.cat([prefix.embeds, params["speech_emb"][tgt].to(prefix.embeds.dtype)], dim=1)
    T = emb.shape[1]
    offset = P - prefix.length.long().to(dev)
    pos = torch.clamp(torch.arange(T, device=dev)[None, :] - offset[:, None], min=0)
    valid = torch.arange(T, device=dev)[None, :] >= offset[:, None]
    mask = causal_mask(T, T, device=dev) & valid[:, None, None, :]
    hidden = core.forward(params, ccfg, inputs_embeds=emb, positions=pos, mask=mask, remat=remat)
    logits = core.matmul_any(hidden[:, P - 1 : P + T_s], params["speech_head"]).float()
    nll = -torch.gather(torch.log_softmax(logits, dim=-1), -1, tgt[..., None])[..., 0]
    w = (idx <= target_len[:, None]).float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
