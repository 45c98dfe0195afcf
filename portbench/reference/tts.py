"""The served TTS stack as plain float32 PyTorch: token LM, CFM, iSTFT
vocoder, log-mel, speech tokenizer, speaker encoder, resampler, the int8 /
int4 weight rules and the cosine top-k of the style DB.

Every function takes the configuration as the plain dict of the
configuration file (``configs/*.json``) and weights as the nested dict the
benchmark drew (``bench/weights.py``). Nothing here reads a padded or
prepared tensor of the program: prefixes are built at their real length,
quantized weights are derived from the drawn float32 ones.

``Numerics`` says how a run rounds. ``Numerics()`` is the reference: float32
products with TF32 off, each module's weights at the precision the
configuration states (the token LM's int8, and int4 in the decode steps of
an int4 configuration). ``Numerics(control=True)`` is the control of the
correctness check: every module one step below what the configuration
states (int8 weights to int4 and int4 to int3, bfloat16 products to fp8
weights and activations, float32 to bfloat16).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30
GEN_BUCKETS = (64, 128, 256, 512)
TOKEN_BUCKETS = (32, 64, 128, 256)
PROMPT_SECONDS = (1, 2, 4, 8, 16, 30)


def bucket(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket that holds n (the last one if none does)."""
    for b in buckets:
        if max(n, 1) <= b:
            return b
    return buckets[-1]


@contextmanager
def reference_mode():
    """Float32 products with TF32 off inside the block; the flags as they
    were after it (the program under test runs with PyTorch's defaults)."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


# ----------------------------------------------------------------------------- numerics


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def int_round(w: torch.Tensor, qmax: int) -> torch.Tensor:
    """Symmetric integer rounding with one scale per output channel
    (absmax over the contraction axis -2, floored at 1e-8, divided by
    ``qmax``; round half to even), returned dequantized in float32."""
    w = w.float()
    s = torch.clamp(w.abs().amax(dim=-2, keepdim=True), min=1e-8) / float(qmax)
    return torch.clamp(torch.round(w / s), -qmax, qmax) * s


def fp8_round(w: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale per output channel (absmax / 448)."""
    w = w.float()
    s = torch.clamp(w.abs().amax(dim=-2, keepdim=True), min=1e-12) / 448.0
    return (w / s).to(torch.float8_e4m3fn).float() * s


def qdq_kv(x: torch.Tensor) -> torch.Tensor:
    """An int8 KV cache row: absmax / 127 over the head width per
    (position, head), floored at 1e-8; values rounded and clipped."""
    s = torch.clamp(x.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    return torch.clamp(torch.round(x / s), -127, 127) * s


class Numerics:
    """How a reference run rounds (module docstring)."""

    def __init__(self, control: bool = False):
        self.control = control

    # float32 modules (vocoder, featurize, search): bfloat16 in the control
    def f32(self, x: torch.Tensor) -> torch.Tensor:
        return _bf16(x) if self.control else x.float()

    # the token LM's weights at ``bits`` as stated (8 or 4)
    def lm_weight(self, w: torch.Tensor, bits: int) -> torch.Tensor:
        w8 = int_round(w, 127)
        stated = w8 if bits == 8 else int_round(w8, 7)
        if not self.control:
            return stated
        return int_round(w8, 7) if bits == 8 else int_round(stated, 3)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return _bf16(x) if self.control else x

    # the CFM: trunk stated in bfloat16 (fp8 products in the control:
    # weights and activations), the rest float32 (bfloat16 in the control)
    def cfm_weight(self, w: torch.Tensor) -> torch.Tensor:
        return fp8_round(w) if self.control else w.float()

    def cfm_act(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x.transpose(-1, -2)).transpose(-1, -2) if self.control else x


# ----------------------------------------------------------------------------- text


BOS_ID, EOS_ID, LANG_EN, BYTE_OFFSET = 1, 2, 6, 16


def encode_text(text: str) -> List[int]:
    """[BOS] [en] UTF-8 bytes + 16 [EOS] of whitespace-collapsed ASCII
    English text (the traffic's texts are such)."""
    text = " ".join(text.split())
    if not text.isascii():
        raise ValueError("the reference encodes ASCII English text only")
    return [BOS_ID, LANG_EN] + [BYTE_OFFSET + b for b in text.encode("ascii")] + [EOS_ID]


# ----------------------------------------------------------------------------- token LM


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of x [n, H, hd] at positions pos [n]."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = pos.float()[:, None] * inv[None, :]
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


class LMWeights:
    """The token LM's projections as a run computes them: ``pre`` for the
    prefill (int8 as stated), ``gen`` for the decode steps (int8, or int4
    where the configuration's ``quantize_lm_int4`` gives the B=1 step int4
    weights)."""

    def __init__(self, lm: Dict, num: Numerics, decode_bits: int):
        names = ("wqkv", "wo", "w_gate_up", "w_down")
        lp = lm["layers"]
        self.pre = {n: num.lm_weight(lp[n], 8) for n in names}
        self.pre["head"] = num.lm_weight(lm["speech_head"], 8)
        if decode_bits == 8:
            self.gen = self.pre
        else:
            self.gen = {n: num.lm_weight(lp[n], decode_bits) for n in names}
            self.gen["head"] = num.lm_weight(lm["speech_head"], decode_bits)


def lm_prefix(lm: Dict, lcfg: Dict, text_ids: Sequence[int], style: Sequence[int],
              spk: torch.Tensor) -> torch.Tensor:
    """[SPK] [text] [BOS_s] [style tokens] embeddings [P, D] at their real length."""
    dev = lm["tok_emb"].device
    V_t, V_s = lcfg["text_vocab_size"], lcfg["speech_vocab_size"]
    ids = torch.tensor(text_ids, dtype=torch.long, device=dev).clamp(max=V_t - 1)
    sty = torch.tensor(list(style), dtype=torch.long, device=dev).clamp(max=V_s - 1)
    bos = torch.tensor([V_s - 3], dtype=torch.long, device=dev)
    spk_e = spk.float().reshape(1, -1) @ lm["spk_proj"].float()
    return torch.cat([spk_e, lm["tok_emb"][ids].float(), lm["speech_emb"][bos].float(),
                      lm["speech_emb"][sty].float()], dim=0)


def lm_logits(lm: Dict, lcfg: Dict, w: LMWeights, num: Numerics, prefix: torch.Tensor,
              tokens: Sequence[int], kv_int8_gen: bool) -> torch.Tensor:
    """Teacher-forced logits [m, V] of the m served ``tokens``: row 0 from
    the prefix's last position through the prefill weights, row i from
    token i-1 through the decode weights. ``kv_int8_gen``: the decode
    steps read an int8 KV cache (the prefill attends its own keys as they
    are)."""
    dev = prefix.device
    P, m = prefix.shape[0], len(tokens)
    D, L, H = lcfg["dim"], lcfg["n_layers"], lcfg["n_heads"]
    K, hd, eps = lcfg["n_kv_heads"], lcfg["dim"] // lcfg["n_heads"], lcfg["norm_eps"]
    V_s = lcfg["speech_vocab_size"]
    fed = torch.tensor(list(tokens[:-1]), dtype=torch.long, device=dev).clamp(max=V_s - 1)
    h = torch.cat([prefix, lm["speech_emb"][fed].float()], dim=0)
    n = h.shape[0]
    pos = torch.arange(n, device=dev).clamp(max=lcfg["max_seq_len"] - 1)
    causal = torch.ones((n, n), dtype=torch.bool, device=dev).tril()
    lp = lm["layers"]
    act = num.act

    def proj(x, name, l):
        a = act(x)
        return torch.cat([a[:P] @ w.pre[name][l], a[P:] @ w.gen[name][l]], dim=0)

    for l in range(L):
        x = _rmsnorm(h, lp["attn_norm"][l].float(), eps)
        qkv = proj(x, "wqkv", l)
        q, k, v = torch.split(qkv, [H * hd, K * hd, K * hd], dim=-1)
        q = _rope(q.reshape(n, H, hd), pos, lcfg["rope_theta"])
        k = _rope(k.reshape(n, K, hd), pos, lcfg["rope_theta"])
        v = v.reshape(n, K, hd)
        k, v = (t.repeat_interleave(H // K, dim=1) for t in (k, v))

        def attend(kk, vv):
            s = torch.einsum("thd,shd->hts", q, kk) * hd ** -0.5
            s = torch.where(causal[None], s, torch.full_like(s, NEG_INF))
            return torch.einsum("hts,shd->thd", torch.softmax(s, dim=-1), vv)

        o = attend(k, v)
        if kv_int8_gen and n > P:
            o = torch.cat([o[:P], attend(qdq_kv(k), qdq_kv(v))[P:]], dim=0)
        h = h + proj(o.reshape(n, H * hd), "wo", l)
        x = _rmsnorm(h, lp["mlp_norm"][l].float(), eps)
        gate, up = proj(x, "w_gate_up", l).chunk(2, dim=-1)
        h = h + proj(F.silu(gate) * up, "w_down", l)
    hf = act(_rmsnorm(h[P - 1:], lm["final_norm"].float(), eps))
    return torch.cat([hf[:1] @ w.pre["head"], hf[1:m] @ w.gen["head"]], dim=0)


def mask_logits(logits: torch.Tensor, lcfg: Dict, min_tokens: int) -> torch.Tensor:
    """PAD and BOS never, EOS not among the first ``min_tokens`` draws."""
    V = lcfg["speech_vocab_size"]
    z = logits.clone()
    z[:, V - 1] = NEG_INF
    z[:, V - 3] = NEG_INF
    z[:min_tokens, V - 2] = NEG_INF
    return z


def topk_gap(logits: torch.Tensor, tokens: Sequence[int], k: int) -> float:
    """Widest gap by which a served token's logit lies below the k-th best
    of its row (a top-k sampler serves only its top k: 0 when all are)."""
    kth = torch.topk(logits, k, dim=-1).values[:, -1]
    got = logits.gather(1, torch.tensor(list(tokens), dtype=torch.long, device=logits.device)[:, None])[:, 0]
    return float(torch.clamp(kth - got, min=0).max())


# ----------------------------------------------------------------------------- CFM


def _ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def _sinusoid(x: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=x.device) / half)
    ang = x[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _vector_field(p: Dict, c: Dict, num: Numerics, x: torch.Tensor, t: float, cond: torch.Tensor,
                  spk: torch.Tensor, pm: torch.Tensor, pmask: torch.Tensor,
                  fmask: torch.Tensor) -> torch.Tensor:
    """One estimator call of one row: x, cond, pm [Fr, *]; masks [Fr]."""
    Fr, D, H = x.shape[0], c["dim"], c["n_heads"]
    hd = D // H
    f = num.f32
    h = f(torch.cat([x, pm, pmask[:, None]], dim=-1)) @ f(p["in_proj"])
    h = h + cond + (f(spk)[None] @ f(p["spk_proj"]))
    h = h + _sinusoid(torch.arange(Fr, device=x.device), D)
    a = num.cfm_act     # the trunk's product inputs: fp8 in the control
    tt = torch.full((1,), float(t), device=x.device)
    temb = F.silu(f(_sinusoid(tt * 1000.0, 256)) @ f(p["t_proj1"])) @ f(p["t_proj2"])
    keep = (fmask[None, :] > 0) & (fmask[:, None] > 0)
    lp = p["layers"]
    for l in range(c["n_layers"]):
        mod = f(F.silu(temb)) @ f(lp["mod"][l])
        sh1, sc1, g1, sh2, sc2, g2 = mod[0].chunk(6)
        xx = a(_ln(h) * (1 + sc1) + sh1)
        q, k, v = ((xx @ num.cfm_weight(lp[nm][l])).reshape(Fr, H, hd) for nm in ("wq", "wk", "wv"))
        s = torch.einsum("thd,shd->hts", q, k) * hd ** -0.5
        s = torch.where(keep[None], s, torch.full_like(s, NEG_INF))
        att = torch.einsum("hts,shd->thd", torch.softmax(s, -1), v).reshape(Fr, D)
        h = h + g1 * (a(att) @ num.cfm_weight(lp["wo"][l]))
        xx = a(_ln(h) * (1 + sc2) + sh2)
        up = F.gelu(xx @ num.cfm_weight(lp["w_up"][l]), approximate="tanh")
        h = h + g2 * (a(up) @ num.cfm_weight(lp["w_down"][l]))
    return f(_ln(h) * p["out_norm_scale"].float()) @ f(p["out_proj"])


def cfm_mel(p: Dict, c: Dict, num: Numerics, prompt_tokens: Sequence[int], prompt_mel: np.ndarray,
            gen_tokens: Sequence[int], spk: torch.Tensor, noise: torch.Tensor,
            fp_w: int, max_new: int) -> torch.Tensor:
    """The flow conditioning of one row at the batch's widths (``fp_w``
    prompt slots, ``max_new`` generated ones) and the Euler solve from
    ``noise`` [(fp_w + max_new) * up, M] -> mel [frames, M]."""
    dev = noise.device
    up, M = c["upsample"], c["n_mels"]
    p_len = min(len(prompt_tokens), fp_w)
    g_len = min(len(gen_tokens), max_new)
    T_all = fp_w + max_new
    n_fr = T_all * up
    toks = torch.zeros(T_all, dtype=torch.long, device=dev)
    toks[:p_len] = torch.tensor(list(prompt_tokens[:p_len]), dtype=torch.long, device=dev)
    toks[p_len:p_len + g_len] = torch.tensor(list(gen_tokens[:g_len]), dtype=torch.long, device=dev)
    cond = num.f32(p["tok_emb"][toks.clamp(max=c["token_vocab_size"] - 1)]).repeat_interleave(up, dim=0)
    fr = torch.arange(n_fr, device=dev)
    fmask = (fr < (p_len + g_len) * up).float()
    mel_len = min(prompt_mel.shape[0], p_len * up)
    pmask = (fr < mel_len).float()
    pm = torch.zeros((n_fr, M), device=dev)
    take = min(mel_len, n_fr)
    pm[:take] = torch.as_tensor(np.asarray(prompt_mel[:take]), dtype=torch.float32, device=dev)
    pm = pm * pmask[:, None]
    x = noise.float()
    n_steps = c["n_steps"]
    for i in range(n_steps):
        t = i / n_steps
        v = _vector_field(p, c, num, x, t, cond, spk, pm, pmask, fmask)
        if c["use_cfg"]:
            v0 = _vector_field(p, c, num, x, t, torch.zeros_like(cond), spk, pm, pmask, fmask)
            v = (1 + c["cfg_scale"]) * v - c["cfg_scale"] * v0
        x = x + (1.0 / n_steps) * v
    return x * (1 - pmask[:, None]) + pm * pmask[:, None]


# ----------------------------------------------------------------------------- vocoder


def conv1d(x: torch.Tensor, p: Dict, num: Numerics, stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """SAME-padded conv of x [T, C_in] with w [k, C_in, C_out] -> [ceil(T / stride), C_out]."""
    w = p["w"]
    k, T = w.shape[0], x.shape[0]
    n_out = -(-T // stride)
    total = max((n_out - 1) * stride + (k - 1) * dilation + 1 - T, 0)
    xt = F.pad(num.f32(x).T[None], (total // 2, total - total // 2))
    y = F.conv1d(xt, num.f32(w).permute(2, 1, 0), num.f32(p["b"]), stride=stride, dilation=dilation)
    return y[0].T


def layer_norm(x: torch.Tensor, p: Dict, eps: float = 1e-5) -> torch.Tensor:
    return _ln(x, eps) * p["scale"].float() + p["bias"].float()


def _hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def istft(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int, num: Numerics) -> torch.Tensor:
    """Frames [F, n_bins] -> [F * hop] samples: inverse real DFT, Hann
    synthesis window, overlap-add over the squared-window envelope, the
    first (n_fft - hop) // 2 samples dropped."""
    n_bins, Fn, dev = n_fft // 2 + 1, re.shape[0], re.device
    a = np.full(n_bins, 2.0)
    a[0] = 1.0
    a[-1] = 1.0
    ang = 2.0 * np.pi * np.outer(np.arange(n_bins), np.arange(n_fft)) / n_fft
    w = _hann(n_fft)
    cos_b = torch.tensor(a[:, None] * np.cos(ang) / n_fft * w, dtype=torch.float32, device=dev)
    sin_b = torch.tensor(-a[:, None] * np.sin(ang) / n_fft * w, dtype=torch.float32, device=dev)
    frames = num.f32(re) @ num.f32(cos_b) + num.f32(im) @ num.f32(sin_b)     # [F, n_fft]
    r = n_fft // hop
    out = torch.zeros((Fn + r - 1) * hop, device=dev)
    env = np.zeros((Fn + r - 1) * hop)
    for f in range(Fn):
        env[f * hop: f * hop + n_fft] += w * w
    for j in range(r):
        out[j * hop: j * hop + Fn * hop] += frames[:, j * hop:(j + 1) * hop].reshape(-1)
    out = out / torch.tensor(np.maximum(env, 1e-8), dtype=torch.float32, device=dev)
    start = (n_fft - hop) // 2
    return out[start: start + Fn * hop]


def vocoder_istft(p: Dict, v: Dict, num: Numerics, mel: torch.Tensor) -> torch.Tensor:
    """mel [F, n_mels] -> [F * hop] samples in [-1, 1]."""
    n_bins = v["istft_n_fft"] // 2 + 1
    h = conv1d(mel, p["pre"], num)
    for blk in p["blocks"]:
        x = layer_norm(conv1d(h, blk["conv"], num), blk["ln"])
        x = F.gelu(num.f32(x) @ num.f32(blk["pw1"]["w"]) + blk["pw1"]["b"].float(), approximate="tanh")
        h = h + (num.f32(x) @ num.f32(blk["pw2"]["w"]) + blk["pw2"]["b"].float())
    out = num.f32(h) @ num.f32(p["head"]["w"]) + p["head"]["b"].float()
    mag = torch.exp(torch.clamp(out[:, :n_bins], -12.0, 6.0))
    ph = out[:, n_bins:]
    return torch.clamp(istft(mag * torch.cos(ph), mag * torch.sin(ph), v["istft_n_fft"], v["istft_hop"], num),
                       -1.0, 1.0)


def served_wav(tree: Dict, cfg: Dict, num: Numerics, prompt_tokens, prompt_mel, spk, gen_tokens,
               noise: torch.Tensor, fp_w: int, max_new: int) -> torch.Tensor:
    """CFM, vocoder and the crop to the row's generated region."""
    c, hop = cfg["cfm"], cfg["audio"]["hop_length"]
    if cfg["vocoder"]["kind"] != "istft":
        raise ValueError("the reference serves the iSTFT vocoder")
    mel = cfm_mel(tree["cfm"], c, num, prompt_tokens, prompt_mel, gen_tokens, spk, noise, fp_w, max_new)
    wav = vocoder_istft(tree["vocoder"], cfg["vocoder"], num, mel)
    lo = min(len(prompt_tokens), fp_w) * c["upsample"] * hop
    return wav[lo: lo + min(len(gen_tokens), max_new) * c["upsample"] * hop]


# ----------------------------------------------------------------------------- featurize


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-style triangular mel filters [n_bins, n_mels], area-normed."""
    n_bins = n_fft // 2 + 1

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
                        3.0 * f / 200.0)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), 200.0 * m / 3.0)

    hz = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    freqs = np.linspace(0.0, sr / 2.0, n_bins)
    fb = np.zeros((n_bins, n_mels))
    for m in range(n_mels):
        lo, c, hi = hz[m], hz[m + 1], hz[m + 2]
        fb[:, m] = np.maximum(0.0, np.minimum((freqs - lo) / max(c - lo, 1e-10), (hi - freqs) / max(hi - c, 1e-10)))
    return fb * (2.0 / (hz[2:] - hz[:-2]))[None, :]


def log_mel(x: torch.Tensor, sr: int, n_fft: int, hop: int, win: int, n_mels: int, fmax: float,
            num: Numerics, eps: float = 1e-5) -> torch.Tensor:
    """x [T] -> [1 + T // hop, n_mels]: reflect-padded by n_fft // 2, a
    periodic Hann window centred in the n_fft frame, power, mel, log."""
    pad = n_fft // 2
    xp = F.pad(x.float()[None, None], (pad, pad), mode="reflect")[0, 0]
    frames = xp.unfold(0, win, hop)
    n_bins = n_fft // 2 + 1
    t = np.arange(win) + (n_fft - win) // 2
    ang = 2.0 * np.pi * np.outer(t, np.arange(n_bins)) / n_fft
    w = _hann(win)[:, None]
    cos_b = torch.tensor(np.cos(ang) * w, dtype=torch.float32, device=x.device)
    sin_b = torch.tensor(-np.sin(ang) * w, dtype=torch.float32, device=x.device)
    fr = num.f32(frames)
    re, im = fr @ num.f32(cos_b), fr @ num.f32(sin_b)
    fb = torch.tensor(mel_filterbank(sr, n_fft, n_mels, 0.0, fmax), dtype=torch.float32, device=x.device)
    return torch.log(torch.clamp_min(num.f32(re * re + im * im) @ num.f32(fb), eps))


def _kaiser_beta(att_db: float) -> float:
    if att_db > 50:
        return 0.1102 * (att_db - 8.7)
    if att_db >= 21:
        return 0.5842 * (att_db - 21) ** 0.4 + 0.07886 * (att_db - 21)
    return 0.0


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Rational resampling by a Kaiser-windowed sinc (60 dB, 16 zero
    crossings at the lower rate): zero-stuff by ``up``, filter, take every
    ``down``-th sample from the filter's centre. float64."""
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    cutoff = 0.5 / max(up, down)
    half = 16 * max(up, down)
    n = 2 * half + 1
    t = np.arange(n) - half
    beta = _kaiser_beta(60.0)
    win = np.i0(beta * np.sqrt(1 - (2 * np.arange(n) / (n - 1) - 1) ** 2)) / np.i0(beta)
    h = 2 * cutoff * np.sinc(2 * cutoff * t) * win
    h *= up / h.sum()
    xs = np.zeros(len(x) * up)
    xs[::up] = np.asarray(x, np.float64)
    full = np.convolve(xs, h)
    t_out = -(-len(x) * up // down)
    return full[half + np.arange(t_out) * down]


def speech_tokenizer(p: Dict, c: Dict, num: Numerics, mel: torch.Tensor,
                     fmask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """mel [T, n_mels] (100 Hz) -> (VQ scores [T_tok, codebook], token mask)."""
    m = fmask.float()
    h = mel * m[:, None]
    for sub, stride in zip(p["sub"], c["strides"]):
        h = conv1d(h, sub["conv"], num, stride=stride)
        m = m[::stride][: h.shape[0]]
        h = F.gelu(layer_norm(h, sub["ln"]), approximate="tanh") * m[:, None]
    T, D = h.shape
    H = c["n_heads"]
    hd = D // H
    keep = (m[None, :] > 0) & (m[:, None] > 0)
    f = num.f32
    for blk in p["enc"]:
        x = f(layer_norm(h, blk["ln1"]))
        q, k, v = ((x @ f(blk[nm])).reshape(T, H, hd) for nm in ("wq", "wk", "wv"))
        s = torch.einsum("thd,shd->hts", q, k) * hd ** -0.5
        s = torch.where(keep[None], s, torch.full_like(s, NEG_INF))
        att = torch.einsum("hts,shd->thd", torch.softmax(s, -1), v).reshape(T, D)
        h = h + f(att) @ f(blk["wo"])
        x = f(layer_norm(h, blk["ln2"]))
        h = h + f(F.gelu(x @ f(blk["w_up"]), approximate="tanh")) @ f(blk["w_down"])
    cb = f(p["codebook"])
    return 2.0 * (f(h) @ cb.T) - (cb * cb).sum(-1)[None, :], m > 0


def speaker_embedding(p: Dict, num: Numerics, mel: torch.Tensor, fmask: torch.Tensor) -> torch.Tensor:
    """mel [T, n_mels] -> [emb_dim], L2-normalized."""
    m = fmask.float()[:, None]
    h = conv1d(mel * m, p["stem"], num)
    h = torch.relu(layer_norm(h, p["stem_ln"])) * m
    for i, blk in enumerate(p["blocks"]):
        r = torch.relu(layer_norm(conv1d(h, blk["conv1"], num, dilation=2 ** i), blk["ln1"])) * m
        r = torch.relu(layer_norm(conv1d(r, blk["conv2"], num, dilation=2 ** i), blk["ln2"]))
        h = (h + r) * m
    scores = conv1d(torch.tanh(conv1d(h, p["att"], num)), p["att_v"], num)
    scores = torch.where(m > 0, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=0)
    mean = (w * h).sum(0)
    std = torch.sqrt(torch.clamp((w * h * h).sum(0) - mean * mean, min=1e-6))
    emb = num.f32(torch.cat([mean, std])) @ num.f32(p["head"]["w"]) + p["head"]["b"].float()
    return emb * torch.rsqrt((emb * emb).sum() + 1e-12)


def featurize(tree: Dict, cfg: Dict, num: Numerics, wav: np.ndarray, padded_len: int, device) -> Dict:
    """One 16 kHz prompt wav, zero-padded to ``padded_len`` samples as its
    batch was -> {"scores": VQ scores [n_tok, codebook], "spk", "mel24"
    [n_f24, n_mels]}; the tokens are the scores' argmax."""
    a = cfg["audio"]
    n = len(wav)
    x = np.zeros(padded_len, np.float32)
    x[:n] = wav[:padded_len]
    xt = torch.tensor(x, device=device)
    mel16 = log_mel(xt, a["prompt_sample_rate"], a["prompt_n_fft"], a["prompt_hop_length"],
                    a["prompt_win_length"], a["prompt_n_mels"], a["prompt_fmax"], num)
    fmask = torch.arange(mel16.shape[0], device=device) < n // a["prompt_hop_length"] + 1
    scores, _ = speech_tokenizer(tree["speech_tokenizer"], cfg["speech_tokenizer"], num, mel16, fmask)
    spk = speaker_embedding(tree["speaker"], num, mel16, fmask)
    x24 = torch.tensor(resample(x, a["prompt_sample_rate"], a["sample_rate"]), dtype=torch.float32,
                       device=device)
    mel24 = log_mel(num.f32(x24), a["sample_rate"], a["n_fft"], a["hop_length"], a["win_length"],
                    a["n_mels"], a["fmax"], num)
    hop_tok = a["prompt_hop_length"] * int(np.prod(cfg["speech_tokenizer"]["strides"]))
    n_tok = max(1, min(n // hop_tok, scores.shape[0]))
    n_f24 = max(1, min(int(n / a["prompt_sample_rate"] * (a["sample_rate"] // a["hop_length"])),
                       mel24.shape[0]))
    return {"scores": scores[:n_tok], "spk": spk, "mel24": mel24[:n_f24]}


def prompt_padded_len(lengths: Sequence[int], sr: int) -> int:
    """The padded length of a featurize batch: its longest wav's bucket."""
    return bucket(max(lengths), tuple(sr * s for s in PROMPT_SECONDS))


# ----------------------------------------------------------------------------- style DB


def cosine_scores(num: Numerics, queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """[Q, dim] x [N, dim] -> cosine scores [Q, N] (each side L2-normalized)."""
    def unit(x):
        x = x.float()
        return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)
    return num.f32(unit(queries)) @ num.f32(unit(rows)).T
