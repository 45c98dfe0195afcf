"""One B=1 int8 decode step of the speech-token LM: CUDA chain and plain twin.

Counterpart of the JAX ``ops/pallas_decode.py::mega_decode_step`` (int8).
The kernels live in ``csrc/decode_step.cu`` behind one C entry point, so one
call here is one op. A CPU cache takes ``mega_decode_step_plain``, which
rounds at the same points as the kernels; a CUDA cache launches the kernels
or raises. ``mega_decode_step.launches`` counts launched steps.

Weights come from ``models/token_lm.mega_decode_params`` (output-major
int8). Both versions draw their Gumbel noise from the same Philox4x32-10
stream (key = the step's seed, counter = vocab id), so a sampled step is
reproducible across them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .cuda_build import check, function

NEG_INF = -1e30
# The kernels keep per-step vectors in at most 48 KB of dynamic shared
# memory: the sampler two f32 rows of V, the attention one f32 score per
# cache slot. Beyond these sizes the wrapper raises.
SMEM_FLOATS = 48 * 1024 // 4 - 32
_ARGTYPES = ([ctypes.c_void_p] * 24 + [ctypes.c_int] * 11 + [ctypes.c_float] * 2
             + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
MP_KEYS = ("emb", "invf", "attn_norm", "wqkv", "wqs", "wo", "wos", "mlp_norm",
           "wgu", "wgus", "wd", "wds", "final_norm", "head", "head_s")


# ----------------------------------------------------------------------------- plain


def philox_bits(seed: int, n: int) -> np.ndarray:
    """First output word of Philox4x32-10 for counters 0..n-1, key (seed, 0)."""
    mask = np.uint64(0xFFFFFFFF)
    c0 = np.arange(n, dtype=np.uint64)
    c1 = np.zeros(n, np.uint64)
    c2 = np.zeros(n, np.uint64)
    c3 = np.zeros(n, np.uint64)
    k0 = np.uint64(seed & 0xFFFFFFFF)
    k1 = np.uint64(0)
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c0
        p1 = np.uint64(0xCD9E8D57) * c2
        c0, c1, c2, c3 = (p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & mask, \
            (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & mask
        k0 = (k0 + np.uint64(0x9E3779B9)) & mask
        k1 = (k1 + np.uint64(0xBB67AE85)) & mask
    return c0.astype(np.uint32)


def gumbel_uniform(seed: int, n: int) -> np.ndarray:
    """u in (0, 1]: 24 random bits scaled, plus 1e-9 (the reference's form)."""
    b24 = (philox_bits(seed, n) >> np.uint32(8)).astype(np.float32)
    return b24 * np.float32(1.0 / (1 << 24)) + np.float32(1e-9)


def sample_scores_plain(
    logits: torch.Tensor, *, pad_id: int, bos_id: int, eos_id: int,
    suppress: bool, greedy: bool, temperature: float, top_k: int, seed: int,
) -> torch.Tensor:
    """The kernel's sampler up to its final argmax: mask, temperature, top-k
    threshold with the reference's tie rule, Gumbel noise. Returns the
    scores [V] whose argmax (smallest id at the maximum) is the token."""
    V = logits.shape[0]
    fid = torch.arange(V, device=logits.device)
    bad = (fid == pad_id) | (fid == bos_id) | ((fid == eos_id) & bool(suppress))
    y = torch.where(bad, torch.full_like(logits, NEG_INF), logits.float())
    if not greedy:
        y = y / np.float32(max(temperature, 1e-6))
        if top_k and top_k > 0:
            cur = y.clone()
            for _ in range(top_k - 1):
                cur = torch.where(cur >= cur.max(), torch.full_like(cur, NEG_INF), cur)
            y = torch.where(y < cur.max(), torch.full_like(y, NEG_INF), y)
        u = torch.from_numpy(gumbel_uniform(seed, V)).to(y.device)
        y = y - torch.log(-torch.log(u))
    return y


def sample_plain(logits: torch.Tensor, **kw) -> int:
    """The kernel's sampler: ``sample_scores_plain`` and the smallest id at
    the maximum."""
    y = sample_scores_plain(logits, **kw)
    fid = torch.arange(y.shape[0], device=y.device)
    return int(fid[y >= y.max()].min())


def _rms_bf16(h: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """bf16(h * rsqrt(mean(h^2) + eps) * w), returned as f32."""
    return (h * torch.rsqrt((h * h).mean(-1, keepdim=True) + eps) * w).to(torch.bfloat16).float()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def head_logits_plain(h: torch.Tensor, mp: Dict[str, torch.Tensor], eps: float) -> torch.Tensor:
    """Final rmsnorm + int8 speech-head GEMV of a residual h -> f32 logits [V]."""
    xn = _rms_bf16(h.float().reshape(-1), mp["final_norm"], eps)
    return (mp["head"].float() @ xn) * mp["head_s"]


def mega_decode_step_plain(
    tok_in: torch.Tensor, mp: Dict[str, torch.Tensor],
    k_all: torch.Tensor, v_all: torch.Tensor,
    t: int, off: int, suppress: bool, seed: int, *,
    n_heads: int, head_dim: int, eps: float, pad_id: int, bos_id: int,
    eos_id: int, greedy: bool = True, temperature: float = 1.0, top_k: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the CUDA step (same inputs, same rounding
    points). Updates k_all/v_all [L, S, H*hd] at row t in place; returns
    (h_last [1, D] bf16, next token [1] int32)."""
    L = k_all.shape[0]
    H, hd = n_heads, head_dim
    N = H * hd
    F = mp["wgu"].shape[1] // 2
    tok = int(tok_in.reshape(-1)[0])
    h = mp["emb"][tok].float()
    ang = torch.tensor(float(max(t - off, 0)), device=h.device) * mp["invf"]
    cos, sin = torch.cos(ang), torch.sin(ang)
    scale = hd ** -0.5
    for l in range(L):
        x = _rms_bf16(h, mp["attn_norm"][l], eps)
        qkv = (mp["wqkv"][l].float() @ x) * mp["wqs"][l]
        q = _rope(qkv[:N].view(H, hd), cos, sin)
        k = _rope(qkv[N:2 * N].view(H, hd), cos, sin)
        v = qkv[2 * N:].view(H, hd)
        k_all[l, t] = k.reshape(N).to(k_all.dtype)
        v_all[l, t] = v.reshape(N).to(v_all.dtype)
        kc = k_all[l, off:t].float().view(-1, H, hd)
        vc = v_all[l, off:t].float().view(-1, H, hd)
        logits = torch.einsum("shd,hd->hs", kc, q) * scale
        cur = (q * k).sum(-1) * scale
        m = torch.maximum(logits.max(-1).values, cur) if logits.shape[1] else cur
        p = torch.exp(logits - m[:, None])
        pc = torch.exp(cur - m)
        denom = p.sum(-1) + pc
        num = torch.einsum("hs,shd->hd", p, vc)
        attn = ((num + pc[:, None] * v) / denom[:, None]).reshape(N).to(torch.bfloat16).float()
        h = (h + (mp["wo"][l].float() @ attn) * mp["wos"][l]).to(torch.bfloat16).float()
        x = _rms_bf16(h, mp["mlp_norm"][l], eps)
        gu = (mp["wgu"][l].float() @ x) * mp["wgus"][l]
        g, u = gu[:F], gu[F:]
        act = (g * torch.sigmoid(g) * u).to(torch.bfloat16).float()
        h = (h + (mp["wd"][l].float() @ act) * mp["wds"][l]).to(torch.bfloat16).float()
    logits = head_logits_plain(h, mp, eps)
    nxt = sample_plain(
        logits, pad_id=pad_id, bos_id=bos_id, eos_id=eos_id, suppress=suppress,
        greedy=greedy, temperature=temperature, top_k=top_k, seed=seed,
    )
    return h.to(torch.bfloat16)[None], torch.tensor([nxt], dtype=torch.int32, device=h.device)


# ----------------------------------------------------------------------------- kernel


def _scratch_spec(D: int, N: int, F: int, V: int):
    return {
        "h": ((1, D), torch.bfloat16), "qkv": ((3 * N,), torch.float32),
        "attn": ((N,), torch.bfloat16), "act": ((F,), torch.bfloat16),
        "logits": ((V,), torch.float32), "tok": ((1,), torch.int32),
    }


def decode_scratch(mp: Dict[str, torch.Tensor], n_heads: int, head_dim: int,
                   device) -> Dict[str, torch.Tensor]:
    """The kernel chain's per-step buffers, to allocate once per request and
    pass to every step: h [1, D] bf16, qkv f32, attn and act bf16, logits
    f32, tok [1] int32."""
    spec = _scratch_spec(mp["emb"].shape[1], n_heads * head_dim,
                         mp["wgu"].shape[1] // 2, mp["head"].shape[0])
    return {k: torch.empty(shape, dtype=dt, device=device) for k, (shape, dt) in spec.items()}


def _launch(tok_in, mp, k_all, v_all, t, off, suppress, seed, *, n_heads,
            head_dim, eps, pad_id, bos_id, eos_id, greedy, temperature, top_k,
            scratch):
    L, S, N = k_all.shape
    H, hd = n_heads, head_dim
    D = mp["emb"].shape[1]
    V = mp["head"].shape[0]
    F = mp["wgu"].shape[1] // 2
    dev = k_all.device
    if N != H * hd:
        raise ValueError(f"mega_decode_step: cache width {N} != n_heads*head_dim {H * hd} (GQA is not supported)")
    for name, tns in (("k_all", k_all), ("v_all", v_all)):
        if not tns.is_cuda or tns.dtype != torch.bfloat16 or not tns.is_contiguous() or tns.shape != k_all.shape:
            raise ValueError(f"mega_decode_step: {name} must be a contiguous bf16 CUDA tensor [L, S, N]")
    want = {
        "emb": ((V, D), torch.bfloat16), "invf": ((hd // 2,), torch.float32),
        "attn_norm": ((L, D), torch.float32), "wqkv": ((L, 3 * N, D), torch.int8),
        "wqs": ((L, 3 * N), torch.float32), "wo": ((L, D, N), torch.int8),
        "wos": ((L, D), torch.float32), "mlp_norm": ((L, D), torch.float32),
        "wgu": ((L, 2 * F, D), torch.int8), "wgus": ((L, 2 * F), torch.float32),
        "wd": ((L, D, F), torch.int8), "wds": ((L, D), torch.float32),
        "final_norm": ((D,), torch.float32), "head": ((V, D), torch.int8),
        "head_s": ((V,), torch.float32),
    }
    for name, (shape, dtype) in want.items():
        a = mp[name]
        if tuple(a.shape) != shape or a.dtype != dtype or a.device != dev or not a.is_contiguous():
            raise ValueError(f"mega_decode_step: {name} must be contiguous {dtype} {shape} on {dev}, "
                             f"got {a.dtype} {tuple(a.shape)} on {a.device}")
        if a.data_ptr() % 16:
            raise ValueError(f"mega_decode_step: {name} must be 16-byte aligned")
    if D % 16 or N % 16 or F % 16 or hd % 2:
        raise ValueError("mega_decode_step: D, H*hd and F must be multiples of 16")
    if 2 * V > SMEM_FLOATS or S + 3 * hd > SMEM_FLOATS:
        raise ValueError(f"mega_decode_step: vocab {V} / cache {S} beyond the kernel's shared-memory cap")
    if not (0 <= off <= t < S):
        raise ValueError(f"mega_decode_step: need 0 <= off ({off}) <= t ({t}) < S ({S})")
    if not (tok_in.is_cuda and tok_in.dtype == torch.int32 and tok_in.device == dev):
        raise ValueError("mega_decode_step: tok_in must be an int32 tensor on the cache's device")
    if scratch is None:
        scratch = decode_scratch(mp, n_heads, head_dim, dev)
    for name, (shape, dtype) in _scratch_spec(D, N, F, V).items():
        a = scratch[name]
        if tuple(a.shape) != shape or a.dtype != dtype or a.device != dev or not a.is_contiguous():
            raise ValueError(f"mega_decode_step: scratch {name} must be contiguous {dtype} {shape} on {dev}")
    h, qkv, attn, act, logits, tok_out = (scratch[k] for k in ("h", "qkv", "attn", "act", "logits", "tok"))
    ptrs = [tok_in.contiguous().data_ptr()] + [mp[k].data_ptr() for k in MP_KEYS] + [
        k_all.data_ptr(), v_all.data_ptr(), h.data_ptr(), qkv.data_ptr(),
        attn.data_ptr(), act.data_ptr(), logits.data_ptr(), tok_out.data_ptr()]
    fn = function("decode_step", "mega_decode_step", _ARGTYPES)
    rc = fn(*ptrs, L, D, H, hd, F, V, S, int(t), int(off), int(bool(suppress)),
            int(seed) & 0x7FFFFFFF, float(eps), hd ** -0.5, pad_id, bos_id, eos_id,
            int(bool(greedy)), float(temperature), int(top_k),
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "mega_decode_step")
    mega_decode_step.launches += 1
    return h, tok_out


def mega_decode_step(
    tok_in: torch.Tensor,          # int32 [1]: previous token
    mp: Dict[str, torch.Tensor],   # token_lm.mega_decode_params(...)
    k_all: torch.Tensor,           # [L, S, H*hd] bf16, updated in place at row t
    v_all: torch.Tensor,
    t: int,                        # cache slot of tok_in
    off: int,                      # first valid slot (left pad)
    suppress: bool,                # mask EOS (min_tokens not reached)
    seed: int,                     # Philox key of this step's Gumbel noise
    *,
    n_heads: int, head_dim: int, eps: float, pad_id: int, bos_id: int,
    eos_id: int, greedy: bool = True, temperature: float = 1.0, top_k: int = 0,
    scratch: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole decode step; returns (h_last [1, D] bf16, next token [1] int32).
    On the card both are ``scratch`` buffers (``decode_scratch``; allocated
    per call when it is None), so the next step on the same scratch
    overwrites them. The next step may take the returned token as its
    ``tok_in``. A CPU step ignores ``scratch``."""
    kw = dict(n_heads=n_heads, head_dim=head_dim, eps=eps, pad_id=pad_id,
              bos_id=bos_id, eos_id=eos_id, greedy=greedy,
              temperature=temperature, top_k=top_k)
    if k_all.device.type == "cpu":
        return mega_decode_step_plain(tok_in, mp, k_all, v_all, t, off, suppress, seed, **kw)
    return _launch(tok_in, mp, k_all, v_all, t, off, suppress, seed, scratch=scratch, **kw)


mega_decode_step.launches = 0
