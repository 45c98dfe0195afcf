"""B=1 decode of the speech-token LM: the CUDA kernel chains and plain twins.

Counterpart of the JAX ``ops/pallas_decode.py``: ``mega_decode_step`` (the
whole step, int8 or int4 weights), ``attn_step`` and ``mlp_step`` (its two
half-layers, int8). The kernels live in ``csrc/decode_step.cu``, one C
entry point per function, so one call here is one op. A CPU cache or
residual takes the ``*_plain`` version, which rounds at the same points as
the kernels; a CUDA one launches the kernels or raises. ``launches`` on each
wrapper counts launched ops (``mega_decode_step.launches`` the int8 steps,
``mega_decode_step.launches_int4`` the int4 steps).

Weights come from ``models/token_lm.mega_decode_params`` (output-major, one
row per output channel) and ``unstack_decode_params`` (per-layer views of
them). int4 rows hold two consecutive contraction elements a byte, both
offset-binary (value + 8), the even index in the low nibble (``pack4`` /
``unpack4``); the step tells the two widths apart by the rows' byte length.
Both versions of the step draw their Gumbel noise from the same
Philox4x32-10 stream (key = the step's seed, counter = vocab id), so a
sampled step is reproducible across them.
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
             + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_ATTN_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
                  + [ctypes.c_int, ctypes.c_void_p])
_MLP_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
MP_KEYS = ("emb", "invf", "attn_norm", "wqkv", "wqs", "wo", "wos", "mlp_norm",
           "wgu", "wgus", "wd", "wds", "final_norm", "head", "head_s")
WEIGHT_KEYS = ("wqkv", "wo", "wgu", "wd", "head")   # the streams that int4 packs


# ----------------------------------------------------------------------------- int4


def pack4(q: torch.Tensor) -> torch.Tensor:
    """Values in [-8, 7], [..., C] (C even) -> int8-typed bytes [..., C/2]:
    byte j holds element 2j in its low nibble and 2j+1 in its high nibble,
    both offset-binary (value + 8)."""
    if q.shape[-1] % 2:
        raise ValueError(f"pack4: contraction width {q.shape[-1]} must be even")
    u = (q.to(torch.int16) + 8).reshape(q.shape[:-1] + (q.shape[-1] // 2, 2))
    byte = u[..., 0] | (u[..., 1] << 4)
    return torch.where(byte > 127, byte - 256, byte).to(torch.int8)


def unpack4(b: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack4``: bytes [..., C/2] -> int8 values [..., C]."""
    u = b.to(torch.int16) & 0xFF
    q = torch.stack([(u & 15) - 8, (u >> 4) - 8], dim=-1)
    return q.reshape(b.shape[:-1] + (2 * b.shape[-1],)).to(torch.int8)


def weight_bits(mp: Dict[str, torch.Tensor]) -> int:
    """8 or 4, read from the byte length of the QKV rows against the width
    of the embedding."""
    D, row = mp["emb"].shape[1], mp["wqkv"].shape[-1]
    if row == D:
        return 8
    if 2 * row == D:
        return 4
    raise ValueError(f"decode params: wqkv rows of {row} bytes fit neither int8 nor int4 at D={D}")


def unpack_decode_params(mp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """int4 decode params with every weight stream unpacked to int8-valued
    rows (what the plain step computes with); int8 params come back as they
    are."""
    if weight_bits(mp) == 8:
        return mp
    return {k: unpack4(v) if k in WEIGHT_KEYS else v for k, v in mp.items()}


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
    """Final rmsnorm + speech-head GEMV (int8-valued rows) of a residual h
    -> f32 logits [V]."""
    xn = _rms_bf16(h.float().reshape(-1), mp["final_norm"], eps)
    return (mp["head"].float() @ xn) * mp["head_s"]


def attn_step_plain(
    h: torch.Tensor, attn_norm: torch.Tensor, wqkv: torch.Tensor, wqs: torch.Tensor,
    wo: torch.Tensor, wos: torch.Tensor, invf: torch.Tensor,
    k_cache: torch.Tensor, v_cache: torch.Tensor, t: int, off: int, *,
    n_heads: int, head_dim: int, eps: float,
) -> torch.Tensor:
    """Plain twin of the attention half-layer: h [1, D] bf16 -> new h
    [1, D] bf16; writes row t of k_cache/v_cache [S, H*hd] in place.
    Weights are int8-valued output-major rows (wqkv [3N, D], wo [D, N])."""
    H, hd = n_heads, head_dim
    N = H * hd
    hf = h.float().reshape(-1)
    ang = torch.tensor(float(max(t - off, 0)), device=h.device) * invf
    cos, sin = torch.cos(ang), torch.sin(ang)
    x = _rms_bf16(hf, attn_norm, eps)
    qkv = (wqkv.float() @ x) * wqs
    q = _rope(qkv[:N].view(H, hd), cos, sin)
    k = _rope(qkv[N:2 * N].view(H, hd), cos, sin)
    v = qkv[2 * N:].view(H, hd)
    k_cache[t] = k.reshape(N).to(k_cache.dtype)
    v_cache[t] = v.reshape(N).to(v_cache.dtype)
    kc = k_cache[off:t].float().view(-1, H, hd)
    vc = v_cache[off:t].float().view(-1, H, hd)
    scale = hd ** -0.5
    logits = torch.einsum("shd,hd->hs", kc, q) * scale
    cur = (q * k).sum(-1) * scale
    m = torch.maximum(logits.max(-1).values, cur) if logits.shape[1] else cur
    p = torch.exp(logits - m[:, None])
    pc = torch.exp(cur - m)
    denom = p.sum(-1) + pc
    num = torch.einsum("hs,shd->hd", p, vc)
    attn = ((num + pc[:, None] * v) / denom[:, None]).reshape(N).to(torch.bfloat16).float()
    return (hf + (wo.float() @ attn) * wos).to(torch.bfloat16)[None]


def mlp_step_plain(
    h: torch.Tensor, mlp_norm: torch.Tensor, wgu: torch.Tensor, wgus: torch.Tensor,
    wd: torch.Tensor, wds: torch.Tensor, *, eps: float,
) -> torch.Tensor:
    """Plain twin of the MLP half-layer: h [1, D] bf16 -> new h [1, D] bf16.
    wgu [2F, D] (gate rows then up rows) and wd [D, F] are int8-valued."""
    F = wgu.shape[0] // 2
    hf = h.float().reshape(-1)
    x = _rms_bf16(hf, mlp_norm, eps)
    gu = (wgu.float() @ x) * wgus
    g, u = gu[:F], gu[F:]
    act = (g * torch.sigmoid(g) * u).to(torch.bfloat16).float()
    return (hf + (wd.float() @ act) * wds).to(torch.bfloat16)[None]


def mega_decode_step_plain(
    tok_in: torch.Tensor, mp: Dict[str, torch.Tensor],
    k_all: torch.Tensor, v_all: torch.Tensor,
    t: int, off: int, suppress: bool, seed: int, *,
    n_heads: int, head_dim: int, eps: float, pad_id: int, bos_id: int,
    eos_id: int, greedy: bool = True, temperature: float = 1.0, top_k: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the CUDA step (same inputs, same rounding
    points): the embedding row, ``attn_step_plain`` and ``mlp_step_plain``
    per layer, the head and the sampler. int4 params are unpacked first.
    Updates k_all/v_all [L, S, H*hd] at row t in place; returns
    (h_last [1, D] bf16, next token [1] int32)."""
    mp = unpack_decode_params(mp)
    kw = dict(n_heads=n_heads, head_dim=head_dim, eps=eps)
    h = mp["emb"][int(tok_in.reshape(-1)[0])][None]
    for l in range(k_all.shape[0]):
        h = attn_step_plain(h, mp["attn_norm"][l], mp["wqkv"][l], mp["wqs"][l], mp["wo"][l],
                            mp["wos"][l], mp["invf"], k_all[l], v_all[l], t, off, **kw)
        h = mlp_step_plain(h, mp["mlp_norm"][l], mp["wgu"][l], mp["wgus"][l], mp["wd"][l],
                           mp["wds"][l], eps=eps)
    logits = head_logits_plain(h, mp, eps)
    nxt = sample_plain(
        logits, pad_id=pad_id, bos_id=bos_id, eos_id=eos_id, suppress=suppress,
        greedy=greedy, temperature=temperature, top_k=top_k, seed=seed,
    )
    return h, torch.tensor([nxt], dtype=torch.int32, device=h.device)


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


def _check_tensors(what: str, dev, want: Dict[str, Tuple[torch.Tensor, tuple, torch.dtype]]) -> None:
    """Every tensor the kernels read through a raw pointer: on ``dev``,
    contiguous, of the stated shape and type, 16-byte aligned."""
    for name, (a, shape, dtype) in want.items():
        if tuple(a.shape) != tuple(shape) or a.dtype != dtype or a.device != dev or not a.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {dtype} {tuple(shape)} on {dev}, "
                             f"got {a.dtype} {tuple(a.shape)} on {a.device}")
        if a.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def _check_widths(what: str, bits: int, **widths: int) -> None:
    """Every contraction width a warp streams in 16-byte loads."""
    mult = 16 * 8 // bits   # elements per 16-byte load
    bad = {k: v for k, v in widths.items() if v % mult}
    if bad:
        raise ValueError(f"{what}: {bad} must be multiples of {mult} at {bits} bits")


def _launch(tok_in, mp, k_all, v_all, t, off, suppress, seed, *, n_heads,
            head_dim, eps, pad_id, bos_id, eos_id, greedy, temperature, top_k,
            scratch):
    what = "mega_decode_step"
    L, S, N = k_all.shape
    H, hd = n_heads, head_dim
    D = mp["emb"].shape[1]
    V = mp["head"].shape[0]
    F = mp["wgu"].shape[1] // 2
    dev = k_all.device
    bits = weight_bits(mp)
    if N != H * hd:
        raise ValueError(f"{what}: cache width {N} != n_heads*head_dim {H * hd} (GQA is not supported)")
    _check_widths(what, bits, D=D, N=N, F=F)
    if hd % 2:
        raise ValueError(f"{what}: head_dim {hd} must be even")
    i8, f32, bf = torch.int8, torch.float32, torch.bfloat16
    shapes = {
        "emb": ((V, D), bf), "invf": ((hd // 2,), f32),
        "attn_norm": ((L, D), f32), "wqkv": ((L, 3 * N, D * bits // 8), i8),
        "wqs": ((L, 3 * N), f32), "wo": ((L, D, N * bits // 8), i8),
        "wos": ((L, D), f32), "mlp_norm": ((L, D), f32),
        "wgu": ((L, 2 * F, D * bits // 8), i8), "wgus": ((L, 2 * F), f32),
        "wd": ((L, D, F * bits // 8), i8), "wds": ((L, D), f32),
        "final_norm": ((D,), f32), "head": ((V, D * bits // 8), i8),
        "head_s": ((V,), f32),
    }
    want = {name: (mp[name], shape, dtype) for name, (shape, dtype) in shapes.items()}
    want["k_all"] = (k_all, (L, S, N), bf)
    want["v_all"] = (v_all, (L, S, N), bf)
    if scratch is None:
        scratch = decode_scratch(mp, n_heads, head_dim, dev)
    for name, (shape, dtype) in _scratch_spec(D, N, F, V).items():
        want[f"scratch {name}"] = (scratch[name], shape, dtype)
    _check_tensors(what, dev, want)
    if 2 * V > SMEM_FLOATS or S + 3 * hd > SMEM_FLOATS:
        raise ValueError(f"{what}: vocab {V} / cache {S} beyond the kernel's shared-memory cap")
    if not (0 <= off <= t < S):
        raise ValueError(f"{what}: need 0 <= off ({off}) <= t ({t}) < S ({S})")
    if not (tok_in.is_cuda and tok_in.dtype == torch.int32 and tok_in.device == dev):
        raise ValueError(f"{what}: tok_in must be an int32 tensor on the cache's device")
    h, qkv, attn, act, logits, tok_out = (scratch[k] for k in ("h", "qkv", "attn", "act", "logits", "tok"))
    ptrs = [tok_in.contiguous().data_ptr()] + [mp[k].data_ptr() for k in MP_KEYS] + [
        k_all.data_ptr(), v_all.data_ptr(), h.data_ptr(), qkv.data_ptr(),
        attn.data_ptr(), act.data_ptr(), logits.data_ptr(), tok_out.data_ptr()]
    fn = function("decode_step", "mega_decode_step", _ARGTYPES)
    rc = fn(*ptrs, L, D, H, hd, F, V, S, int(t), int(off), int(bool(suppress)),
            int(seed) & 0x7FFFFFFF, float(eps), hd ** -0.5, pad_id, bos_id, eos_id,
            int(bool(greedy)), float(temperature), int(top_k), bits,
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, what)
    if bits == 8:
        mega_decode_step.launches += 1
    else:
        mega_decode_step.launches_int4 += 1
    return h, tok_out


def mega_decode_step(
    tok_in: torch.Tensor,          # int32 [1]: previous token
    mp: Dict[str, torch.Tensor],   # token_lm.mega_decode_params(...), int8 or int4
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
mega_decode_step.launches_int4 = 0


def attn_step(
    h: torch.Tensor,           # [1, D] bf16 residual, UPDATED IN PLACE
    attn_norm: torch.Tensor,   # [D] f32
    wqkv: torch.Tensor,        # [3N, D] int8, output-major
    wqs: torch.Tensor,         # [3N] f32
    wo: torch.Tensor,          # [D, N] int8
    wos: torch.Tensor,         # [D] f32
    invf: torch.Tensor,        # [hd/2] f32 RoPE inverse frequencies
    k_cache: torch.Tensor,     # [S, N] bf16, row t written in place
    v_cache: torch.Tensor,
    t: int,                    # write slot / mask bound
    off: int,                  # first valid slot (left pad)
    *,
    n_heads: int, head_dim: int, eps: float,
    scratch: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """One decode attention half-layer (int8 weights). Unlike the JAX
    function, which returns new arrays, this one updates ``h`` and row ``t``
    of the caches in place and returns ``h``. ``scratch`` may hold the
    kernel's ``qkv`` f32 [3N] and ``attn`` bf16 [N] buffers (as
    ``decode_scratch`` makes them); they are allocated per call otherwise."""
    kw = dict(n_heads=n_heads, head_dim=head_dim, eps=eps)
    if h.device.type == "cpu":
        h.copy_(attn_step_plain(h, attn_norm, wqkv, wqs, wo, wos, invf, k_cache, v_cache, t, off, **kw))
        return h
    what = "attn_step"
    dev = h.device
    S, N = k_cache.shape
    H, hd = n_heads, head_dim
    D = h.shape[-1]
    if N != H * hd:
        raise ValueError(f"{what}: cache width {N} != n_heads*head_dim {H * hd} (GQA is not supported)")
    _check_widths(what, 8, D=D, N=N)
    if hd % 2:
        raise ValueError(f"{what}: head_dim {hd} must be even")
    f32, bf, i8 = torch.float32, torch.bfloat16, torch.int8
    qkv = scratch["qkv"] if scratch else torch.empty((3 * N,), dtype=f32, device=dev)
    attn = scratch["attn"] if scratch else torch.empty((N,), dtype=bf, device=dev)
    _check_tensors(what, dev, {
        "h": (h, (1, D), bf), "attn_norm": (attn_norm, (D,), f32),
        "wqkv": (wqkv, (3 * N, D), i8), "wqs": (wqs, (3 * N,), f32),
        "wo": (wo, (D, N), i8), "wos": (wos, (D,), f32), "invf": (invf, (hd // 2,), f32),
        "k_cache": (k_cache, (S, N), bf), "v_cache": (v_cache, (S, N), bf),
        "scratch qkv": (qkv, (3 * N,), f32), "scratch attn": (attn, (N,), bf),
    })
    if S + 3 * hd > SMEM_FLOATS:
        raise ValueError(f"{what}: cache {S} beyond the kernel's shared-memory cap")
    if not (0 <= off <= t < S):
        raise ValueError(f"{what}: need 0 <= off ({off}) <= t ({t}) < S ({S})")
    rc = function("decode_step", "attn_step", _ATTN_ARGTYPES)(
        h.data_ptr(), attn_norm.data_ptr(), wqkv.data_ptr(), wqs.data_ptr(), wo.data_ptr(),
        wos.data_ptr(), invf.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        qkv.data_ptr(), attn.data_ptr(), D, H, hd, S, int(t), int(off), float(eps),
        hd ** -0.5, 8, torch.cuda.current_stream(dev).cuda_stream)
    check(rc, what)
    attn_step.launches += 1
    return h


attn_step.launches = 0


def mlp_step(
    h: torch.Tensor,           # [1, D] bf16 residual, UPDATED IN PLACE
    mlp_norm: torch.Tensor,    # [D] f32
    wgu: torch.Tensor,         # [2F, D] int8, gate rows then up rows
    wgus: torch.Tensor,        # [2F] f32
    wd: torch.Tensor,          # [D, F] int8
    wds: torch.Tensor,         # [D] f32
    *,
    eps: float,
    scratch: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """One decode MLP half-layer (int8 weights); updates ``h`` in place and
    returns it. ``scratch`` may hold the kernel's ``act`` bf16 [F] buffer."""
    if h.device.type == "cpu":
        h.copy_(mlp_step_plain(h, mlp_norm, wgu, wgus, wd, wds, eps=eps))
        return h
    what = "mlp_step"
    dev = h.device
    D = h.shape[-1]
    F = wd.shape[-1]
    _check_widths(what, 8, D=D, F=F)
    f32, bf, i8 = torch.float32, torch.bfloat16, torch.int8
    act = scratch["act"] if scratch else torch.empty((F,), dtype=bf, device=dev)
    _check_tensors(what, dev, {
        "h": (h, (1, D), bf), "mlp_norm": (mlp_norm, (D,), f32),
        "wgu": (wgu, (2 * F, D), i8), "wgus": (wgus, (2 * F,), f32),
        "wd": (wd, (D, F), i8), "wds": (wds, (D,), f32), "scratch act": (act, (F,), bf),
    })
    rc = function("decode_step", "mlp_step", _MLP_ARGTYPES)(
        h.data_ptr(), mlp_norm.data_ptr(), wgu.data_ptr(), wgus.data_ptr(), wd.data_ptr(),
        wds.data_ptr(), act.data_ptr(), D, F, float(eps), 8,
        torch.cuda.current_stream(dev).cuda_stream)
    check(rc, what)
    mlp_step.launches += 1
    return h


mlp_step.launches = 0
