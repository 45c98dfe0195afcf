"""B=1 decode of the speech-token LM: the CUDA kernels and their plain twins.

Counterpart of the JAX ``ops/pallas_decode.py``: ``mega_decode_step`` (the
whole step), ``attn_step`` and ``mlp_step`` (its two half-layers), each at
int8 or int4 weights. The kernels live in ``csrc/decode_step.cu``, one C
entry point per function, each one persistent cooperative launch, so one
call here is one op. A CPU cache or residual takes the ``*_plain`` version,
which rounds at the same points as the kernels; a CUDA one launches the
kernels or raises. ``launches`` on each wrapper counts launched ops
(``mega_decode_step.launches`` the int8 steps,
``mega_decode_step.launches_int4`` the int4 steps; a planned half-layer
counts on ``attn_step`` / ``mlp_step``).

``attn_step`` and ``mlp_step`` check every tensor on every call, for
one-off callers. A decode loop plans its layers once instead
(``plan_half_layers``): the checked pointers and constants of every
layer's two half-layers over one residual, one cache and one scratch
(``half_layer_scratch``), so that a call (``attn_step_planned``,
``mlp_step_planned``, ``layers_planned`` for a whole token) is one ctypes
call with ``t`` and ``off``.

The kernels split the attention over the live cache slots into partials per
(head, split) and merge them in the ``wo`` projection's prologue; the int4
dots run on the tensor cores, tile by tile, in their own order of f32 sums;
the step's sampler keeps each head unit's distinct levels and merges them
in the last block. ``attn_vector_split_plain``, ``matvec4_plain`` and
``sample_merged_plain`` (``topk_threshold_merged``) are that arithmetic in
plain PyTorch, held against ``attn_vector_plain``, the plain product and
``sample_plain`` (``topk_threshold_plain``) by the CPU tests.

Weights come from ``models/token_lm.mega_decode_params`` (output-major, one
row per output channel) and ``unstack_decode_params`` (per-layer views of
them). int4 bytes hold two offset-binary values (value + 8) in the order of
the kernel's mma fragments (``pack4`` / ``unpack4``); the kernels tell the
two widths apart by the rows' byte length. Both versions of the step draw
their Gumbel noise from the same Philox4x32-10 stream (key = the step's
seed, counter = vocab id), so a sampled step is reproducible across them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .cuda_build import check, forward_only, function

NEG_INF = -1e30
# A GEMV block keeps its input vector (and, where it normalises the
# residual, the norm weights) in at most 48 KB of dynamic shared memory; the
# step's sampler keeps a list for each head unit of 32 logits (SAMPLE_ROWS;
# int4: at most V / 32 + 2 of them) and merges at most 288 lists in one
# warp: the vocabulary is at most 8192, whatever the card's SM count.
# Beyond these sizes the wrapper raises.
SMEM_FLOATS = 48 * 1024 // 4 - 32
SAMPLE_ROWS = 32
MAX_VOCAB = 8192
TILE_ROWS, TILE_K = 16, 64   # an int4 row-group and its tiles of contraction elements
HEAD_DIMS = (8, 16, 32, 64, 128, 256)   # hd / 8 lanes span one cache row
# The split rule of the plain split attention (``attn_splits``): the one the
# kernels were written with. The buffers the kernels get are sized from the
# built library (``part_shape``), not from these.
SPLIT_KEYS = 24     # slots per split ...
MAX_SPLITS = 16     # ... until this many splits; then the splits grow
_STEP_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ATTN_HALF_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_MLP_HALF_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p]
MP_KEYS = ("emb", "invf", "attn_norm", "wqkv", "wqs", "wo", "wos", "mlp_norm",
           "wgu", "wgus", "wd", "wds", "final_norm", "head", "head_s")
WEIGHT_KEYS = ("wqkv", "wo", "wgu", "wd", "head")   # the streams that int4 packs
ATTN_KEYS = ("attn_norm", "wqkv", "wqs", "wo", "wos")   # a layer's weights, in the half-layers' order
MLP_KEYS = ("mlp_norm", "wgu", "wgus", "wd", "wds")
HALF_STAMP_SLOTS = 4   # a half-layer call's waits (at most 3) and its end


# ----------------------------------------------------------------------------- int4


def _tiled_rows(shape) -> int:
    """Rows of a [..., R, C] matrix that ``pack4`` lays out in fragment
    order: the complete row-groups of 16, where C is a multiple of 32."""
    if len(shape) < 2 or shape[-1] % (TILE_K // 2):
        return 0
    return shape[-2] // TILE_ROWS * TILE_ROWS


def _frag_order(u: torch.Tensor, steps: int) -> torch.Tensor:
    """Offset-binary values [..., rt, W] of complete row-groups, W a multiple
    of 16 ``steps`` -> their bytes [..., rt / 16, 8 W] in fragment order,
    tiles of ``steps`` k-steps of 16 elements (4: a tile, 2: a half tile)."""
    lead, (rt, W) = u.shape[:-2], u.shape[-2:]
    n = len(lead)
    # rows (j, a, g), elements (kt, s, b, q, e) -> bytes (j, kt, g, q, s, e, b), nibbles a
    t = u.reshape(*lead, rt // 16, 2, 8, W // (16 * steps), steps, 2, 4, 2)
    t = t.permute(*range(n), n, n + 3, n + 2, n + 6, n + 4, n + 7, n + 5, n + 1)
    return (t[..., 0] | (t[..., 1] << 4)).reshape(*lead, rt // 16, 8 * W)


def _plain_order(b: torch.Tensor, steps: int) -> torch.Tensor:
    """Inverse of ``_frag_order``: bytes [..., rt / 16, 8 W] -> offset-binary
    values [..., rt, W]."""
    lead, (nrg, nb) = b.shape[:-2], b.shape[-2:]
    n, W = len(lead), nb // 8
    t = b.reshape(*lead, nrg, W // (16 * steps), 8, 4, steps, 2, 2)
    t = torch.stack([t & 15, t >> 4], dim=-1)       # (j, kt, g, q, s, e, b, a)
    t = t.permute(*range(n), n, n + 7, n + 2, n + 1, n + 4, n + 6, n + 3, n + 5)
    return t.reshape(*lead, nrg * 16, W)


def pack4(q: torch.Tensor) -> torch.Tensor:
    """Values in [-8, 7], [..., R, C] (C even) -> int8-typed bytes
    [..., R, C/2], every value offset-binary (value + 8).

    The plain byte order: byte j of a row holds element 2j in its low
    nibble and 2j+1 in its high nibble. The kernel's order, for the rows of
    complete row-groups of 16 where C is a multiple of 32 (the rest keep
    the plain order): a row-group's 8 C bytes are tiles of 64 contraction
    elements, 512 bytes each, in which lane L = 4 g + q of a warp holds 16
    bytes, four words, word s the lane's A fragment of ``mma.m16n8k16`` for
    k-step s: nibble t (bits 4t) of the word is row g + 8 (t & 1) of the
    group, element 64 kt + 16 s + 8 ((t >> 1) & 1) + 2 q + (t >> 2). Where C
    is 32 mod 64 a half tile ends the row-group: 256 bytes, lane L's 8
    bytes its words for k-steps 0 and 1."""
    if q.shape[-1] % 2:
        raise ValueError(f"pack4: contraction width {q.shape[-1]} must be even")
    u = q.to(torch.int16) + 8
    byte = u[..., 0::2] | (u[..., 1::2] << 4)
    rt = _tiled_rows(q.shape)
    if rt:
        C, full = q.shape[-1], q.shape[-1] // TILE_K * TILE_K
        parts = [_frag_order(u[..., :rt, :full], 4)] if full else []
        if full < C:
            parts.append(_frag_order(u[..., :rt, full:], 2))
        byte = byte.clone()
        byte[..., :rt, :] = torch.cat(parts, dim=-1).reshape(*q.shape[:-2], rt, C // 2)
    return torch.where(byte > 127, byte - 256, byte).to(torch.int8)


def unpack4(b: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack4``: bytes [..., R, C/2] -> int8 values [..., R, C]."""
    u = b.to(torch.int16) & 0xFF
    C = 2 * b.shape[-1]
    q = torch.stack([u & 15, u >> 4], dim=-1).reshape(b.shape[:-1] + (C,))
    rt = _tiled_rows(q.shape)
    if rt:
        full = C // TILE_K * TILE_K
        rg = u[..., :rt, :].reshape(*b.shape[:-2], rt // 16, 8 * C)
        parts = [_plain_order(rg[..., :8 * full], 4)] if full else []
        if full < C:
            parts.append(_plain_order(rg[..., 8 * full:], 2))
        q = q.clone()
        q[..., :rt, :] = torch.cat(parts, dim=-1)
    return (q - 8).to(torch.int8)


def _row_bits(what: str, name: str, w: torch.Tensor, C: int) -> int:
    """8 or 4: the width of weight rows whose contraction width is C, read
    from their byte length."""
    if w.shape[-1] == C:
        return 8
    if 2 * w.shape[-1] == C:
        return 4
    raise ValueError(f"{what}: {name} rows of {w.shape[-1]} bytes fit neither int8 nor int4 at width {C}")


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


def topk_threshold_plain(y: torch.Tensor, top_k: int) -> torch.Tensor:
    """The reference's top-k threshold: strip every value tied at the running
    max (to -1e30) k-1 times; the max of the rest is the k-th value."""
    cur = y.clone()
    for _ in range(top_k - 1):
        cur = torch.where(cur >= cur.max(), torch.full_like(cur, NEG_INF), cur)
    return cur.max()


def _block_levels(vals, top_k: int):
    """One block's list, as the kernel's ``sample_local`` writes it: its
    distinct values in descending order, at most ``top_k`` of them."""
    return sorted(set(vals), reverse=True)[:top_k]


def _merged_kth(lists, top_k: int) -> float:
    """The kernel's ``sample_merge``: level by level (the kernel takes two
    a round), the largest head of all lists is the next distinct level and
    every list at it advances; the k-th level (-inf where fewer than k
    exist)."""
    pos = [0] * len(lists)
    level = -float("inf")
    for _ in range(top_k):
        heads = [lv[p] if p < len(lv) else -float("inf") for lv, p in zip(lists, pos)]
        level = max(heads, default=-float("inf"))
        if level == -float("inf"):
            break
        pos = [p + (h == level) for p, h in zip(pos, heads)]
    return level


def _merged_threshold(lists, top_k: int) -> float:
    """The k-th level of the lists, raised to -1e30 (what stripped entries
    hold in the reference) when k >= 2."""
    thr = _merged_kth(lists, top_k)
    return max(thr, NEG_INF) if top_k >= 2 else thr


def topk_threshold_merged(y: torch.Tensor, top_k: int, rows: int = SAMPLE_ROWS) -> torch.Tensor:
    """The same threshold the way the kernel's sampler finds it: blocks of
    ``rows`` consecutive entries each keep their k largest distinct values,
    the lists are merged into the k-th largest distinct value of all, and
    that is raised to -1e30 (what stripped entries hold in the reference)
    when k >= 2."""
    vals = y.tolist()
    lists = [_block_levels(vals[i:i + rows], top_k) for i in range(0, len(vals), rows)]
    return torch.tensor(_merged_threshold(lists, top_k), dtype=y.dtype, device=y.device)


def sample_scores_plain(
    logits: torch.Tensor, *, pad_id: int, bos_id: int, eos_id: int,
    suppress: bool, greedy: bool, temperature: float, top_k: int, seed: int,
    threshold=topk_threshold_plain,
) -> torch.Tensor:
    """The kernel's sampler up to its final argmax: mask, temperature, top-k
    threshold with the reference's tie rule (``threshold``: the reference's
    loop or the kernel's tiled search), Gumbel noise. Returns the scores [V]
    whose argmax (smallest id at the maximum) is the token."""
    V = logits.shape[0]
    fid = torch.arange(V, device=logits.device)
    bad = (fid == pad_id) | (fid == bos_id) | ((fid == eos_id) & bool(suppress))
    y = torch.where(bad, torch.full_like(logits, NEG_INF), logits.float())
    if not greedy:
        y = y / np.float32(max(temperature, 1e-6))
        if top_k and top_k > 0:
            y = torch.where(y < threshold(y, top_k), torch.full_like(y, NEG_INF), y)
        u = torch.from_numpy(gumbel_uniform(seed, V)).to(y.device)
        y = y - torch.log(-torch.log(u))
    return y


def sample_plain(logits: torch.Tensor, **kw) -> int:
    """The kernel's sampler: ``sample_scores_plain`` and the smallest id at
    the maximum."""
    y = sample_scores_plain(logits, **kw)
    fid = torch.arange(y.shape[0], device=y.device)
    return int(fid[y >= y.max()].min())


def sample_merged_plain(
    logits: torch.Tensor, *, pad_id: int, bos_id: int, eos_id: int, suppress: bool,
    greedy: bool, temperature: float, top_k: int, seed: int, rows: int = SAMPLE_ROWS,
) -> int:
    """The step kernel's sampler as it runs: blocks of ``rows`` logits each
    send a record, the last block merges them. A block's record: the best
    (score, id) of all its entries and, with a top-k threshold, per
    distinct level (at most k, descending) the best (score, id) at or above
    it and the smallest id below it; the merge finds the k-th distinct
    level of all blocks, thresholds it as the reference does, and takes
    from each block the record of its last level at or above the
    threshold: survivors keep their score, the rest count as -1e30.
    Returns the token: the largest score, the smallest id among ties."""
    V = logits.shape[0]
    fid = torch.arange(V)
    bad = (fid == pad_id) | (fid == bos_id) | ((fid == eos_id) & bool(suppress))
    y = torch.where(bad, torch.full((V,), NEG_INF), logits.detach().float().cpu())
    if not greedy:
        y = y / np.float32(max(temperature, 1e-6))
        u = torch.from_numpy(gumbel_uniform(seed, V))
        noisy = torch.where(y > 0.5 * NEG_INF, y - torch.log(-torch.log(u)), y)
    score = (y if greedy else noisy).tolist()
    y = y.tolist()
    best = lambda pairs: min(pairs, key=lambda p: (-p[0], p[1]))   # largest score, then smallest id
    blocks = [range(i, min(V, i + rows)) for i in range(0, V, rows)]
    if greedy or top_k <= 0:
        return best([best([(score[i], i) for i in b]) for b in blocks])[1]
    lists = [_block_levels([y[i] for i in b], top_k) for b in blocks]
    thr = _merged_threshold(lists, top_k)
    cands = []
    for b, levels in zip(blocks, lists):
        kept = [lv for lv in levels if lv >= thr]
        if kept:   # the block's record at its last level at or above the threshold
            cands.append(best([(score[i], i) for i in b if y[i] >= kept[-1]]))
            below = [i for i in b if y[i] < kept[-1]]
        else:
            below = list(b)
        if below:
            cands.append((NEG_INF, min(below)))
    return best(cands)[1]


def _rms_bf16(h: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """bf16(h * rsqrt(mean(h^2) + eps) * w), returned as f32."""
    return (h * torch.rsqrt((h * h).mean(-1, keepdim=True) + eps) * w).to(torch.bfloat16).float()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def matvec_plain(w: torch.Tensor, x: torch.Tensor, slices: int = 8) -> torch.Tensor:
    """The plain steps' product: int8-valued rows [R, C] . f32 x [C]."""
    return w.float() @ x


def matvec4_plain(w: torch.Tensor, x: torch.Tensor, slices: int = 8) -> torch.Tensor:
    """The int4 kernel's product on int8-valued rows [R, C] (values in
    [-8, 7]) and a bf16-valued x, in the kernel's order of f32 sums: a
    row-group of 16 rows in tiles of 64 elements, four k-steps of 16 a tile;
    one k-step is one mma (its 16 products are exact; their sum is taken
    here in f64 and rounded once); ``slices`` warps take tiles kt = w, w +
    slices, ... and add the even k-steps into one accumulator and the odd
    ones into another, in tile order; a row's sum is the two accumulators'
    sum, then the warps' in warp order. Rows past the last complete group
    of 16 are the tail the kernel sums in f32 chunk by chunk (here: the
    plain product)."""
    R, C = w.shape
    rt = _tiled_rows(w.shape)
    out = w.float() @ x
    if rt == 0:
        return out
    steps = (w[:rt].double() * x.double()).reshape(rt, C // 16, 16).sum(-1).float()
    total = None
    for ks in range(slices):
        acc = [torch.zeros(rt, dtype=torch.float32, device=w.device) for _ in range(2)]
        for kt in range(ks, -(-C // TILE_K), slices):
            for st in range(min(4, C // 16 - 4 * kt)):   # a half tile at the end: two k-steps
                acc[st % 2] = acc[st % 2] + steps[:, 4 * kt + st]
        part = acc[0] + acc[1]
        total = part if total is None else total + part
    out[:rt] = total
    return out


def head_logits_plain(h: torch.Tensor, mp: Dict[str, torch.Tensor], eps: float,
                      matvec=matvec_plain) -> torch.Tensor:
    """Final rmsnorm + speech-head GEMV (int8-valued rows) of a residual h
    -> f32 logits [V] (``matvec``: as ``attn_step_plain``'s; the int4 head
    splits a row-group's tiles over four warps)."""
    xn = _rms_bf16(h.float().reshape(-1), mp["final_norm"], eps)
    return matvec(mp["head"], xn, 4) * mp["head_s"]


def attn_splits(n: int, cap: int = MAX_SPLITS) -> int:
    """Splits the kernels cut n live slots into: at most MAX_SPLITS, and in
    the kernels (the step, the attention half-layer) at most their blocks per
    head (SMs // heads, the ``cap``), so that a block has one (head, split)
    at most."""
    return min(MAX_SPLITS, max(1, cap), max(1, -(-n // SPLIT_KEYS)))


def split_bounds(n: int) -> List[Tuple[int, int]]:
    """The kernels' partition of slots 0..n-1 (relative to ``off``): equal
    splits of ceil(n / splits) slots, the last one ragged."""
    ns = attn_splits(n)
    per = -(-n // ns)
    return [(min(n, s * per), min(n, (s + 1) * per)) for s in range(ns)]


def attn_vector_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kc: torch.Tensor, vc: torch.Tensor) -> torch.Tensor:
    """Attention of one token (q, k, v f32 [H, hd], unrounded) over the live
    cache rows kc/vc f32 [n, H, hd] and itself -> f32 [H, hd], before the
    bf16 rounding."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("shd,hd->hs", kc, q) * scale
    cur = (q * k).sum(-1) * scale
    m = torch.maximum(logits.max(-1).values, cur) if logits.shape[1] else cur
    p = torch.exp(logits - m[:, None])
    pc = torch.exp(cur - m)
    denom = p.sum(-1) + pc
    num = torch.einsum("hs,shd->hd", p, vc)
    return (num + pc[:, None] * v) / denom[:, None]


def attn_vector_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            kc: torch.Tensor, vc: torch.Tensor,
                            bounds: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The same vector the way the kernels compute it: one unnormalised
    partial (acc [H, hd], running max m, sum l) per split ``(j0, j1)`` of
    the live rows, the current token folded into the first split from its
    f32 k/v, and the merge of the ``wo`` prologue: M = max m_s,
    sum(acc_s e^(m_s - M)) / sum(l_s e^(m_s - M)). ``bounds`` may be any
    partition of [0, n); empty splits are allowed."""
    scale = q.shape[-1] ** -0.5
    H = q.shape[0]
    accs, ms, ls = [], [], []
    for i, (j0, j1) in enumerate(bounds or [(0, 0)]):
        s = torch.einsum("shd,hd->hs", kc[j0:j1], q) * scale
        m = s.max(-1).values if j1 > j0 else torch.full((H,), NEG_INF, dtype=q.dtype, device=q.device)
        p = torch.exp(s - m[:, None])
        l, acc = p.sum(-1), torch.einsum("hs,shd->hd", p, vc[j0:j1])
        if i == 0:
            cur = (q * k).sum(-1) * scale
            m2 = torch.maximum(m, cur)
            wa, pc = torch.exp(m - m2), torch.exp(cur - m2)
            m, l, acc = m2, l * wa + pc, acc * wa[:, None] + pc[:, None] * v
        accs.append(acc), ms.append(m), ls.append(l)
    m_all, l_all, acc_all = torch.stack(ms, 1), torch.stack(ls, 1), torch.stack(accs, 1)
    w = torch.exp(m_all - m_all.max(1, keepdim=True).values)
    return (acc_all * w[..., None]).sum(1) / (l_all * w).sum(1)[:, None]


def attn_step_plain(
    h: torch.Tensor, attn_norm: torch.Tensor, wqkv: torch.Tensor, wqs: torch.Tensor,
    wo: torch.Tensor, wos: torch.Tensor, invf: torch.Tensor,
    k_cache: torch.Tensor, v_cache: torch.Tensor, t: int, off: int, *,
    n_heads: int, head_dim: int, eps: float,
    bounds: Optional[Sequence[Tuple[int, int]]] = None, matvec=matvec_plain,
) -> torch.Tensor:
    """Plain twin of the attention half-layer: h [1, D] bf16 -> new h
    [1, D] bf16; writes row t of k_cache/v_cache [S, H*hd] in place.
    Weights are int8-valued output-major rows (wqkv [3N, D], wo [D, N]).
    With ``bounds`` the attention is computed split by split
    (``attn_vector_split_plain``), else in one piece; ``matvec`` is the
    product (``matvec4_plain``: the int4 kernel's order of sums, a QKV
    row-group's tiles over four warps, wo's over eight)."""
    H, hd = n_heads, head_dim
    N = H * hd
    hf = h.float().reshape(-1)
    ang = torch.tensor(float(max(t - off, 0)), device=h.device) * invf
    cos, sin = torch.cos(ang), torch.sin(ang)
    x = _rms_bf16(hf, attn_norm, eps)
    qkv = matvec(wqkv, x, 4) * wqs
    q = _rope(qkv[:N].view(H, hd), cos, sin)
    k = _rope(qkv[N:2 * N].view(H, hd), cos, sin)
    v = qkv[2 * N:].view(H, hd)
    k_cache[t] = k.reshape(N).to(k_cache.dtype)
    v_cache[t] = v.reshape(N).to(v_cache.dtype)
    kc = k_cache[off:t].float().view(-1, H, hd)
    vc = v_cache[off:t].float().view(-1, H, hd)
    vec = attn_vector_plain(q, k, v, kc, vc) if bounds is None else \
        attn_vector_split_plain(q, k, v, kc, vc, bounds)
    attn = vec.reshape(N).to(torch.bfloat16).float()
    return (hf + matvec(wo, attn) * wos).to(torch.bfloat16)[None]


def mlp_step_plain(
    h: torch.Tensor, mlp_norm: torch.Tensor, wgu: torch.Tensor, wgus: torch.Tensor,
    wd: torch.Tensor, wds: torch.Tensor, *, eps: float, matvec=matvec_plain,
) -> torch.Tensor:
    """Plain twin of the MLP half-layer: h [1, D] bf16 -> new h [1, D] bf16.
    wgu [2F, D] (gate rows then up rows) and wd [D, F] are int8-valued; the
    int4 kernels split a gate|up row-group's tiles over two warps, down's
    over eight (``matvec``'s ``slices``)."""
    F = wgu.shape[0] // 2
    hf = h.float().reshape(-1)
    x = _rms_bf16(hf, mlp_norm, eps)
    gu = matvec(wgu, x, 2) * wgus
    g, u = gu[:F], gu[F:]
    act = (g * torch.sigmoid(g) * u).to(torch.bfloat16).float()
    return (hf + matvec(wd, act) * wds).to(torch.bfloat16)[None]


def mega_decode_step_plain(
    tok_in: torch.Tensor, mp: Dict[str, torch.Tensor],
    k_all: torch.Tensor, v_all: torch.Tensor,
    t: int, off: int, suppress: bool, seed: int, *,
    n_heads: int, head_dim: int, eps: float, pad_id: int, bos_id: int,
    eos_id: int, greedy: bool = True, temperature: float = 1.0, top_k: int = 0,
    matvec=matvec_plain,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the CUDA step (same inputs, same rounding
    points): the embedding row, ``attn_step_plain`` and ``mlp_step_plain``
    per layer, the head and the sampler. int4 params are unpacked first.
    Updates k_all/v_all [L, S, H*hd] at row t in place; returns
    (h_last [1, D] bf16, next token [1] int32)."""
    mp = unpack_decode_params(mp)
    kw = dict(n_heads=n_heads, head_dim=head_dim, eps=eps, matvec=matvec)
    h = mp["emb"][int(tok_in.reshape(-1)[0])][None]
    for l in range(k_all.shape[0]):
        h = attn_step_plain(h, mp["attn_norm"][l], mp["wqkv"][l], mp["wqs"][l], mp["wo"][l],
                            mp["wos"][l], mp["invf"], k_all[l], v_all[l], t, off, **kw)
        h = mlp_step_plain(h, mp["mlp_norm"][l], mp["wgu"][l], mp["wgus"][l], mp["wd"][l],
                           mp["wds"][l], eps=eps, matvec=matvec)
    logits = head_logits_plain(h, mp, eps, matvec)
    nxt = sample_plain(
        logits, pad_id=pad_id, bos_id=bos_id, eos_id=eos_id, suppress=suppress,
        greedy=greedy, temperature=temperature, top_k=top_k, seed=seed,
    )
    return h, torch.tensor([nxt], dtype=torch.int32, device=h.device)


# ----------------------------------------------------------------------------- kernel


class _Plan(ctypes.Structure):
    """Field by field the ``DecodePlan`` of csrc/decode_step.cu."""
    _fields_ = ([(k, ctypes.c_void_p) for k in MP_KEYS]
                + [(k, ctypes.c_void_p) for k in ("k_all", "v_all", "h", "part", "logits", "tok_out", "bar",
                                                  "stamps", "hx", "actx", "cand", "qkvx")]
                + [(k, ctypes.c_int) for k in ("L", "D", "H", "hd", "F", "V", "S", "pad_id", "bos_id",
                                               "eos_id", "greedy", "top_k", "bits")]
                + [(k, ctypes.c_float) for k in ("eps", "scale", "temperature")])


class DecodeScratch(dict):
    """The step kernel's per-step buffers (a dict of tensors) and, once a
    decode step has run on them, its plan: the checked pointers and
    constants of that step's params, cache and sampler, so later steps pass
    only what changes."""

    def __init__(self, tensors):
        super().__init__(tensors)
        self.plan = None      # (_Plan, address of it, pointers it was made from, constants)


def _lib_int(name: str) -> int:
    return function("decode_step", name, [])()


def part_shape(n_heads: int, head_dim: int) -> Tuple[int, int, int]:
    """Shape of the attention partials buffer (f32) the built kernels take:
    per head, the most splits they make, each acc[hd], m, l and padding."""
    return (n_heads, _lib_int("decode_max_splits"), head_dim + _lib_int("decode_part_pad"))


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


ZEROED = ("bar", "hx", "actx", "qkvx")   # zeroed once: the write counts and the tagged words


def _half_scratch_spec(H: int, hd: int, F: int):
    """The half-layers' buffers (a decode step's scratch holds them too)."""
    return {"part": (part_shape(H, hd), torch.float32), "bar": ((_lib_int("decode_bar_words"),), torch.int32),
            "qkvx": ((3 * H * hd,), torch.int64), "actx": ((F,), torch.int32)}


def _scratch_spec(D: int, H: int, hd: int, F: int, V: int, bits: int):
    i32 = torch.int32
    lists = function("decode_step", "decode_sample_lists", [ctypes.c_int, ctypes.c_int])(V, bits)
    return {
        "h": ((1, D), torch.bfloat16), "logits": ((V,), torch.float32), "tok": ((1,), i32),
        "hx": ((D,), i32), "cand": ((lists, _lib_int("decode_cand_words")), i32),
        **_half_scratch_spec(H, hd, F),
    }


def decode_scratch(mp: Dict[str, torch.Tensor], n_heads: int, head_dim: int,
                   device, stamps: bool = False) -> DecodeScratch:
    """The step kernel's buffers on a CUDA device, to allocate once per
    request and pass to every step: h [1, D] bf16 (the last residual),
    the attention partials f32, logits f32, tok [1] int32; and, zeroed
    here, ``bar`` (the count of steps run on this scratch, the grid
    barrier's counter and the sampler's ticket, and the half-layers' own
    counts and counters), ``hx`` / ``actx`` / ``qkvx`` (the residual, the
    activation and q, k, v as tagged words between the kernel's blocks);
    ``cand`` (the sampler's lists, one a head unit of 32 logits). It
    serves the half-layers too (``half_layer_scratch``'s buffers), before,
    after or between steps. The first step on it checks every tensor once
    and keeps the plan here; a later step with other params, caches or
    sampler raises. ``stamps`` adds an int64 buffer [5 L + 3, SMs, 2] in
    which every block of the kernel records, in nanoseconds of the card's
    timer, when it arrived at and when it left the wait before each phase
    (5 a layer, the head, the sampler's ticket); the last slot holds the
    step's end."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"decode scratch: the kernels' buffers live on a CUDA device, not on {device}")
    spec = _scratch_spec(mp["emb"].shape[1], n_heads, head_dim,
                         mp["wgu"].shape[1] // 2, mp["head"].shape[0], weight_bits(mp))
    scratch = DecodeScratch({k: (torch.zeros if k in ZEROED else torch.empty)(shape, dtype=dt, device=device)
                             for k, (shape, dt) in spec.items()})
    if stamps:
        scratch["stamps"] = torch.zeros(_stamps_shape(mp["wqkv"].shape[0], device), dtype=torch.int64,
                                        device=device)
    return scratch


def _stamps_shape(n_layers: int, device) -> Tuple[int, int, int]:
    """One slot per wait (5 a layer, the head, the sampler's ticket) and one
    for the step's end, per block (one block an SM), arrival and leave."""
    return (5 * n_layers + 3, _sms(device), 2)


def _check_tensors(what: str, dev, want: Dict[str, Tuple[torch.Tensor, tuple, torch.dtype]]) -> None:
    """Every tensor the kernels read through a raw pointer: on ``dev``,
    contiguous, of the stated shape and type, 16-byte aligned."""
    for name, (a, shape, dtype) in want.items():
        if tuple(a.shape) != tuple(shape) or a.dtype != dtype or a.device != dev or not a.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {dtype} {tuple(shape)} on {dev}, "
                             f"got {a.dtype} {tuple(a.shape)} on {a.device}")
        if a.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def _width_fault(bits: int, hd: Optional[int] = None, V: Optional[int] = None, **widths: int) -> Optional[str]:
    """Why the kernels cannot run these widths, or None: every contraction
    width a warp streams in 16-byte loads (int4: in tiles of 64 and a half
    tile of 32), the head
    width the attention's lanes span (where there is attention), the
    shared-memory cap, and the vocabulary the step's sampler holds (where
    there is one)."""
    if V is not None and V > MAX_VOCAB:
        return f"vocab {V} beyond the sampler's {MAX_VOCAB}"
    mult = 16 if bits == 8 else TILE_K // 2
    bad = {k: v for k, v in widths.items() if v % mult}
    if bad:
        return f"{bad} must be multiples of {mult} at {bits} bits"
    if hd is not None and hd not in HEAD_DIMS:
        return f"head_dim {hd} not in {HEAD_DIMS}"
    span = 32 * 16          # the int8 vector is laid out in rows of 32 loads: lengths round up to them
    padded = {k: -(-v // span) * span for k, v in widths.items()}
    if max(padded.values()) > SMEM_FLOATS or padded["D"] + widths["D"] > SMEM_FLOATS:
        return f"widths {widths} beyond the kernel's shared-memory cap {SMEM_FLOATS}"
    return None


def _check_widths(what: str, bits: int, hd: Optional[int] = None, V: Optional[int] = None,
                  **widths: int) -> None:
    fault = _width_fault(bits, hd, V, **widths)
    if fault:
        raise ValueError(f"{what}: {fault}")


def step_serves(*, dim: int, n_heads: int, n_kv_heads: int, head_dim: int, ffn_dim: int,
                vocab: int, bits: int = 8) -> bool:
    """Whether ``mega_decode_step`` runs an LM of these widths at ``bits``:
    H = K, widths and head width the kernel's loads and lanes take, within
    its shared memory, and a vocabulary its sampler holds. The one rule the
    engine picks the decode kernel by (B=1, int8 weights) and the one
    ``_make_plan`` raises by."""
    return n_heads == n_kv_heads and _width_fault(bits, head_dim, vocab, D=dim, N=n_heads * head_dim,
                                                  F=ffn_dim) is None


def _make_plan(mp, k_all, v_all, scratch: DecodeScratch, const: tuple):
    """Check every tensor and width of a decode step once and pack what the
    C entry point needs into a ``_Plan``."""
    what = "mega_decode_step"
    H, hd, eps, pad_id, bos_id, eos_id, greedy, temperature, top_k = const
    L, S, N = k_all.shape
    D = mp["emb"].shape[1]
    V = mp["head"].shape[0]
    F = mp["wgu"].shape[1] // 2
    dev = k_all.device
    bits = weight_bits(mp)
    if N != H * hd:
        raise ValueError(f"{what}: cache width {N} != n_heads*head_dim {H * hd} (GQA is not supported)")
    _check_widths(what, bits, hd, V=V, D=D, N=N, F=F)
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
    for name, (shape, dtype) in _scratch_spec(D, H, hd, F, V, bits).items():
        if name not in scratch:
            raise ValueError(f"{what}: scratch lacks {name!r} (make it with decode_scratch)")
        want[f"scratch {name}"] = (scratch[name], shape, dtype)
    if "stamps" in scratch:
        want["scratch stamps"] = (scratch["stamps"], _stamps_shape(L, dev), torch.int64)
    _check_tensors(what, dev, want)
    plan = _Plan(**{k: mp[k].data_ptr() for k in MP_KEYS},
                 k_all=k_all.data_ptr(), v_all=v_all.data_ptr(),
                 h=scratch["h"].data_ptr(), part=scratch["part"].data_ptr(),
                 logits=scratch["logits"].data_ptr(), tok_out=scratch["tok"].data_ptr(),
                 bar=scratch["bar"].data_ptr(),
                 stamps=scratch["stamps"].data_ptr() if "stamps" in scratch else None,
                 hx=scratch["hx"].data_ptr(), actx=scratch["actx"].data_ptr(),
                 cand=scratch["cand"].data_ptr(), qkvx=scratch["qkvx"].data_ptr(),
                 L=L, D=D, H=H, hd=hd, F=F, V=V, S=S, pad_id=pad_id, bos_id=bos_id, eos_id=eos_id,
                 greedy=int(bool(greedy)), top_k=int(top_k), bits=bits,
                 eps=float(eps), scale=hd ** -0.5, temperature=float(temperature))
    return plan, ctypes.addressof(plan), _plan_pointers(mp, k_all, v_all, scratch), const


def _plan_pointers(mp, k_all, v_all, scratch) -> tuple:
    """What a plan's raw pointers were read from: a step compares this with
    its own arguments, so a tensor replaced since (in ``mp``, in the
    scratch, or another cache) raises instead of running on a stale one."""
    return (tuple(mp[k].data_ptr() for k in MP_KEYS) + tuple(v.data_ptr() for v in scratch.values())
            + (k_all.data_ptr(), v_all.data_ptr()) + tuple(k_all.shape))


def _launch(tok_in, mp, k_all, v_all, t, off, suppress, seed, *, n_heads,
            head_dim, eps, pad_id, bos_id, eos_id, greedy, temperature, top_k,
            scratch):
    what = "mega_decode_step"
    dev = k_all.device
    if scratch is None:
        scratch = decode_scratch(mp, n_heads, head_dim, dev)
    elif not isinstance(scratch, DecodeScratch):
        scratch = DecodeScratch(scratch)      # checked on every step
    const = (n_heads, head_dim, eps, pad_id, bos_id, eos_id, greedy, temperature, top_k)
    if scratch.plan is None:
        scratch.plan = _make_plan(mp, k_all, v_all, scratch, const)
    plan, plan_ptr, plan_pointers, plan_const = scratch.plan
    if plan_const != const or plan_pointers != _plan_pointers(mp, k_all, v_all, scratch):
        raise ValueError(f"{what}: this scratch was planned for other params, caches, buffers or "
                         f"sampler settings; make one per (params, cache) with decode_scratch")
    S = plan.S
    if not (0 <= off <= t < S):
        raise ValueError(f"{what}: need 0 <= off ({off}) <= t ({t}) < S ({S})")
    if not (tok_in.is_cuda and tok_in.dtype == torch.int32 and tok_in.device == dev
            and tok_in.numel() == 1):
        raise ValueError(f"{what}: tok_in must be an int32 [1] tensor on the cache's device")
    rc = function("decode_step", "mega_decode_step", _STEP_ARGTYPES)(
        plan_ptr, tok_in.data_ptr(), int(t), int(off), int(bool(suppress)),
        int(seed) & 0x7FFFFFFF, torch.cuda.current_stream(dev).cuda_stream)
    check(rc, what)
    if plan.bits == 8:
        mega_decode_step.launches += 1
    else:
        mega_decode_step.launches_int4 += 1
    return scratch["h"], scratch["tok"]


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
    ``tok_in``. A scratch serves one (params, cache, sampler settings): its
    first step checks them and later steps only compare their addresses, so
    a step with others raises. A CPU step ignores ``scratch``."""
    kw = dict(n_heads=n_heads, head_dim=head_dim, eps=eps, pad_id=pad_id,
              bos_id=bos_id, eos_id=eos_id, greedy=greedy,
              temperature=temperature, top_k=top_k)
    forward_only("mega_decode_step", tok_in, k_all, v_all, *mp.values())
    if k_all.device.type == "cpu":
        return mega_decode_step_plain(tok_in, mp, k_all, v_all, t, off, suppress, seed, **kw)
    return _launch(tok_in, mp, k_all, v_all, t, off, suppress, seed, scratch=scratch, **kw)


mega_decode_step.launches = 0
mega_decode_step.launches_int4 = 0


def half_layer_scratch(dim: int, n_heads: int, head_dim: int, ffn_dim: int, device) -> Dict[str, torch.Tensor]:
    """The half-layer kernels' buffers on a CUDA device, to allocate once per
    request and pass to every call (or to ``plan_half_layers``): the
    attention partials f32; and, zeroed here, ``bar`` (each half's count of
    calls, which its tags count from, and their grid counter and ticket)
    and ``qkvx`` / ``actx`` (q, k, v and the activation as tagged words
    between the kernels' blocks). A ``decode_scratch`` holds the same
    buffers and serves as well."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"half-layer scratch: the kernels' buffers live on a CUDA device, not on {device}")
    return {k: (torch.zeros if k in ZEROED else torch.empty)(shape, dtype=dt, device=device)
            for k, (shape, dt) in _half_scratch_spec(n_heads, head_dim, ffn_dim).items()}


def _layer_plan(what: str, h, lw, invf, kc, vc, scratch, stamps, *, n_heads: int, head_dim: int, eps: float,
                kinds=("attn", "mlp")) -> "_Plan":
    """Check every tensor and width of one layer's half-layers of ``kinds``
    once (the weights in ``lw``, the residual h, the caches and invf for
    the attention, the scratch's buffers and the stamps) and pack the
    pointers into a ``_Plan`` of one layer, as the C entry points take it."""
    attn, mlp = "attn" in kinds, "mlp" in kinds
    names = (ATTN_KEYS if attn else ()) + (MLP_KEYS if mlp else ())
    missing = [k for k in names if k not in lw]
    if missing:
        raise ValueError(f"{what}: the layer lacks {missing}")
    D = h.shape[-1]
    H, hd = n_heads, head_dim
    first = "wqkv" if attn else "wgu"
    bits = _row_bits(what, first, lw[first], D)
    i8, f32, bf = torch.int8, torch.float32, torch.bfloat16
    want = {"h": (h, (1, D), bf)}
    widths = dict(D=D)
    S = N = F = 0
    if attn:
        if kc.dim() != 2:
            raise ValueError(f"{what}: k_cache must be [S, N], got {tuple(kc.shape)}")
        S, N = kc.shape
        if N != H * hd:
            raise ValueError(f"{what}: cache width {N} != n_heads*head_dim {H * hd} (GQA is not supported)")
        widths["N"] = N
        want.update({
            "attn_norm": (lw["attn_norm"], (D,), f32), "wqkv": (lw["wqkv"], (3 * N, D * bits // 8), i8),
            "wqs": (lw["wqs"], (3 * N,), f32), "wo": (lw["wo"], (D, N * bits // 8), i8),
            "wos": (lw["wos"], (D,), f32), "invf": (invf, (hd // 2,), f32),
            "k_cache": (kc, (S, N), bf), "v_cache": (vc, (S, N), bf)})
    if mlp:
        F = lw["wd"].shape[-1] * 8 // bits
        widths["F"] = F
        want.update({
            "mlp_norm": (lw["mlp_norm"], (D,), f32), "wgu": (lw["wgu"], (2 * F, D * bits // 8), i8),
            "wgus": (lw["wgus"], (2 * F,), f32), "wd": (lw["wd"], (D, F * bits // 8), i8),
            "wds": (lw["wds"], (D,), f32)})
    _check_widths(what, bits, hd if attn else None, **widths)
    dev = h.device
    if scratch is not None:
        spec = _half_scratch_spec(H, hd, F)
        for name in (("part", "qkvx") if attn else ()) + (("actx",) if mlp else ()) + ("bar",):
            if name not in scratch:
                raise ValueError(f"{what}: scratch lacks {name!r} (make it with half_layer_scratch or decode_scratch)")
            want[f"scratch {name}"] = (scratch[name], *spec[name])
    if stamps is not None:
        if dev.type != "cuda":
            raise ValueError(f"{what}: stamps are the kernels' timestamps, on a CUDA device")
        want["stamps"] = (stamps, (HALF_STAMP_SLOTS, _sms(dev), 2), torch.int64)
    _check_tensors(what, dev, want)
    ptr = lambda t: None if t is None else t.data_ptr()
    buf = lambda name: ptr(scratch.get(name)) if scratch is not None else None
    return _Plan(**{k: ptr(lw.get(k)) if k in names else None for k in ATTN_KEYS + MLP_KEYS},
                 invf=ptr(invf) if attn else None, k_all=ptr(kc) if attn else None,
                 v_all=ptr(vc) if attn else None, h=ptr(h), part=buf("part"), bar=buf("bar"),
                 qkvx=buf("qkvx"), actx=buf("actx"), stamps=ptr(stamps),
                 L=1, D=D, H=H, hd=hd, F=F, S=S, bits=bits, eps=float(eps),
                 scale=float(hd) ** -0.5 if hd else 0.0)


_FITTED = set()   # (device, bits, D, N, hd, F): widths the half-layer kernels were fitted to


def _fit(plan: "_Plan", what: str) -> None:
    """Allow the half-layer kernels their shared memory at the plan's
    widths and check that one block an SM fits (the cooperative grid),
    once a device and widths; raises otherwise: there is nothing else to
    run."""
    key = (torch.cuda.current_device(), plan.bits, plan.D, plan.H * plan.hd, plan.hd, plan.F)
    if key not in _FITTED:
        check(function("decode_step", "half_layers_fit", [ctypes.c_void_p])(ctypes.addressof(plan)), what)
        _FITTED.add(key)


class HalfLayerPlan:
    """Every layer's two half-layers over one residual ``h`` [1, D] bf16
    (updated in place by every call), one cache and one scratch, checked
    once (``plan_half_layers``). On the card: a ``_Plan`` a layer for the C
    entry points, which a call takes with PyTorch's current stream of the
    plan's device; on the CPU: the plain half-layers' arguments (int4 rows
    unpacked once). It holds every tensor it was made from, so no pointer
    it keeps goes stale."""

    def __init__(self, h: torch.Tensor, n_layers: int, S: int, cards=None, plain=None, keep=()):
        self.h = h
        self.n_layers = n_layers
        self.S = S
        self.cards = cards    # [(_Plan, its address)] a layer (CUDA)
        self.plain = plain    # [(attention args, MLP args)] a layer (CPU)
        self.keep = keep
        if cards is not None:   # what a call needs besides its plan, looked up once
            self.attn_fn = function("decode_step", "attn_half_step", _ATTN_HALF_ARGTYPES)
            self.mlp_fn = function("decode_step", "mlp_half_step", _MLP_HALF_ARGTYPES)
            index = h.device.index if h.device.index is not None else torch.cuda.current_device()
            self.stream = lambda: torch._C._cuda_getCurrentRawStream(index)   # the current stream's handle


def plan_half_layers(
    h: torch.Tensor,                       # [1, D] bf16, the residual every call updates in place
    layers: Sequence[Dict[str, torch.Tensor]],   # per-layer weights (unstack_decode_params), int8 or int4
    invf: torch.Tensor,                    # [hd/2] f32
    k_all: torch.Tensor,                   # [L, S, H*hd] bf16, row t of layer l written by its call
    v_all: torch.Tensor,
    *,
    n_heads: int, head_dim: int, eps: float,
    scratch: Optional[Dict[str, torch.Tensor]] = None,   # half_layer_scratch / decode_scratch (the card)
    stamps: Optional[torch.Tensor] = None,               # int64 [HALF_STAMP_SLOTS, SMs, 2] (the card)
) -> HalfLayerPlan:
    """Check every layer's weights, the residual, the caches, the scratch
    and the widths once, for a decode loop that then calls
    ``attn_step_planned`` / ``mlp_step_planned`` (or ``layers_planned``)
    with only a layer, ``t`` and ``off``. A CUDA plan needs a scratch;
    ``stamps`` has every block of a call's kernel record when it arrived at
    and left each of its waits (3 for the attention, 2 for the MLP) and
    then its end, in ns of the card's timer. Raises, naming the tensor, on
    anything the kernels cannot take."""
    what = "plan_half_layers"
    forward_only(what, h, invf, k_all, v_all, *(t for lw in layers for t in lw.values()))
    L = len(layers)
    if L == 0 or k_all.dim() != 3 or k_all.shape[0] != L or tuple(v_all.shape) != tuple(k_all.shape):
        raise ValueError(f"{what}: k_all / v_all must be [{L}, S, N] for {L} layers, "
                         f"got {tuple(k_all.shape)} / {tuple(v_all.shape)}")
    dev = k_all.device
    if dev.type == "cuda" and scratch is None:
        raise ValueError(f"{what}: the kernels need a scratch (half_layer_scratch or decode_scratch)")
    kw = dict(n_heads=n_heads, head_dim=head_dim, eps=eps)
    plans = [_layer_plan(f"{what}: layer {l}", h, lw, invf, k_all[l], v_all[l], scratch, stamps, **kw)
             for l, lw in enumerate(layers)]
    keep = (h, invf, k_all, v_all, scratch, stamps, [dict(lw) for lw in layers])
    if dev.type != "cuda":
        unpack = (lambda w: unpack4(w)) if plans[0].bits == 4 else (lambda w: w)
        plain = [((lw["attn_norm"], unpack(lw["wqkv"]), lw["wqs"], unpack(lw["wo"]), lw["wos"], invf,
                   k_all[l], v_all[l]),
                  (lw["mlp_norm"], unpack(lw["wgu"]), lw["wgus"], unpack(lw["wd"]), lw["wds"]))
                 for l, lw in enumerate(layers)]
        return HalfLayerPlan(h, L, k_all.shape[1], plain=(plain, kw), keep=keep)
    _fit(plans[0], what)
    return HalfLayerPlan(h, L, k_all.shape[1], cards=[(p, ctypes.addressof(p)) for p in plans], keep=keep)


def attn_step_planned(plan: HalfLayerPlan, l: int, t: int, off: int) -> torch.Tensor:
    """Layer l's attention half-layer on a plan: ``plan.h`` and row t of
    the layer's caches updated in place; returns ``plan.h``."""
    if not 0 <= off <= t < plan.S:
        raise ValueError(f"attn_step: need 0 <= off ({off}) <= t ({t}) < S ({plan.S})")
    if plan.plain is not None:
        layers, kw = plan.plain
        plan.h.copy_(attn_step_plain(plan.h, *layers[l][0], t, off, **kw))
        return plan.h
    check(plan.attn_fn(plan.cards[l][1], t, off, plan.stream()), "attn_step")
    attn_step.launches += 1
    return plan.h


def mlp_step_planned(plan: HalfLayerPlan, l: int) -> torch.Tensor:
    """Layer l's MLP half-layer on a plan: ``plan.h`` updated in place;
    returns it."""
    if plan.plain is not None:
        layers, kw = plan.plain
        plan.h.copy_(mlp_step_plain(plan.h, *layers[l][1], eps=kw["eps"]))
        return plan.h
    check(plan.mlp_fn(plan.cards[l][1], plan.stream()), "mlp_step")
    mlp_step.launches += 1
    return plan.h


def layers_planned(plan: HalfLayerPlan, t: int, off: int, n_layers: int) -> torch.Tensor:
    """One token through every layer of a plan (``plan.h`` holds its input
    row): the attention then the MLP half-layer, layer by layer; returns
    ``plan.h``. Raises where the plan holds another number of layers than
    ``n_layers``, the LM's."""
    if plan.n_layers != n_layers:
        raise ValueError(f"layers_planned: the plan holds {plan.n_layers} layers, the LM {n_layers}")
    for l in range(n_layers):
        attn_step_planned(plan, l, t, off)
        mlp_step_planned(plan, l)
    return plan.h


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
    """One decode attention half-layer (int8 weights, or int4 ones as
    ``pack4`` lays them out). Unlike the JAX function, which returns new
    arrays, this one updates ``h`` and row ``t`` of the caches in place and
    returns ``h``. Every tensor is checked on every call (a loop plans its
    layers once: ``plan_half_layers``). ``scratch``: the kernel's buffers
    (``half_layer_scratch`` or ``decode_scratch``); zeroed ones are
    allocated per call otherwise."""
    kw = dict(n_heads=n_heads, head_dim=head_dim, eps=eps)
    forward_only("attn_step", h, attn_norm, wqkv, wqs, wo, wos, invf, k_cache, v_cache)
    what = "attn_step"
    D = h.shape[-1]
    bits = _row_bits(what, "wqkv", wqkv, D)
    if h.device.type == "cpu":
        if bits == 4:
            wqkv, wo = unpack4(wqkv), unpack4(wo)
        h.copy_(attn_step_plain(h, attn_norm, wqkv, wqs, wo, wos, invf, k_cache, v_cache, t, off, **kw))
        return h
    if scratch is None:
        scratch = half_layer_scratch(D, n_heads, head_dim, 0, h.device)
    lw = dict(attn_norm=attn_norm, wqkv=wqkv, wqs=wqs, wo=wo, wos=wos)
    plan = _layer_plan(what, h, lw, invf, k_cache, v_cache, scratch, None, kinds=("attn",), **kw)
    _fit(plan, what)
    return attn_step_planned(HalfLayerPlan(h, 1, plan.S, cards=[(plan, ctypes.addressof(plan))]), 0, t, off)


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
    """One decode MLP half-layer (int8 weights, or int4 ones as ``pack4``
    lays them out); updates ``h`` in place and returns it. Every tensor is
    checked on every call. ``scratch``: as ``attn_step``'s."""
    forward_only("mlp_step", h, mlp_norm, wgu, wgus, wd, wds)
    what = "mlp_step"
    D = h.shape[-1]
    bits = _row_bits(what, "wgu", wgu, D)
    if h.device.type == "cpu":
        if bits == 4:
            wgu, wd = unpack4(wgu), unpack4(wd)
        h.copy_(mlp_step_plain(h, mlp_norm, wgu, wgus, wd, wds, eps=eps))
        return h
    if scratch is None:
        scratch = half_layer_scratch(D, 0, 0, wd.shape[-1] * 8 // bits, h.device)
    lw = dict(mlp_norm=mlp_norm, wgu=wgu, wgus=wgus, wd=wd, wds=wds)
    plan = _layer_plan(what, h, lw, None, None, None, scratch, None, n_heads=0, head_dim=0, eps=eps,
                       kinds=("mlp",))
    _fit(plan, what)
    return mlp_step_planned(HalfLayerPlan(h, 1, 0, cards=[(plan, ctypes.addressof(plan))]), 0)


mlp_step.launches = 0
