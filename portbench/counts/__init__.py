"""Bytes, operations and model FLOPs at the lengths the traffic really gave,
and the H100's peaks (NVIDIA's data sheet, SXM, dense, at 700 W).

The kernel counts are the arithmetic of ``chip_smoke.py`` (``decode_case``,
``flash_measure``, ``log_mel_bounds``), taken at real lengths instead of
the program's padded widths: each input byte read once, each output byte
written once.
"""

from __future__ import annotations

from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
LOGMEL_PASSES = 3          # TF32 products per f32 product in the log-mel kernel (hi/lo split)


def bound_s(nbytes: float, ops: float, peak_ops: float) -> float:
    """The least time: bytes at the HBM rate or operations at the peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak_ops)


def decode_step(lm: Dict, bits: int, n_keys: int) -> Tuple[float, float]:
    """(bytes, int8 operations) of one B=1 decode step whose attention
    reads ``n_keys`` cached keys and writes one more row: every weight
    stream at ``bits``, its f32 scales and norms, the token's embedding
    row, the cache rows read and written, the residual out and the token."""
    L, D, F, V = lm["n_layers"], lm["dim"], lm["ffn_dim"], lm["speech_vocab_size"]
    N = lm["n_heads"] * (D // lm["n_heads"])
    n_weights = L * (3 * N * D + D * N + 2 * F * D + D * F) + V * D
    scales = 4 * (L * (3 * N + D + 2 * F + D) + V) + 4 * (2 * L * D + D)
    cache = 2 * L * n_keys * N * 2 + 2 * L * N * 2
    nbytes = n_weights * bits // 8 + scales + D * 2 + cache + D * 2 + 4
    ops = 2 * n_weights + 4 * L * N * (n_keys + 1)
    return nbytes, ops


def flash(n: int, n_heads: int, head_dim: int) -> Tuple[float, float]:
    """(bytes, bf16 FLOPs) of one causal prefill attention over the n real
    prompt rows of one layer: q, k, v read and the output written once in
    bf16; QK and PV over every (query, key <= query) pair."""
    pairs = n * (n + 1) // 2 * n_heads
    return 2 * 4 * n * n_heads * head_dim + 4, 4.0 * head_dim * pairs


def log_mel(samples: int, n_fft: int, hop: int, win: int, n_mels: int) -> Tuple[float, float, float]:
    """(bytes, FLOPs, frames) of the log-mel of one wav of ``samples``
    real samples (frames of the centred STFT): the samples read, the mel
    written; the DFT's two products, the power and the mel product. The
    launch's shared reads (DFT basis, filterbank) are ``log_mel_shared``."""
    frames = 1 + samples // hop
    n_bins = n_fft // 2 + 1
    ops = frames * (2 * 2 * win * n_bins + 3 * n_bins + 2 * n_bins * n_mels)
    return 4 * (samples + frames * n_mels), ops, frames


def log_mel_shared(n_fft: int, win: int, n_mels: int) -> float:
    n_bins = n_fft // 2 + 1
    return 4 * (2 * win * n_bins + n_bins * n_mels)


LOGMEL_PEAK = TF32_FLOP_PER_S / LOGMEL_PASSES


def lm_layer_weights(lm: Dict) -> int:
    D, F = lm["dim"], lm["ffn_dim"]
    hd = D // lm["n_heads"]
    N, Nk = lm["n_heads"] * hd, lm["n_kv_heads"] * hd
    return lm["n_layers"] * (D * (N + 2 * Nk) + N * D + 2 * F * D + F * D)


def request_flops(cfg: Dict, n_prefix: int, n_gen: int, n_prompt: int) -> float:
    """Model FLOPs of one request at its real lengths: the ``n_prefix``
    prompt positions and ``n_gen`` generated tokens through the token LM
    (its head once a token), then the ``(n_prompt + n_gen) * upsample``
    mel frames through each CFM step and through the vocoder."""
    lm, c, v = cfg["token_lm"], cfg["cfm"], cfg["vocoder"]
    W = lm_layer_weights(lm)
    L, D, V = lm["n_layers"], lm["dim"], lm["speech_vocab_size"]
    attn = lambda j: 4 * L * D * (j + 1)          # noqa: E731  QK and PV against j + 1 keys
    positions = n_prefix + max(n_gen - 1, 0)       # the last token is never fed back
    flops = sum(2 * W + attn(j) for j in range(positions)) + 2 * D * V * n_gen
    frames = (n_prompt + n_gen) * c["upsample"]
    Dc, Fc, Lc, M = c["dim"], c["ffn_dim"], c["n_layers"], c["n_mels"]
    per_frame = Lc * (4 * Dc * Dc + 2 * Dc * Fc) + (2 * M + 1) * Dc + Dc * M
    calls = c["n_steps"] * (2 if c["use_cfg"] else 1)
    flops += calls * (2 * per_frame * frames + 4 * Lc * Dc * frames * frames)
    C, n_bins = v["istft_channels"], v["istft_n_fft"] // 2 + 1
    voc = 7 * v["n_mels"] * C + v["istft_blocks"] * (v["istft_kernel"] * C * C + 6 * C * C) + C * 2 * n_bins
    flops += frames * (2 * voc + 4 * n_bins * v["istft_n_fft"])
    return float(flops)
