"""The benchmark's counts at tiny shapes against arithmetic by hand."""

from __future__ import annotations

import pytest

from portbench import counts

LM = {"n_layers": 2, "dim": 8, "ffn_dim": 16, "speech_vocab_size": 5, "n_heads": 2, "n_kv_heads": 2}


def test_decode_step():
    # weights: 2 x (3*8*8 + 8*8 + 2*16*8 + 8*16) + 5*8 = 2 x 640 + 40 = 1320
    # scales: 4*(2*(24 + 8 + 32 + 8) + 5) + 4*(2*2*8 + 8) = 4*149 + 160 = 756
    # cache: 2*2*10*8*2 + 2*2*8*2 = 640 + 64
    nbytes, ops = counts.decode_step(LM, 8, 10)
    assert nbytes == 1320 + 756 + 16 + 704 + 16 + 4
    assert ops == 2 * 1320 + 4 * 2 * 8 * 11
    nbytes4, ops4 = counts.decode_step(LM, 4, 10)
    assert nbytes - nbytes4 == 1320 // 2 and ops4 == ops


def test_flash():
    nbytes, ops = counts.flash(3, 2, 4)     # 6 (query, key) pairs a head
    assert nbytes == 2 * 4 * 3 * 2 * 4 + 4
    assert ops == 4 * 4 * 12


def test_log_mel():
    nbytes, ops, frames = counts.log_mel(100, 8, 4, 8, 3)
    assert frames == 26
    assert ops == 26 * (2 * 2 * 8 * 5 + 3 * 5 + 2 * 5 * 3)
    assert nbytes == 4 * (100 + 26 * 3)
    assert counts.log_mel_shared(8, 8, 3) == 4 * (2 * 8 * 5 + 5 * 3)


def test_bound_takes_the_slower_side():
    assert counts.bound_s(3.35e12, 0, 1.0) == pytest.approx(1.0)
    assert counts.bound_s(0, 989e12, counts.BF16_FLOP_PER_S) == pytest.approx(1.0)


def test_request_flops():
    cfg = {"token_lm": LM,
           "cfm": {"upsample": 2, "dim": 4, "ffn_dim": 8, "n_layers": 1, "n_mels": 2, "n_steps": 2, "use_cfg": False},
           "vocoder": {"istft_channels": 2, "istft_n_fft": 4, "n_mels": 2, "istft_blocks": 1, "istft_kernel": 3}}
    W = 2 * (8 * 24 + 8 * 8 + 2 * 16 * 8 + 16 * 8)       # 1152
    lm = sum(2 * W + 4 * 2 * 8 * (j + 1) for j in range(3 + 1)) + 2 * 8 * 5 * 2   # prefix 3, 2 generated
    frames = (1 + 2) * 2
    per_frame = 1 * (4 * 16 + 2 * 4 * 8) + 5 * 4 + 4 * 2
    cfm = 2 * (2 * per_frame * frames + 4 * 1 * 4 * frames * frames)
    voc = frames * (2 * (7 * 2 * 2 + 1 * (3 * 4 + 6 * 4) + 2 * 2 * 3) + 4 * 3 * 4)
    assert counts.request_flops(cfg, 3, 2, 1) == lm + cfm + voc
