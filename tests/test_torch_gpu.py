"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without CUDA every test here skips (decided inside the
fixture, never at import). On a machine with a card, from the repository
root (``--noconftest`` because the repository's conftest imports JAX, which
that machine does not need):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: bf16 outputs, two bf16 ulps at the values' scale (flash);
the decode step's residual and cache rows within 2e-2 of max(|h|, 1) after
two layers, and the same greedy and sampled token (int8 and int4); one
half-layer's residual within 2e-2 of max(|h|, 1); the fused log-mel within
1e-3 in log units of the three-matmul version (split-TF32 products at f32
level, sums in another order), bit for bit the same from one call to the next;
the scanned decode's greedy tokens equal to the CPU run's; the transposed
conv within 1e-4 of the CPU's (cuDNN, TF32 off); a streamed request's
tokens equal to the same request's unstreamed, through the decode kernel;
a continuous batch's admission prefill (B=4 at T=384, per-row offsets)
within two bf16 ulps of the plain attention on every layer's inputs; the
flash kernel at the RAG embedder's shapes (H=24, K=8, hd=128: right-padded
embed rows at offset 0, left-padded generation prompts) within two bf16
ulps and finite on every row; one ``EmbedderService.embed`` on the card
within 2e-2 of the largest |component| of the CPU port's (bf16
activations, the kernel against the plain attention, sums in another
order); every kernel wrapper refuses an input that requires grad under
grad mode (before any launch), and the vocoder's mel loss differentiates
on the card without the log-mel kernel, its gradient within 1e-3 of the
CPU's largest component.
"""

import dataclasses

import numpy as np
import pytest
import torch

from autostyle_tts_tpu_torch.models import token_lm
from autostyle_tts_tpu_torch.models import transformer
from autostyle_tts_tpu_torch.ops import decode_step
from autostyle_tts_tpu_torch.ops import conv, stft
from autostyle_tts_tpu_torch.ops.flash_attn import flash_attention, flash_attention_plain
from autostyle_tts_tpu_torch.ops.log_mel import fused_log_mel, fused_log_mel_plain
from autostyle_tts_tpu_torch.ops.sampling import SamplerConfig
from autostyle_tts_tpu_torch.pipeline.engine import Engine, PromptFeatures
from autostyle_tts_tpu_torch.utils import rng
from autostyle_tts_tpu_torch.utils.config import tiny_config
from autostyle_tts_tpu_torch.weights import quantize_tree
from autostyle_tts_tpu_torch.weights import to_device as weights_to

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("T,H,K,hd,offsets", [
    (192, 4, 4, 64, [0, 37]), (192, 8, 2, 32, [5, 130]), (192, 4, 1, 16, [64, 0]),
    (192, 4, 4, 128, [0, 37]), (192, 8, 2, 128, [5, 130]),     # hd = 128, plain and GQA
    (150, 4, 4, 64, [0, 70]), (45, 4, 2, 128, [3, 44]),        # T not a multiple of the tile
    (192, 4, 4, 64, [63, 64]), (192, 4, 2, 32, [31, 32]),      # offset at the edges of a tile
    (192, 4, 4, 64, [65, 127]),                                # ... and inside one
])
def test_flash_kernel_matches_plain(cuda, T, H, K, hd, offsets):
    g = torch.Generator(device=cuda).manual_seed(0)
    B = len(offsets)
    q = torch.randn((B, T, H, hd), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((B, T, K, hd), generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn((B, T, K, hd), generator=g, device=cuda).to(torch.bfloat16)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, off)
    assert flash_attention.launches == n0 + 1
    want = flash_attention_plain(q, k, v, off)
    real = (torch.arange(T, device=cuda)[None, :] >= off[:, None].long())[:, :, None, None]
    err = ((got.float() - want.float()).abs() * real).max().item()
    assert err <= 2e-2


def test_flash_kernel_raises_for_unbuilt_head_dim(cuda):
    """A head width the kernel is not built for raises on the card; nothing
    takes the plain version there."""
    q = torch.zeros((1, 128, 2, 48), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q, torch.zeros((1,), dtype=torch.int32, device=cuda))


def test_flash_kernel_rejects_f32(cuda):
    q = torch.zeros((1, 64, 4, 64), device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention(q, q, q, torch.zeros((1,), dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("greedy", [True, False])
def test_decode_step_kernel_matches_plain(cuda, greedy, bits):
    """Six consecutive steps, each reading the rows the kernel itself wrote
    before; then single steps at live-slot counts t - off in {0, 1, 7, 220,
    S - 1 - off}: the empty cache, one split, and every split count up to
    the cap."""
    cfg = tiny_config().token_lm
    g = torch.Generator(device=cuda).manual_seed(1)
    lm = quantize_tree(token_lm.init_params(cfg, g))
    mp = token_lm.mega_decode_params(lm, cfg, bits=bits)
    count = "launches" if bits == 8 else "launches_int4"
    n0 = getattr(decode_step.mega_decode_step, count)
    L, N, S, off = cfg.n_layers, cfg.dim, 448, 4
    k1 = (torch.randn((L, S, N), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    v1 = (torch.randn((L, S, N), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    k2, v2 = k1.clone(), v1.clone()
    kw = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim, eps=cfg.norm_eps,
              pad_id=cfg.speech_pad, bos_id=cfg.speech_bos, eos_id=cfg.speech_eos,
              greedy=greedy, temperature=0.8, top_k=5)
    scratch = decode_step.decode_scratch(mp, cfg.n_heads, cfg.head_dim, cuda)
    tok = torch.tensor([3], dtype=torch.int32, device=cuda)

    def step(i, t):
        hk, tk = decode_step.mega_decode_step(tok, mp, k1, v1, t, off, i == 0, 77 + i, scratch=scratch, **kw)
        hp, tp = decode_step.mega_decode_step_plain(tok, mp, k2, v2, t, off, i == 0, 77 + i, **kw)
        torch.cuda.synchronize()
        scale = max(hp.float().abs().max().item(), 1.0)
        assert (hk.float() - hp.float()).abs().max().item() <= 2e-2 * scale, t
        assert (k1[:, t].float() - k2[:, t].float()).abs().max().item() <= 2e-2 * scale, t
        assert (v1[:, t].float() - v2[:, t].float()).abs().max().item() <= 2e-2 * scale, t
        assert int(tk[0]) == int(tp[0]), t
        return tp

    for i, t in enumerate(range(20, 26)):
        tok = step(i, t)
    rest = [s for s in range(S) if not 20 <= s < 26]
    assert torch.equal(k1[:, rest], k2[:, rest]) and torch.equal(v1[:, rest], v2[:, rest])
    slots = [off + n for n in (0, 1, 7, 220, S - 1 - off)]
    for i, t in enumerate(slots):
        # a single step each: it starts from the plain step's rows (those of the six steps too)
        k1.copy_(k2), v1.copy_(v2)
        tok = step(6 + i, t)
    written = set(range(20, 26)) | set(slots)
    rest = [s for s in range(S) if s not in written]
    assert torch.equal(k1[:, rest], k2[:, rest]) and torch.equal(v1[:, rest], v2[:, rest])
    assert getattr(decode_step.mega_decode_step, count) == n0 + 6 + len(slots)


def test_decode_step_scratch_planned_for_other_tensors_raises(cuda):
    """A scratch keeps the plan of its first step: other params (a tensor
    replaced inside the same dict too), another cache, a replaced buffer or
    other sampler settings raise instead of running on stale pointers; a
    scratch of the wrong shapes raises at its first step."""
    cfg = tiny_config().token_lm
    g = torch.Generator(device=cuda).manual_seed(8)
    lm = quantize_tree(token_lm.init_params(cfg, g))
    mp = token_lm.mega_decode_params(lm, cfg)
    L, N, S = cfg.n_layers, cfg.dim, 48
    k = torch.zeros((L, S, N), dtype=torch.bfloat16, device=cuda)
    v = torch.zeros_like(k)
    kw = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim, eps=cfg.norm_eps,
              pad_id=cfg.speech_pad, bos_id=cfg.speech_bos, eos_id=cfg.speech_eos)
    tok = torch.tensor([3], dtype=torch.int32, device=cuda)
    scratch = decode_step.decode_scratch(mp, cfg.n_heads, cfg.head_dim, cuda)
    decode_step.mega_decode_step(tok, mp, k, v, 5, 0, False, 1, scratch=scratch, **kw)
    decode_step.mega_decode_step(tok, mp, k, v, 6, 0, False, 2, scratch=scratch, **kw)   # same plan
    decode_step.mega_decode_step(tok, dict(mp), k, v, 6, 0, False, 2, scratch=scratch, **kw)   # same tensors
    n0 = decode_step.mega_decode_step.launches
    with pytest.raises(ValueError, match="planned for other"):
        decode_step.mega_decode_step(tok, dict(mp, wo=mp["wo"].clone()), k, v, 7, 0, False, 3,
                                     scratch=scratch, **kw)
    old = mp["wgu"]
    mp["wgu"] = old.clone()                 # replaced inside the dict the plan was made from
    with pytest.raises(ValueError, match="planned for other"):
        decode_step.mega_decode_step(tok, mp, k, v, 7, 0, False, 3, scratch=scratch, **kw)
    mp["wgu"] = old
    with pytest.raises(ValueError, match="planned for other"):
        decode_step.mega_decode_step(tok, mp, k.clone(), v, 7, 0, False, 3, scratch=scratch, **kw)
    with pytest.raises(ValueError, match="planned for other"):
        decode_step.mega_decode_step(tok, mp, k, v, 7, 0, False, 3, scratch=scratch,
                                     **dict(kw, greedy=False, top_k=5))
    old = scratch["act"]
    scratch["act"] = torch.empty_like(old)  # a buffer replaced after the first step
    with pytest.raises(ValueError, match="planned for other"):
        decode_step.mega_decode_step(tok, mp, k, v, 7, 0, False, 3, scratch=scratch, **kw)
    scratch["act"] = old
    with pytest.raises(ValueError, match="off"):
        decode_step.mega_decode_step(tok, mp, k, v, S, 0, False, 3, scratch=scratch, **kw)
    bad = decode_step.decode_scratch(mp, cfg.n_heads, cfg.head_dim, cuda)
    bad["part"] = bad["part"][:, :1].contiguous()
    with pytest.raises(ValueError, match="part"):
        decode_step.mega_decode_step(tok, mp, k, v, 7, 0, False, 3, scratch=bad, **kw)
    assert decode_step.mega_decode_step.launches == n0
    decode_step.mega_decode_step(tok, mp, k, v, 7, 0, False, 3, scratch=scratch, **kw)   # restored: runs
    torch.cuda.synchronize()


def test_half_layer_kernels_match_plain(cuda):
    """attn_step and mlp_step on one layer's views of the stacked weights:
    residual, new cache row, untouched rows, launch counts."""
    cfg = tiny_config().token_lm
    g = torch.Generator(device=cuda).manual_seed(3)
    lm = quantize_tree(token_lm.init_params(cfg, g))
    mp = token_lm.mega_decode_params(lm, cfg)
    layers = token_lm.unstack_decode_params(token_lm.share_decode_weights(lm, mp), cfg)
    assert layers[1]["wqkv"].data_ptr() == mp["wqkv"][1].data_ptr()   # views, no copy
    lw = layers[1]
    N, S, t, off = cfg.dim, 448, 321, 4     # 317 live slots: 14 splits
    k1 = (torch.randn((S, N), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    v1 = (torch.randn((S, N), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    k2, v2 = k1.clone(), v1.clone()
    h0 = (torch.randn((1, cfg.dim), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    kw = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim, eps=cfg.norm_eps)
    args = (lw["attn_norm"], lw["wqkv"], lw["wqs"], lw["wo"], lw["wos"], mp["invf"])
    na, nm = decode_step.attn_step.launches, decode_step.mlp_step.launches
    h = h0.clone()
    out = decode_step.attn_step(h, *args, k1, v1, t, off, **kw)
    assert out.data_ptr() == h.data_ptr()    # in place
    want = decode_step.attn_step_plain(h0, *args, k2, v2, t, off, **kw)
    torch.cuda.synchronize()
    scale = max(want.float().abs().max().item(), 1.0)
    assert (h.float() - want.float()).abs().max().item() <= 2e-2 * scale
    assert (k1[t].float() - k2[t].float()).abs().max().item() <= 2e-2 * scale
    assert (v1[t].float() - v2[t].float()).abs().max().item() <= 2e-2 * scale
    rest = [s for s in range(S) if s != t]
    assert torch.equal(k1[rest], k2[rest]) and torch.equal(v1[rest], v2[rest])
    margs = (lw["mlp_norm"], lw["wgu"], lw["wgus"], lw["wd"], lw["wds"])
    h = want.clone()
    decode_step.mlp_step(h, *margs, eps=cfg.norm_eps)
    want2 = decode_step.mlp_step_plain(want, *margs, eps=cfg.norm_eps)
    torch.cuda.synchronize()
    assert (h.float() - want2.float()).abs().max().item() <= 2e-2 * max(want2.float().abs().max().item(), 1.0)
    assert (decode_step.attn_step.launches, decode_step.mlp_step.launches) == (na + 1, nm + 1)


def test_half_layer_kernels_raise_on_wrong_layout(cuda):
    cfg = tiny_config().token_lm
    D = cfg.dim
    h = torch.zeros((1, D), dtype=torch.bfloat16, device=cuda)
    z = lambda *shape, dt=torch.float32: torch.zeros(shape, dtype=dt, device=cuda)
    kc = z(16, D, dt=torch.bfloat16)
    with pytest.raises(ValueError, match="wqkv"):   # input-major weight
        decode_step.attn_step(h, z(D), z(D, 3 * D, dt=torch.int8), z(3 * D), z(D, D, dt=torch.int8),
                              z(D), z(cfg.head_dim // 2), kc, kc.clone(), 3, 0,
                              n_heads=cfg.n_heads, head_dim=cfg.head_dim, eps=1e-5)
    with pytest.raises(ValueError, match="wgu"):
        decode_step.mlp_step(h, z(D), z(D, 2 * cfg.ffn_dim, dt=torch.int8), z(2 * cfg.ffn_dim),
                             z(D, cfg.ffn_dim, dt=torch.int8), z(D), eps=1e-5)


def test_generate_list_flavour_matches_mega_greedy(cuda):
    """On the card: the per-layer flavour and the decode-step flavour give
    the same greedy tokens over a short run."""
    from autostyle_tts_tpu_torch.ops.sampling import SamplerConfig

    cfg = tiny_config().token_lm
    g = torch.Generator(device=cuda).manual_seed(4)
    lm = quantize_tree(token_lm.init_params(cfg, g))
    mp = token_lm.mega_decode_params(lm, cfg)
    lm = token_lm.share_decode_weights(lm, mp)
    text = torch.randint(16, 200, (1, 10), generator=g, device=cuda).int()
    sty = torch.randint(0, 64, (1, 6), generator=g, device=cuda).int()
    spk = torch.randn((1, cfg.spk_dim), generator=g, device=cuda)
    ten, six = torch.tensor([10], device=cuda), torch.tensor([6], device=cuda)
    kw = dict(max_new_tokens=12, sampler=SamplerConfig(greedy=True))
    a = token_lm.generate_speech_from_ids(lm, cfg, text, ten, sty, six, spk, None, decode_params=mp, **kw)
    b = token_lm.generate_speech_from_ids(lm, cfg, text, ten, sty, six, spk, None,
                                          decode_params=token_lm.unstack_decode_params(lm, cfg), **kw)
    assert a.tokens.tolist() == b.tokens.tolist()


@pytest.mark.parametrize("B,T,win,n_fft,sr", [(2, 401, 400, 400, 16000), (2, 201, 1024, 1024, 24000),
                                              (1, 13, 64, 64, 1600), (3, 130, 80, 128, 2400)])
def test_fused_log_mel_kernel_matches_plain(cuda, B, T, win, n_fft, sr):
    g = torch.Generator(device=cuda).manual_seed(5)
    frames = torch.randn((B, T, win), generator=g, device=cuda) * 0.1
    cos_b, sin_b = stft._dft_basis_on(cuda, n_fft, win)
    fb = stft._mel_filterbank_on(cuda, sr, n_fft, 80, 0.0, None)
    n0 = fused_log_mel.launches
    got = fused_log_mel(frames, cos_b, sin_b, fb)
    assert fused_log_mel.launches == n0 + 1
    want = fused_log_mel_plain(frames, cos_b, sin_b, fb)
    torch.cuda.synchronize()
    assert got.shape == (B, T, 80) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 1e-3


def test_log_mel_spectrogram_on_card_launches_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((2, 16000), generator=g, device=cuda) * 0.1
    n0 = fused_log_mel.launches
    got = stft.log_mel_spectrogram(x, 16000, 400, 160, 400, n_mels=80, fmax=8000.0)
    assert fused_log_mel.launches == n0 + 1
    want = stft.log_mel_spectrogram(x.cpu(), 16000, 400, 160, 400, n_mels=80, fmax=8000.0)
    assert got.shape == (2, 101, 80)
    assert (got.cpu() - want).abs().max().item() <= 1e-3


def test_fused_log_mel_raises_beyond_shared_memory(cuda):
    """The window is walked in stages, so its length is not bounded by
    shared memory any more: 4096 samples run. What the kernel refuses is a
    filterbank too wide for its shared-memory tile, and other types."""
    g = torch.Generator(device=cuda).manual_seed(8)
    frames = torch.randn((1, 4, 4096), generator=g, device=cuda) * 0.1
    cos_b, sin_b = stft._dft_basis_on(cuda, 4096, 4096)
    fb = stft._mel_filterbank_on(cuda, 16000, 4096, 80, 0.0, None)
    got = fused_log_mel(frames, cos_b, sin_b, fb)
    torch.cuda.synchronize()
    assert (got - fused_log_mel_plain(frames, cos_b, sin_b, fb)).abs().max().item() <= 1e-3
    with pytest.raises(ValueError, match="n_mels"):
        fused_log_mel(frames, cos_b, sin_b, torch.zeros((2049, 240), device=cuda))
    wide = stft._mel_filterbank_on(cuda, 16000, 4096, 232, 0.0, None)       # the widest it takes
    got = fused_log_mel(frames, cos_b, sin_b, wide)
    torch.cuda.synchronize()
    assert (got - fused_log_mel_plain(frames, cos_b, sin_b, wide)).abs().max().item() <= 1e-3
    with pytest.raises(ValueError, match="f32"):
        fused_log_mel(frames.double(), cos_b, sin_b, fb)


def _tonal_frames(cuda, sr, n_fft, hop, win, offset=0):
    """Two tonal 0.75 s prompts zero-tailed to 1 s, reflect-padded: the
    strided frames (``offset`` moves the base off a 16-byte address)."""
    n = sr
    t = torch.arange(3 * n // 4, device=cuda) / sr
    x = torch.zeros((2, n), device=cuda)
    for i, f0 in enumerate((220.0, 1330.0)):
        x[i, : 3 * n // 4] = 0.3 * torch.sin(2 * torch.pi * f0 * t) + 0.1 * torch.sin(2 * torch.pi * 3.7 * f0 * t)
    x = stft._reflect_pad(x, n_fft // 2)
    if offset:
        x = torch.cat([x.new_zeros((2, offset)), x], dim=1)[:, offset:]
    return stft.frame_signal(x, win, hop)


@pytest.mark.parametrize("sr,n_fft,hop,win,offset", [
    (16000, 400, 160, 400, 0), (24000, 1024, 480, 1024, 0),
    (16000, 400, 160, 400, 1),       # base not on a 16-byte address: the 4-byte loads
    (1600, 64, 37, 50, 0),           # hop and window no multiples of 4
])
def test_fused_log_mel_strided_tonal_frames(cuda, sr, n_fft, hop, win, offset):
    frames = _tonal_frames(cuda, sr, n_fft, hop, win, offset)
    assert not frames.is_contiguous() and frames.stride(1) == hop
    assert (frames.data_ptr() % 16 == 0) == (offset == 0)
    cos_b, sin_b = stft._dft_basis_on(cuda, n_fft, win)
    fb = stft._mel_filterbank_on(cuda, sr, n_fft, 80, 0.0, None)
    n0 = fused_log_mel.launches
    got = fused_log_mel(frames, cos_b, sin_b, fb)
    again = fused_log_mel(frames, cos_b, sin_b, fb)
    on_copy = fused_log_mel(frames.contiguous(), cos_b, sin_b, fb)
    assert fused_log_mel.launches == n0 + 3
    want = fused_log_mel_plain(frames, cos_b, sin_b, fb)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-3
    assert torch.equal(got, again) and torch.equal(got, on_copy)     # same bits, whatever the strides
    silent = frames.abs().amax(-1) == 0
    assert int(silent.sum()) > 0
    assert bool((got[silent] == torch.log(torch.tensor(1e-5, device=cuda))).all())


def test_fused_log_mel_odd_mel_count_and_many_tiles(cuda):
    """A filterbank whose rows are not 16-byte multiples (n_mels = 13), more
    row tiles than the first scratch holds, and a call on another stream."""
    g = torch.Generator(device=cuda).manual_seed(9)
    frames = torch.randn((3, 700, 80), generator=g, device=cuda) * 0.1
    cos_b, sin_b = stft._dft_basis_on(cuda, 128, 80)
    fb = stft._mel_filterbank_on(cuda, 2400, 128, 13, 0.0, None)
    want = fused_log_mel_plain(frames, cos_b, sin_b, fb)
    got = fused_log_mel(frames, cos_b, sin_b, fb)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got_side = fused_log_mel(frames, cos_b, sin_b, fb)
    torch.cuda.synchronize()
    assert got.shape == (3, 700, 13) and (got - want).abs().max().item() <= 1e-3
    assert torch.equal(got, got_side)


def test_decode_step_scratch_reuse_matches_fresh(cuda):
    """The decode loop's pattern: one scratch for every step, the returned
    token fed back as the next step's input. Same tokens and cache as
    fresh buffers per step."""
    cfg = tiny_config().token_lm
    g = torch.Generator(device=cuda).manual_seed(2)
    mp = token_lm.mega_decode_params(quantize_tree(token_lm.init_params(cfg, g)), cfg)
    L, N, S, off = cfg.n_layers, cfg.dim, 48, 4
    k1 = (torch.randn((L, S, N), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    v1 = (torch.randn((L, S, N), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    k2, v2 = k1.clone(), v1.clone()
    kw = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim, eps=cfg.norm_eps,
              pad_id=cfg.speech_pad, bos_id=cfg.speech_bos, eos_id=cfg.speech_eos,
              greedy=False, temperature=0.8, top_k=5)
    scratch = decode_step.decode_scratch(mp, cfg.n_heads, cfg.head_dim, cuda)
    tok_shared = torch.tensor([3], dtype=torch.int32, device=cuda)
    tok_fresh = tok_shared.clone()
    for i, t in enumerate(range(20, 26)):
        _, tok_shared = decode_step.mega_decode_step(tok_shared, mp, k1, v1, t, off, False, 5 + i,
                                                     scratch=scratch, **kw)
        _, tok_fresh = decode_step.mega_decode_step(tok_fresh, mp, k2, v2, t, off, False, 5 + i, **kw)
        assert tok_shared.data_ptr() == scratch["tok"].data_ptr()
        assert int(tok_shared[0]) == int(tok_fresh[0])
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


def test_decode_step_stamps_cover_every_barrier(cuda):
    """``decode_scratch(..., stamps=True)``: every block of the step's
    kernel leaves an arrival and a later leave time at each of its 5 L + 2
    grid barriers, nobody leaves a barrier before the last block arrived,
    and the slot after them holds the step's end."""
    cfg = tiny_config().token_lm
    g = torch.Generator(device=cuda).manual_seed(9)
    mp = token_lm.mega_decode_params(quantize_tree(token_lm.init_params(cfg, g)), cfg)
    L, N, S = cfg.n_layers, cfg.dim, 48
    k = (torch.randn((L, S, N), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    v = k.clone()
    scratch = decode_step.decode_scratch(mp, cfg.n_heads, cfg.head_dim, cuda, stamps=True)
    tok = torch.tensor([3], dtype=torch.int32, device=cuda)
    decode_step.mega_decode_step(tok, mp, k, v, 30, 4, False, 1, n_heads=cfg.n_heads, head_dim=cfg.head_dim,
                                 eps=cfg.norm_eps, pad_id=cfg.speech_pad, bos_id=cfg.speech_bos,
                                 eos_id=cfg.speech_eos, scratch=scratch)
    torch.cuda.synchronize()
    st = scratch["stamps"].cpu()
    n_bar = 5 * L + 2
    assert st.shape[0] == n_bar + 1 and st.shape[2] == 2
    arrive, leave = st[:n_bar, :, 0], st[:n_bar, :, 1]
    assert bool((arrive > 0).all()) and bool((leave >= arrive).all())
    assert bool((leave.min(dim=1).values >= arrive.max(dim=1).values).all())
    assert bool((arrive[1:] >= leave[:-1]).all()) and bool((st[n_bar, :, 0] >= leave[-1]).all())


@pytest.mark.parametrize("quant,kv_int8,kv_heads", [(False, False, 4), (True, True, 2)])
def test_scanned_decode_on_card_matches_cpu(cuda, quant, kv_int8, kv_heads):
    """The scanned decode, B=2 rows of different prefix lengths, greedy: the
    card (the flash kernel in the prefill, cuBLAS products with TF32 off)
    gives the CPU's plain run's tokens over 16 steps on the same weights."""
    cfg = dataclasses.replace(tiny_config().token_lm, n_kv_heads=kv_heads)
    lm = token_lm.init_params(cfg, torch.Generator().manual_seed(2))
    if quant:
        lm = quantize_tree(lm)
    g = torch.Generator().manual_seed(3)
    inputs = (torch.randint(16, 200, (2, 12), generator=g, dtype=torch.int32), torch.tensor([12, 7]),
              torch.randint(0, 64, (2, 8), generator=g, dtype=torch.int32), torch.tensor([8, 3]),
              torch.randn((2, cfg.spk_dim), generator=g))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = []
        for dev in ("cpu", cuda):
            params = weights_to(lm, dev)
            out = token_lm.generate_speech_from_ids(
                params, cfg, *[t.to(dev) for t in inputs], None, max_new_tokens=16,
                sampler=SamplerConfig(greedy=True), kv_int8=kv_int8, min_tokens=16)
            runs.append((out.tokens.cpu(), out.lengths.cpu()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("kernel,stride", [(10, 5), (8, 4), (6, 3), (4, 2)])
def test_conv_transpose1d_on_card_matches_cpu(cuda, kernel, stride):
    g = torch.Generator().manual_seed(kernel)
    p = conv.conv_transpose1d_init(g, 64, 32, kernel)
    x = torch.randn((2, 250, 64), generator=g)
    want = conv.conv_transpose1d(x, p, stride=stride, kernel=kernel)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = conv.conv_transpose1d(x.to(cuda), weights_to(p, cuda), stride=stride, kernel=kernel)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert got.shape == want.shape == (2, 250 * stride, 32)
    assert (got.cpu() - want).abs().max().item() <= 1e-4


def test_streamed_tokens_equal_unstreamed_through_the_decode_kernel(cuda):
    """An int8 H = K engine on the card: one request unstreamed, then
    streamed from the same generator state, both on the decode kernel; the
    same tokens and a joined stream as long as the wav."""
    cfg = tiny_config()
    cfg.quantize_lm_int8 = True
    eng = Engine(cfg, seed=4, device=cuda)
    assert eng._mega_params is not None
    seen, start = [], token_lm.start_decode

    def recording(*a, **k):
        loop = start(*a, **k)

        def run():
            gen = yield from loop
            seen.append(gen)
            return gen

        return run()

    g = torch.Generator().manual_seed(5)
    feat = PromptFeatures(tokens=torch.randint(0, 64, (40,), generator=g).numpy().astype("int32"),
                          spk=torch.randn((cfg.speaker.emb_dim,), generator=g).numpy(),
                          mel24=torch.randn((80, cfg.cfm.n_mels), generator=g).numpy())
    token_lm.start_decode = recording
    try:
        state = eng.generator.get_state()
        n0 = decode_step.mega_decode_step.launches
        wav = next(eng.inference_tts_with_st("one request, two ways", "style", feat, feat, max_seconds=2.0))
        n1 = decode_step.mega_decode_step.launches
        eng.generator.set_state(state)
        chunks = [c["tts_speech"] for c in eng.inference_tts_with_st(
            "one request, two ways", "style", feat, feat, stream=True, max_seconds=2.0)]
    finally:
        token_lm.start_decode = start
    assert n1 > n0 and decode_step.mega_decode_step.launches - n1 == n1 - n0
    assert len(seen) == 2 and torch.equal(seen[0].tokens, seen[1].tokens)
    assert sum(c.shape[1] for c in chunks) == wav["tts_speech"].shape[1] and len(chunks) > 1


def test_admission_prefill_flash_matches_plain(cuda):
    """``prefill_prefix`` of four prefixes padded to T = 384 (a continuous
    batch's admission), each row its own offset: the flash kernel on every
    layer's inputs against the plain attention, over the real rows."""
    cfg = tiny_config().token_lm
    lm = weights_to(quantize_tree(token_lm.init_params(cfg, torch.Generator().manual_seed(2))), cuda)
    g = torch.Generator().manual_seed(3)
    t_len, s_len = torch.tensor([40, 7, 120, 1]), torch.tensor([64, 30, 0, 128])
    pre = token_lm.build_prefix_padded(
        lm, cfg, torch.randint(16, 200, (4, 120), generator=g, dtype=torch.int32).to(cuda), t_len.to(cuda),
        torch.randint(0, 64, (4, 128), generator=g, dtype=torch.int32).to(cuda), s_len.to(cuda),
        torch.randn((4, cfg.spk_dim), generator=g).to(cuda), pad_multiple=384)
    assert pre.embeds.shape[:2] == (4, 384)
    calls, flash = [], transformer.flash_attention

    def record(q, k, v, offset):
        calls.append(tuple(t.clone() for t in (q, k, v, offset)))
        return flash(q, k, v, offset)

    n0 = flash_attention.launches
    transformer.flash_attention = record
    try:
        token_lm.prefill_prefix(lm, cfg, pre, s_max=384 + 64, kv_int8=True)
    finally:
        transformer.flash_attention = flash
    assert flash_attention.launches - n0 == len(calls) == cfg.n_layers
    for q, k, v, off in calls:
        assert sorted(off.tolist()) == sorted((384 - (2 + t_len + s_len)).tolist())
        got, want = flash_attention(q, k, v, off), flash_attention_plain(q, k, v, off)
        real = (torch.arange(384, device=cuda)[None, :] >= off[:, None].long())[:, :, None, None]
        assert ((got.float() - want.float()).abs() * real).max().item() <= 2e-2


@pytest.mark.parametrize("B,T,offsets", [
    (16, 512, [0] * 16),                         # an embed batch: right-padded rows, offset 0
    (2, 1024, [700, 905]),                       # a biography prefill, left-padded
    (8, 512, [300, 310, 290, 305, 280, 315, 299, 301]),   # label prefills
    (4, 768, [400, 512, 380, 450]),
])
def test_flash_kernel_matches_plain_at_embedder_shapes(cuda, B, T, offsets):
    """The embedder's GQA 24:8 at head width 128: against the plain version
    on the real rows, and finite on every row (the embed batch's pad rows
    are multiplied by 0 in the mean-pool)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((B, T, 24, 128), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((B, T, 8, 128), generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn((B, T, 8, 128), generator=g, device=cuda).to(torch.bfloat16)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, off)
    assert flash_attention.launches == n0 + 1
    want = flash_attention_plain(q, k, v, off)
    real = (torch.arange(T, device=cuda)[None, :] >= off[:, None].long())[:, :, None, None]
    assert ((got.float() - want.float()).abs() * real).max().item() <= 2e-2
    assert bool(torch.isfinite(got).all())


def test_embed_on_card_matches_cpu(cuda):
    """One ``EmbedderService.embed`` on the card (flash at hd = 128, int8
    base, a LoRA adapter with a non-zero b) against the CPU port on the
    same weights."""
    from autostyle_tts_tpu_torch.pipeline.rag import EmbedderService
    from autostyle_tts_tpu_torch.utils.config import TransformerConfig

    cfg = TransformerConfig(vocab_size=300, dim=256, n_layers=2, n_heads=2, n_kv_heads=1, ffn_dim=512,
                            max_seq_len=1024)
    gen = torch.Generator().manual_seed(6)
    params = transformer.init_params_quantized(cfg, rng.PRNGKey(6))
    lora = transformer.init_lora(cfg, 8, rng.PRNGKey(7))
    lora["layers"] = {k: (v + 0.02 * torch.randn(v.shape, generator=gen)) if k.endswith("_b") else v
                      for k, v in lora["layers"].items()}
    texts = ["hello world", "a longer line of text to embed on the card", "你好"]
    n0 = flash_attention.launches
    got = EmbedderService(cfg, params, lora=lora, lora_scale=4.0).embed(texts)
    assert flash_attention.launches - n0 == cfg.n_layers
    want = EmbedderService(cfg, params, lora=lora, lora_scale=4.0, device="cpu").embed(texts)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def _grad_guard_calls(dev):
    """Each kernel wrapper on card tensors, one input requiring grad; the
    guard raises before any shape or layout check."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, 64, 4, 64), generator=g, device=dev).to(torch.bfloat16).requires_grad_(True)
    off = torch.zeros(1, dtype=torch.int32, device=dev)
    yield "flash_attention", lambda: flash_attention(x, x.detach(), x.detach(), off)
    frames = torch.randn((1, 8, 64), generator=g, device=dev).requires_grad_(True)
    basis = torch.randn((64, 33), device=dev)
    yield "fused_log_mel", lambda: fused_log_mel(frames, basis, basis, torch.rand((33, 8), device=dev))
    h = torch.randn((1, 64), device=dev).to(torch.bfloat16).requires_grad_(True)
    yield "attn_step", lambda: decode_step.attn_step(h, *([h.detach()] * 8), 1, 0, n_heads=1, head_dim=64, eps=1e-5)
    yield "mlp_step", lambda: decode_step.mlp_step(h, *([h.detach()] * 5), eps=1e-5)
    yield "mega_decode_step", lambda: decode_step.mega_decode_step(
        off, {"emb": h}, h.detach(), h.detach(), 0, 0, False, 0, n_heads=1, head_dim=64, eps=1e-5, pad_id=0,
        bos_id=1, eos_id=2)


def test_kernel_wrappers_refuse_grad_on_card(cuda):
    counts = (flash_attention.launches, fused_log_mel.launches, decode_step.mega_decode_step.launches)
    for name, call in _grad_guard_calls(cuda):
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            call()
    assert (flash_attention.launches, fused_log_mel.launches, decode_step.mega_decode_step.launches) == counts
    # under no_grad the attention and the log-mel launch as always
    calls = dict(_grad_guard_calls(cuda))
    with torch.no_grad():
        calls["flash_attention"]()
        calls["fused_log_mel"]()
    assert flash_attention.launches == counts[0] + 1 and fused_log_mel.launches == counts[1] + 1


def test_vocoder_mel_loss_gradient_on_card_matches_cpu(cuda):
    """The mel term of the vocoder loss differentiates on the card (the plain
    spectrogram, not the kernel, whose wrapper would refuse it): its gradient
    is nonzero and within 1e-3 of the CPU's largest component."""
    from autostyle_tts_tpu_torch.models import vocoder

    cfg = tiny_config()
    a = cfg.audio
    t = torch.arange(1600) / a.sample_rate
    wav = (0.4 * torch.sin(2 * np.pi * 220 * t))[None].repeat(2, 1)
    pred = wav.flip(-1) * 0.7
    grads = {}
    for dev in ("cpu", cuda):
        p = pred.to(dev).clone().requires_grad_(True)
        n0 = fused_log_mel.launches
        loss = vocoder.mel_l1_loss(p, wav.to(dev), a.sample_rate, a.n_fft, a.hop_length, cfg.vocoder.n_mels)
        loss.backward()
        assert fused_log_mel.launches == n0
        grads[str(dev)] = p.grad.cpu()
    g_cpu = grads["cpu"]
    assert float(g_cpu.abs().max()) > 0
    assert float((grads[str(cuda)] - g_cpu).abs().max()) <= 1e-3 * float(g_cpu.abs().max())
