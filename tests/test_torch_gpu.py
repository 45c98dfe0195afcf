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
the scanned decode's greedy tokens equal to the CPU run's; its captured
step's replays the eager step's tokens and logits within 1e-5 of their
largest value at flagship widths (int8, the int4 engine's int8 views and
packed int4), two interleaved loops each their own run's; the transposed
conv within 1e-4 of the CPU's (cuDNN, TF32 off); a streamed request's
tokens equal to the same request's unstreamed, through the decode kernel;
a stream's windows replayed from a kept graph equal to the eager render
(the same kernels on the same inputs), chunk by chunk, also for two
scheduler sessions replayed in turns (and a mel context left as a view of
the graph's output caught there), with no sync inside a replayed window
but the clock's; an eight-slot scheduler over two prompt widths replaying
after one warm-up, each chunk equal to the warm-up's and within 2e-3 of
the eager render's (which runs B rows where the graph runs the next row
count: another GEMM shape);
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
import time

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


@pytest.mark.parametrize("vocab", [8185, 8192])
@pytest.mark.parametrize("bits", [8, 4])
def test_decode_step_kernel_at_the_widest_vocabulary(cuda, bits, vocab):
    """Beyond one head unit a block (more lists than SMs): every block keeps
    a list for each of its units and one warp merges them all; 8185 leaves
    int4 a unit of one row-group and a tail of 9 rows. The kernel's logits
    against the plain head on its own residual, its token against the
    plain sampler on its own logits (greedy, top-k 25 and top-k 200, which
    reaches past the lists' first levels), its residual against the plain
    step's."""
    cfg = dataclasses.replace(tiny_config().token_lm, speech_vocab_size=vocab)
    g = torch.Generator(device=cuda).manual_seed(2)
    mp = token_lm.mega_decode_params(quantize_tree(token_lm.init_params(cfg, g)), cfg, bits=bits)
    mp_plain = decode_step.unpack_decode_params(mp)
    L, N, S, off, t = cfg.n_layers, cfg.dim, 64, 2, 40
    k1 = (torch.randn((L, S, N), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    v1 = (torch.randn((L, S, N), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    tok = torch.tensor([5], dtype=torch.int32, device=cuda)
    ids = dict(pad_id=cfg.speech_pad, bos_id=cfg.speech_bos, eos_id=cfg.speech_eos)
    for i, skw in enumerate((dict(greedy=True), dict(greedy=False, temperature=0.8, top_k=25),
                             dict(greedy=False, temperature=1.3, top_k=200))):
        skw = {"temperature": 1.0, "top_k": 0, **skw}
        scratch = decode_step.decode_scratch(mp, cfg.n_heads, cfg.head_dim, cuda)
        k2, v2 = k1.clone(), v1.clone()
        hk, tk = decode_step.mega_decode_step(tok, mp, k1, v1, t, off, i == 0, 31 + i, n_heads=cfg.n_heads,
                                              head_dim=cfg.head_dim, eps=cfg.norm_eps, **ids, **skw,
                                              scratch=scratch)
        hp, _ = decode_step.mega_decode_step_plain(tok, mp_plain, k2, v2, t, off, i == 0, 31 + i,
                                                   n_heads=cfg.n_heads, head_dim=cfg.head_dim,
                                                   eps=cfg.norm_eps, **ids, **skw)
        torch.cuda.synchronize()
        assert (hk.float() - hp.float()).abs().max().item() <= 2e-2 * max(hp.float().abs().max().item(), 1.0)
        logits = scratch["logits"]
        assert (logits - decode_step.head_logits_plain(hk, mp_plain, cfg.norm_eps)).abs().max().item() <= 1e-4
        want = decode_step.sample_plain(logits, suppress=i == 0, seed=31 + i, **ids, **skw)
        assert int(tk[0]) == want, skw


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
    old = scratch["actx"]
    scratch["actx"] = torch.zeros_like(old)  # a buffer replaced after the first step
    with pytest.raises(ValueError, match="planned for other"):
        decode_step.mega_decode_step(tok, mp, k, v, 7, 0, False, 3, scratch=scratch, **kw)
    scratch["actx"] = old
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


def test_half_layer_kernels_match_plain_int4(cuda):
    """attn_step and mlp_step on one layer's int4 rows (pack4's fragment
    order: the tensor-core GEMVs) against their plain versions on the
    unpacked rows: residual, new cache row, untouched rows, launches."""
    cfg = tiny_config().token_lm
    g = torch.Generator(device=cuda).manual_seed(5)
    mp = token_lm.mega_decode_params(quantize_tree(token_lm.init_params(cfg, g)), cfg, bits=4)
    N, S, t, off = cfg.dim, 448, 321, 4
    k1 = (torch.randn((S, N), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    v1 = (torch.randn((S, N), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    k2, v2 = k1.clone(), v1.clone()
    h0 = (torch.randn((1, cfg.dim), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    kw = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim, eps=cfg.norm_eps)
    u = decode_step.unpack4
    na, nm = decode_step.attn_step.launches, decode_step.mlp_step.launches
    h = h0.clone()
    decode_step.attn_step(h, mp["attn_norm"][1], mp["wqkv"][1], mp["wqs"][1], mp["wo"][1], mp["wos"][1],
                          mp["invf"], k1, v1, t, off, **kw)
    want = decode_step.attn_step_plain(h0, mp["attn_norm"][1], u(mp["wqkv"][1]), mp["wqs"][1], u(mp["wo"][1]),
                                       mp["wos"][1], mp["invf"], k2, v2, t, off, **kw)
    torch.cuda.synchronize()
    scale = max(want.float().abs().max().item(), 1.0)
    assert (h.float() - want.float()).abs().max().item() <= 2e-2 * scale
    assert (k1[t].float() - k2[t].float()).abs().max().item() <= 2e-2 * scale
    rest = [s_ for s_ in range(S) if s_ != t]
    assert torch.equal(k1[rest], k2[rest]) and torch.equal(v1[rest], v2[rest])
    h = want.clone()
    decode_step.mlp_step(h, mp["mlp_norm"][1], mp["wgu"][1], mp["wgus"][1], mp["wd"][1], mp["wds"][1],
                         eps=cfg.norm_eps)
    want2 = decode_step.mlp_step_plain(want, mp["mlp_norm"][1], u(mp["wgu"][1]), mp["wgus"][1], u(mp["wd"][1]),
                                       mp["wds"][1], eps=cfg.norm_eps)
    torch.cuda.synchronize()
    assert (h.float() - want2.float()).abs().max().item() <= 2e-2 * max(want2.float().abs().max().item(), 1.0)
    assert (decode_step.attn_step.launches, decode_step.mlp_step.launches) == (na + 1, nm + 1)


def test_int4_kernels_at_widths_32_mod_64(cuda):
    """D = N = 96 and F = 160: every row-group of the int4 rows ends with a
    half tile (two k-steps). The step, greedy and sampled, against the plain
    step on the unpacked rows (residual, cache row, logits on its own
    residual, the token on its own logits); the half-layers against theirs."""
    cfg = dataclasses.replace(tiny_config().token_lm, dim=96, n_heads=3, n_kv_heads=3, ffn_dim=160)
    assert decode_step.step_serves(dim=96, n_heads=3, n_kv_heads=3, head_dim=cfg.head_dim, ffn_dim=160,
                                   vocab=cfg.speech_vocab_size, bits=4)
    g = torch.Generator(device=cuda).manual_seed(6)
    mp = token_lm.mega_decode_params(quantize_tree(token_lm.init_params(cfg, g)), cfg, bits=4)
    mp_plain = decode_step.unpack_decode_params(mp)
    L, N, S, off, t = cfg.n_layers, cfg.dim, 64, 3, 41
    k1 = (torch.randn((L, S, N), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    v1 = (torch.randn((L, S, N), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    tok = torch.tensor([9], dtype=torch.int32, device=cuda)
    kw = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim, eps=cfg.norm_eps)
    ids = dict(pad_id=cfg.speech_pad, bos_id=cfg.speech_bos, eos_id=cfg.speech_eos)
    for i, skw in enumerate((dict(greedy=True, temperature=1.0, top_k=0),
                             dict(greedy=False, temperature=0.8, top_k=5))):
        scratch = decode_step.decode_scratch(mp, cfg.n_heads, cfg.head_dim, cuda)
        k2, v2 = k1.clone(), v1.clone()
        hk, tk = decode_step.mega_decode_step(tok, mp, k1, v1, t, off, i == 0, 50 + i, **kw, **ids, **skw,
                                              scratch=scratch)
        hp, _ = decode_step.mega_decode_step_plain(tok, mp_plain, k2, v2, t, off, i == 0, 50 + i, **kw, **ids, **skw)
        torch.cuda.synchronize()
        scale = max(hp.float().abs().max().item(), 1.0)
        assert (hk.float() - hp.float()).abs().max().item() <= 2e-2 * scale
        assert (k1[:, t].float() - k2[:, t].float()).abs().max().item() <= 2e-2 * scale
        logits = scratch["logits"]
        assert (logits - decode_step.head_logits_plain(hk, mp_plain, cfg.norm_eps)).abs().max().item() <= 1e-4
        assert int(tk[0]) == decode_step.sample_plain(logits, suppress=i == 0, seed=50 + i, **ids, **skw)
    u = decode_step.unpack4
    h0 = (torch.randn((1, cfg.dim), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    ka, va = k1[1].clone(), v1[1].clone()
    kb, vb = ka.clone(), va.clone()
    h = h0.clone()
    decode_step.attn_step(h, mp["attn_norm"][1], mp["wqkv"][1], mp["wqs"][1], mp["wo"][1], mp["wos"][1],
                          mp["invf"], ka, va, t, off, **kw)
    want = decode_step.attn_step_plain(h0, mp["attn_norm"][1], u(mp["wqkv"][1]), mp["wqs"][1], u(mp["wo"][1]),
                                       mp["wos"][1], mp["invf"], kb, vb, t, off, **kw)
    torch.cuda.synchronize()
    assert (h.float() - want.float()).abs().max().item() <= 2e-2 * max(want.float().abs().max().item(), 1.0)
    h = want.clone()
    decode_step.mlp_step(h, mp["mlp_norm"][1], mp["wgu"][1], mp["wgus"][1], mp["wd"][1], mp["wds"][1],
                         eps=cfg.norm_eps)
    want2 = decode_step.mlp_step_plain(want, mp["mlp_norm"][1], u(mp["wgu"][1]), mp["wgus"][1], u(mp["wd"][1]),
                                       mp["wds"][1], eps=cfg.norm_eps)
    torch.cuda.synchronize()
    assert (h.float() - want2.float()).abs().max().item() <= 2e-2 * max(want2.float().abs().max().item(), 1.0)


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


def _half_layer_lm(cuda, bits, seed):
    """A tiny LM's decode params at ``bits`` (the plain half-layers take
    the unpacked int4 rows), its per-layer views and caches with live rows."""
    cfg = tiny_config().token_lm
    g = torch.Generator(device=cuda).manual_seed(seed)
    mp = token_lm.mega_decode_params(quantize_tree(token_lm.init_params(cfg, g)), cfg, bits=bits)
    layers = [{k: mp[k][l] for k in decode_step.ATTN_KEYS + decode_step.MLP_KEYS} for l in range(cfg.n_layers)]
    L, N, S = cfg.n_layers, cfg.dim, 96
    k = (torch.randn((L, S, N), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    v = (torch.randn((L, S, N), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    return cfg, g, mp, layers, k, v


def _plain_layer(lw, bits):
    u = decode_step.unpack4 if bits == 4 else (lambda w: w)
    return ([u(lw[k]) if k in ("wqkv", "wo") else lw[k] for k in decode_step.ATTN_KEYS],
            [u(lw[k]) if k in ("wgu", "wd") else lw[k] for k in decode_step.MLP_KEYS])


def _close(got, want):
    return (got.float() - want.float()).abs().max().item() <= 2e-2 * max(want.float().abs().max().item(), 1.0)


@pytest.mark.parametrize("bits", [8, 4])
def test_half_layers_many_calls_on_one_scratch_match_plain(cuda, bits):
    """Many successive half-layer calls on one scratch, every layer in turn
    over 20 tokens (each call's tags counted from the scratch's own count
    of calls, never a word of the call before), each against its plain
    version from the kernel's own input: the residual, the cache row t,
    the rows it must not touch."""
    cfg, g, mp, layers, k1, v1 = _half_layer_lm(cuda, bits, 11)
    k2, v2 = k1.clone(), v1.clone()
    kw = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim, eps=cfg.norm_eps)
    h = torch.empty((1, cfg.dim), dtype=torch.bfloat16, device=cuda)
    scratch = decode_step.half_layer_scratch(cfg.dim, cfg.n_heads, cfg.head_dim, cfg.ffn_dim, cuda)
    plan = decode_step.plan_half_layers(h, layers, mp["invf"], k1, v1, scratch=scratch, **kw)
    plain = [_plain_layer(lw, bits) for lw in layers]
    na, nm = decode_step.attn_step.launches, decode_step.mlp_step.launches
    off, tokens = 5, 20
    for i in range(tokens):
        t = 40 + i
        h.copy_((torch.randn((1, cfg.dim), generator=g, device=cuda) * 0.5).to(torch.bfloat16))
        for l in range(cfg.n_layers):
            h0 = h.clone()
            decode_step.attn_step_planned(plan, l, t, off)
            want = decode_step.attn_step_plain(h0, *plain[l][0], mp["invf"], k2[l], v2[l], t, off, **kw)
            torch.cuda.synchronize()
            assert _close(h, want) and _close(k1[l, t], k2[l, t]) and _close(v1[l, t], v2[l, t])
            k2[l, t], v2[l, t] = k1[l, t], v1[l, t]      # the next token attends to the kernel's rows
            h0 = h.clone()
            decode_step.mlp_step_planned(plan, l)
            want = decode_step.mlp_step_plain(h0, *plain[l][1], eps=cfg.norm_eps)
            torch.cuda.synchronize()
            assert _close(h, want)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)     # nothing outside the rows written
    n = tokens * cfg.n_layers
    assert (decode_step.attn_step.launches, decode_step.mlp_step.launches) == (na + n, nm + n)
    assert int(scratch["bar"][3]) == n and int(scratch["bar"][4]) == n   # each half's count of calls
    assert int(scratch["bar"][5]) == 0 and int(scratch["bar"][6]) == 0   # grid counter and ticket left at 0


@pytest.mark.parametrize("bits", [8, 4])
def test_half_layers_interleaved_with_decode_steps_on_a_shared_scratch(cuda, bits):
    """The repeated-tag hazard: decode steps and half-layer calls (planned
    and public) take turns on one decode scratch, whose q, k, v and
    activation words both write. The steps give the tokens, residuals and
    caches of steps on a scratch of their own, bit for bit; each
    half-layer call matches its plain version."""
    cfg, g, mp, layers, k_step, v_step = _half_layer_lm(cuda, bits, 12)
    k_ref, v_ref = k_step.clone(), v_step.clone()
    k_half, v_half = k_step.clone(), v_step.clone()
    kw = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim, eps=cfg.norm_eps)
    skw = dict(pad_id=cfg.speech_pad, bos_id=cfg.speech_bos, eos_id=cfg.speech_eos, greedy=False,
               temperature=0.8, top_k=5)
    shared = decode_step.decode_scratch(mp, cfg.n_heads, cfg.head_dim, cuda)
    own = decode_step.decode_scratch(mp, cfg.n_heads, cfg.head_dim, cuda)
    h = torch.empty((1, cfg.dim), dtype=torch.bfloat16, device=cuda)
    plan = decode_step.plan_half_layers(h, layers, mp["invf"], k_half, v_half, scratch=shared, **kw)
    plain = [_plain_layer(lw, bits) for lw in layers]
    tok_a = tok_b = torch.tensor([3], dtype=torch.int32, device=cuda)
    off = 4
    for i in range(12):
        t = 30 + i
        ha, tok_a = decode_step.mega_decode_step(tok_a, mp, k_step, v_step, t, off, False, 9 + i,
                                                 scratch=shared, **kw, **skw)
        hb, tok_b = decode_step.mega_decode_step(tok_b, mp, k_ref, v_ref, t, off, False, 9 + i,
                                                 scratch=own, **kw, **skw)
        torch.cuda.synchronize()
        assert int(tok_a[0]) == int(tok_b[0]) and torch.equal(ha, hb)
        for l in range(cfg.n_layers):
            h.copy_((torch.randn((1, cfg.dim), generator=g, device=cuda) * 0.5).to(torch.bfloat16))
            h0, kp, vp = h.clone(), k_half[l].clone(), v_half[l].clone()
            if (i + l) % 2:
                decode_step.attn_step_planned(plan, l, t, off)
            else:
                decode_step.attn_step(h, *(layers[l][k] for k in decode_step.ATTN_KEYS), mp["invf"], k_half[l],
                                      v_half[l], t, off, scratch=shared, **kw)
            want = decode_step.attn_step_plain(h0, *plain[l][0], mp["invf"], kp, vp, t, off, **kw)
            torch.cuda.synchronize()
            assert _close(h, want) and _close(k_half[l, t], kp[t])
            h0 = h.clone()
            if (i + l) % 2:
                decode_step.mlp_step_planned(plan, l)
            else:
                decode_step.mlp_step(h, *(layers[l][k] for k in decode_step.MLP_KEYS), eps=cfg.norm_eps,
                                     scratch=shared)
            want = decode_step.mlp_step_plain(h0, *plain[l][1], eps=cfg.norm_eps)
            torch.cuda.synchronize()
            assert _close(h, want)
    assert torch.equal(k_step, k_ref) and torch.equal(v_step, v_ref)


@pytest.mark.parametrize("bits", [8, 4])
def test_planned_half_layers_equal_the_public_calls_bit_for_bit(cuda, bits):
    """A planned call and a public call on the same inputs (each on a
    scratch of its own) give the same residual and cache rows, bit for
    bit: one kernel, one order of sums."""
    cfg, g, mp, layers, k1, v1 = _half_layer_lm(cuda, bits, 13)
    k2, v2 = k1.clone(), v1.clone()
    kw = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim, eps=cfg.norm_eps)
    h = torch.empty((1, cfg.dim), dtype=torch.bfloat16, device=cuda)
    plan = decode_step.plan_half_layers(
        h, layers, mp["invf"], k1, v1, **kw,
        scratch=decode_step.half_layer_scratch(cfg.dim, cfg.n_heads, cfg.head_dim, cfg.ffn_dim, cuda))
    hp = torch.empty_like(h)
    for i in range(4):
        t, off = 50 + i, 2 * i
        h.copy_((torch.randn((1, cfg.dim), generator=g, device=cuda) * 0.5).to(torch.bfloat16))
        hp.copy_(h)
        decode_step.layers_planned(plan, t, off, cfg.n_layers)
        for l, lw in enumerate(layers):
            decode_step.attn_step(hp, *(lw[k] for k in decode_step.ATTN_KEYS), mp["invf"], k2[l], v2[l], t, off,
                                  **kw)
            decode_step.mlp_step(hp, *(lw[k] for k in decode_step.MLP_KEYS), eps=cfg.norm_eps)
        torch.cuda.synchronize()
        assert torch.equal(h, hp)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    with pytest.raises(ValueError, match="plan holds 2 layers"):
        decode_step.layers_planned(plan, 60, 0, cfg.n_layers + 1)


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
    waits (5 a layer, the head, the sampler's ticket), in order, and the
    slot after them holds the step's end. Where the wait is a grid barrier
    (before wo) nobody leaves it before the last block arrived."""
    cfg = tiny_config().token_lm
    g = torch.Generator(device=cuda).manual_seed(9)
    mp = token_lm.mega_decode_params(quantize_tree(token_lm.init_params(cfg, g)), cfg)
    L, N, S = cfg.n_layers, cfg.dim, 48
    k = (torch.randn((L, S, N), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    v = k.clone()
    tok = torch.tensor([3], dtype=torch.int32, device=cuda)
    n_bar = 5 * L + 2
    scratch = decode_step.decode_scratch(mp, cfg.n_heads, cfg.head_dim, cuda, stamps=True)
    decode_step.mega_decode_step(tok, mp, k, v, 30, 4, False, 1, n_heads=cfg.n_heads, head_dim=cfg.head_dim,
                                 eps=cfg.norm_eps, pad_id=cfg.speech_pad, bos_id=cfg.speech_bos,
                                 eos_id=cfg.speech_eos, scratch=scratch)
    torch.cuda.synchronize()
    st = scratch["stamps"].cpu()
    assert st.shape[0] == n_bar + 1 and st.shape[2] == 2
    arrive, leave = st[:n_bar, :, 0], st[:n_bar, :, 1]
    assert bool((arrive > 0).all()) and bool((leave >= arrive).all())
    assert bool((arrive[1:] >= leave[:-1]).all()) and bool((st[n_bar, :, 0] >= leave[-1]).all())
    grid = [5 * l + 2 for l in range(L)]
    assert bool((leave[grid].min(dim=1).values >= arrive[grid].max(dim=1).values).all())


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


def _flagship_lm(cuda, weights: str):
    """The token LM at its flagship widths (1024 x 14, FFN 4096, 4,099
    speech tokens), random at fan-in scale: ``int8`` as the int8 engine
    serves it, ``int4-engine`` as the int4 engine's batches read it (views
    of the decode step's int8 copy), ``int4-packed`` every projection as
    packed int4."""
    from autostyle_tts_tpu_torch.pipeline.engine import _prepare_lm
    from autostyle_tts_tpu_torch.utils.config import TokenLMConfig

    cfg = TokenLMConfig()
    lm = token_lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(11))
    if weights == "int4-packed":
        return quantize_tree(lm, bits=4), cfg
    ecfg = tiny_config()
    ecfg.token_lm, ecfg.quantize_lm_int8, ecfg.quantize_lm_int4 = cfg, True, weights == "int4-engine"
    return _prepare_lm(lm, ecfg)[0], cfg


def _batch_inputs(cuda, cfg, B, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randint(16, 200, (B, 96), generator=g, device=cuda, dtype=torch.int32),
            torch.randint(20, 97, (B,), generator=g, device=cuda),
            torch.randint(0, 4096, (B, 64), generator=g, device=cuda, dtype=torch.int32),
            torch.randint(10, 65, (B,), generator=g, device=cuda),
            torch.randn((B, cfg.spk_dim), generator=g, device=cuda))


def _scanned(lm, cfg, inputs, seed, monkeypatch, cuda, eager=False, steps=64):
    """(SpeechGen, each step's logits, the decode span) of a scanned decode
    on fresh kept steps: through the captured step, or with ``eager`` the
    same step run eagerly at every step (its capture never made)."""
    from autostyle_tts_tpu_torch.utils.timing import Stopwatch

    seen = []
    mask = token_lm._mask_logits
    with monkeypatch.context() as m:
        m.setattr(token_lm, "_KEPT_STEPS", [])
        m.setattr(token_lm, "_mask_logits", lambda logits, *a: seen.append(logits.clone()) or mask(logits, *a))
        if eager:
            m.setattr(token_lm.ScanStep, "capture", lambda self: self.forward())
        clock = Stopwatch(cuda)
        with clock.open("request"):
            gen = token_lm.generate_speech_from_ids(lm, cfg, *inputs, torch.Generator(device=cuda).manual_seed(seed),
                                                    max_new_tokens=steps, kv_int8=True, min_tokens=steps, clock=clock)
    return gen, seen, [s for s in clock.spans if s.name == "decode"][0]


@pytest.mark.parametrize("weights", ["int8", "int4-engine", "int4-packed"])
def test_scanned_graph_matches_eager_step_at_flagship_widths(cuda, weights, monkeypatch):
    """B=8, int8 KV cache, 64 steps from one seed: the captured step's
    replays give the eager step's tokens, and logits within 1e-5 of their
    largest |value| at every step; the decode span counts one capture and
    a replay for every other step."""
    lm, cfg = _flagship_lm(cuda, weights)
    inputs = _batch_inputs(cuda, cfg, 8, 5)
    want, want_logits, eager = _scanned(lm, cfg, inputs, 9, monkeypatch, cuda, eager=True)
    got, got_logits, span = _scanned(lm, cfg, inputs, 9, monkeypatch, cuda)
    assert torch.equal(got.tokens, want.tokens) and torch.equal(got.lengths, want.lengths)
    assert got.decode_steps == want.decode_steps == 64
    assert len(got_logits) == len(want_logits) == 64
    for i, (a, b) in enumerate(zip(got_logits, want_logits)):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item(), i
    assert span.attrs["graph"] and eager.attrs["graph"]
    assert span.counters["graph_captures"] == 1 and span.counters["graph_replays"] == 63


def test_interleaved_scanned_loops_on_card_keep_their_own_steps(cuda, monkeypatch):
    """Two live loops of one shape, advanced in turns, hold two kept steps
    and give each the tokens it gives alone; a fresh step's cache starts
    zeroed (finite scales) and stays finite."""
    lm, cfg = _flagship_lm(cuda, "int8")
    ins = [_batch_inputs(cuda, cfg, 8, s) for s in (21, 22)]
    monkeypatch.setattr(token_lm, "_KEPT_STEPS", [])
    fresh = token_lm.graph_step(lm, cfg, token_lm.core_config(cfg), 8, 600, True, cfg.n_kv_heads, cuda)
    assert all(bool(torch.isfinite(t.float()).all()) and not bool(t.any()) for t in fresh.cache.values())
    token_lm._KEPT_STEPS.clear()
    kw = dict(max_new_tokens=48, kv_int8=True, min_tokens=48)
    alone = [token_lm.generate_speech_from_ids(lm, cfg, *x, torch.Generator(device=cuda).manual_seed(s), **kw)
             for x, s in zip(ins, (1, 2))]
    loops = []
    for x, s in zip(ins, (1, 2)):
        pre = token_lm.pad_prefix(token_lm.build_prefix(lm, cfg, *x))
        loops.append(token_lm.start_decode(lm, cfg, pre, torch.Generator(device=cuda).manual_seed(s), **kw))
    held = [s for s in token_lm._KEPT_STEPS if not s.idle]
    assert len(held) == 2 and held[0] is not held[1]
    gens = [None, None]
    while None in gens:
        for j, loop in enumerate(loops):
            if gens[j] is None:
                _, gens[j] = token_lm.take(loop, 1)
    for g, a in zip(gens, alone):
        assert torch.equal(g.tokens, a.tokens) and g.decode_steps == a.decode_steps
    for step in token_lm._KEPT_STEPS:
        assert step.idle and step.graph is not None
        assert all(bool(torch.isfinite(step.cache[n]).all()) for n in ("k_scale", "v_scale"))


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


def _stream_engine(cuda, seed=4):
    """A tiny engine on the card with the serving configurations' kinds (a
    bf16 CFM trunk, the iSTFT vocoder) and every CFM layer contributing
    (the zero-initialized modulation and output projection filled)."""
    cfg = tiny_config()
    cfg.cfm = dataclasses.replace(cfg.cfm, dtype="bfloat16")
    cfg.vocoder = dataclasses.replace(cfg.vocoder, kind="istft", istft_hop=cfg.audio.hop_length,
                                      istft_n_fft=4 * cfg.audio.hop_length, istft_channels=32, istft_blocks=2)
    eng = Engine(cfg, seed=seed, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(seed)
    c = eng.params.cfm
    c["layers"]["mod"].copy_(torch.randn(c["layers"]["mod"].shape, generator=g, device=cuda) * 0.05)
    c["out_proj"].copy_(torch.randn(c["out_proj"].shape, generator=g, device=cuda) * 0.1)
    return eng


def _feat(cfg, n, seed):
    r = np.random.default_rng(seed)
    return PromptFeatures(tokens=r.integers(0, 64, n).astype(np.int32),
                          spk=r.standard_normal(cfg.speaker.emb_dim).astype(np.float32),
                          mel24=r.standard_normal((2 * n, cfg.cfm.n_mels)).astype(np.float32))


def _window_noise(eng, prm, n_windows, seed):
    """One [1, W * up, M] noise array a window of a stream on ``prm``."""
    cfg = eng.cfg
    W = eng._flow_stream_dev(prm).key[0] + 2 * max(8, (2 * cfg.token_lm.token_rate) // 3)
    r = np.random.default_rng(seed)
    return [r.standard_normal((1, W * cfg.cfm.upsample, cfg.cfm.n_mels)).astype(np.float32) for _ in range(n_windows)]


WINDOW_ATOL = 0.0     # a replayed window's samples against the eager one's: the same kernels on the same inputs


@pytest.mark.parametrize("noise", ["given", "drawn"])
def test_stream_window_replays_match_eager_render(cuda, noise, monkeypatch):
    """A voice-conversion stream of 9 windows on the card, rendered eagerly
    and then by the kept window graph (its first window eager, recorded,
    the rest replays) from the same generator state: each chunk within
    ``WINDOW_ATOL`` of the eager one, whether the noise is given or drawn
    from the engine's generator (outside the graph, the draw the eager
    solve makes); the trace counts one capture and then one replay a
    window on both spans."""
    eng = _stream_engine(cuda)
    src, prm = _feat(eng.cfg, 140, 1), _feat(eng.cfg, 40, 2)
    noises = _window_noise(eng, prm, 9, 3) if noise == "given" else None
    state = eng.generator.get_state()
    with monkeypatch.context() as m:
        m.setattr(Engine, "_window_graph", lambda self, *a: None)
        want = [c["tts_speech"] for c in eng.inference_vc(src, prm, stream=True, cfm_noise=noises)]
    assert eng._windows == []
    eng.generator.set_state(state)
    got = [c["tts_speech"] for c in eng.inference_vc(src, prm, stream=True, cfm_noise=noises)]
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        assert np.abs(g - w).max() <= WINDOW_ATOL
    assert len(eng._windows) == 1 and eng._windows[0].vocoder_graph is not None
    for name in ("cfm", "vocoder"):
        spans = [s for s in eng.last_trace if s.name == name]
        assert [s.counters["graph_captures"] for s in spans] == [1] + [0] * 8
        assert [s.counters["graph_replays"] for s in spans] == [0] + [1] * 8
        assert all(s.attrs["graph"] for s in spans)
    cfms = [s for s in eng.last_trace if s.name == "cfm"]
    assert all(s.counters["euler_steps"] == eng.cfg.cfm.n_steps for s in cfms)
    children = [s.parent for s in eng.last_trace if s.name in ("cfm.cond", "cfm.solve")]
    assert children == [cfms[0].id] * 2


def test_second_stream_reuses_the_kept_window_graph(cuda):
    """A second stream of the same key (another source, prompt and noise)
    records nothing: every window of it is a replay."""
    eng = _stream_engine(cuda)
    prm = _feat(eng.cfg, 40, 2)
    list(eng.inference_vc(_feat(eng.cfg, 60, 1), prm, stream=True))
    kept = list(eng._windows)
    prm2 = _feat(eng.cfg, 50, 5)
    chunks = list(eng.inference_vc(_feat(eng.cfg, 90, 4), prm2, stream=True,
                                   cfm_noise=_window_noise(eng, prm2, 6, 6)))
    assert len(chunks) == 6 and eng._windows == kept
    for s in eng.last_trace:
        if s.name in ("cfm", "vocoder"):
            assert s.counters["graph_captures"] == 0 and s.counters["graph_replays"] == 1


def _chunks_of_interleaved_sessions(eng, feats, style):
    """Two ``StreamingScheduler``s on ``eng``, one session each on
    ``feats[j]``, stepped in turns: each session's chunk samples."""
    from autostyle_tts_tpu_torch.pipeline.stream_serve import StreamingScheduler

    schs = [StreamingScheduler(eng, slots=1, max_seconds=2.0, p_max=128, sampler=SamplerConfig(greedy=True))
            for _ in feats]
    sids = [sch.submit({"text": f"session {i} speaks", "style_text": "st", "style_feat": style,
                        "flow_feat": f, "max_tokens": 48}) for i, (sch, f) in enumerate(zip(schs, feats))]
    out = [[], []]
    for _ in range(200):
        if all(sch.idle for sch in schs):
            break
        for j, sch in enumerate(schs):
            out[j] += [ev.wav for ev in sch.step() if ev.session == sids[j] and ev.kind == "chunk"]
    return out


@pytest.mark.parametrize("fault", [None, "mel_chunk_view"])
def test_interleaved_scheduler_sessions_keep_their_own_mel_context(cuda, monkeypatch, fault):
    """Two ``StreamingScheduler``s on one engine, one session each, stepped
    in turns: their windows share one kept graph, replayed for one session
    between two windows of the other. Each session's chunks equal, within
    ``WINDOW_ATOL``, those of the same turns rendered eagerly from the same
    generator state. With the fault planted (a replay hands back its mel
    chunk as a view of the graph's output, not a copy) the other session's
    replay overwrites that view before it is read as the next context, and
    the same comparison fails."""
    from autostyle_tts_tpu_torch.pipeline.engine import WindowGraph

    eng = _stream_engine(cuda)
    feats = [_feat(eng.cfg, 40, 7), _feat(eng.cfg, 48, 8)]
    style = _feat(eng.cfg, 12, 10)
    list(eng.inference_vc(_feat(eng.cfg, 40, 9), feats[0], stream=True))     # records the graph
    state = eng.generator.get_state()
    with monkeypatch.context() as m:
        m.setattr(Engine, "_window_graph", lambda self, *a: None)
        want = _chunks_of_interleaved_sessions(eng, feats, style)
    if fault == "mel_chunk_view":
        render = WindowGraph.render

        def aliased(self, params, cfg, block, prompts, *a, **k):
            replay = self.vocoder_graph is not None
            wav, mel_chunk = render(self, params, cfg, block, prompts, *a, **k)
            return wav, (self.mel_chunk[: len(prompts)] if replay else mel_chunk)
        monkeypatch.setattr(WindowGraph, "render", aliased)
    eng.generator.set_state(state)
    got = _chunks_of_interleaved_sessions(eng, feats, style)
    for g, w in zip(got, want):
        assert len(g) == len(w) >= 2 and all(a.shape == b.shape for a, b in zip(g, w))
    diff = max(np.abs(a - b).max() for g, w in zip(got, want) for a, b in zip(g, w))
    if fault is None:
        assert diff <= WINDOW_ATOL
    else:
        assert diff > 1e-2, diff


def test_eight_slot_scheduler_replays_after_warm_up(cuda, monkeypatch):
    """A ``StreamingScheduler`` of 8 slots over 16 sessions on prompts of
    both stream widths (32 and 64 tokens), sessions of several lengths, so
    its windows come in many row counts. The row count is rounded up to a
    ``WINDOW_ROWS`` count, so every key fits the kept graphs: after one
    warm-up pass the same pass records nothing (every window a replay) and
    its chunks equal the warm-up's (whose first window of a key ran
    eagerly on the same buffers). Both are within 2e-3 of the eager render
    of the same turns, which runs the window at B rows (another GEMM shape
    than the graph's rounded-up count, bf16 trunk)."""
    from autostyle_tts_tpu_torch.pipeline import engine as engine_mod
    from autostyle_tts_tpu_torch.pipeline.stream_serve import StreamingScheduler
    from autostyle_tts_tpu_torch.utils import timing

    eng = _stream_engine(cuda)
    style = _feat(eng.cfg, 12, 10)
    feats = [_feat(eng.cfg, (20, 40)[i % 2], 30 + i) for i in range(16)]
    widths = {eng._flow_stream_dev(f).key[0] for f in feats}
    assert widths == set(engine_mod.STREAM_BUCKETS)

    def run():
        sch = StreamingScheduler(eng, slots=8, max_seconds=2.0, p_max=128, sampler=SamplerConfig(greedy=True))
        sids = [sch.submit({"text": f"session {i} says a few words", "style_text": "st", "style_feat": style,
                            "flow_feat": f, "max_tokens": 24 + 8 * (i % 5)}) for i, f in enumerate(feats)]
        t0 = time.perf_counter()
        events = sch.run()
        wins = [s for s in timing.spans() if s.name == "cfm" and s.t0 >= t0]
        return [[ev.wav for ev in events[sid] if ev.kind == "chunk"] for sid in sids], wins

    state = eng.generator.get_state()
    with monkeypatch.context() as m:
        m.setattr(Engine, "_window_graph", lambda self, *a: None)
        want, _ = run()
    eng.generator.set_state(state)
    warm, wins = run()
    assert 0 < sum(s.counters["graph_captures"] for s in wins) <= engine_mod.MAX_KEPT_WINDOWS
    rows = {int(s.counters["frames"]) for s in wins}
    assert len(rows) >= 3, rows          # several row counts (frames = rows x W x up)
    eng.generator.set_state(state)
    got, wins = run()
    assert wins and all(s.counters["graph_replays"] == 1 and s.counters["graph_captures"] == 0 for s in wins)
    assert len(eng._windows) <= engine_mod.MAX_KEPT_WINDOWS
    assert sum(len(g) for g in got) > len(got)
    for g, w, e in zip(got, warm, want):
        assert len(g) == len(w) == len(e) >= 1
        for a, b, c in zip(g, w, e):
            assert a.shape == b.shape == c.shape and np.array_equal(a, b)
            assert np.abs(a - c).max() <= 2e-3, np.abs(a - c).max()


def test_window_graph_only_on_a_card_without_a_mesh(cuda, monkeypatch):
    """The window is a kept graph on a card without a mesh, and eager on a
    CPU engine of the same weights or under a mesh."""
    eng = _stream_engine(cuda)
    prompt = eng._flow_stream_dev(_feat(eng.cfg, 40, 2))
    assert eng._window_graph(1, prompt, 16) is not None
    cpu = Engine(eng.cfg, params=eng.params, device="cpu")
    assert cpu._window_graph(1, cpu._flow_stream_dev(_feat(eng.cfg, 40, 2)), 16) is None
    chunks = list(cpu.inference_vc(_feat(eng.cfg, 40, 1), _feat(eng.cfg, 40, 2), stream=True))
    assert chunks and cpu._windows == []
    monkeypatch.setattr(eng, "mesh", object())
    assert eng._window_graph(1, prompt, 16) is None


def test_no_sync_inside_a_replayed_window(cuda, monkeypatch):
    """Under torch's sync debug mode, replayed windows (noise given and
    drawn) block the host only through the clock: its wait at the end of
    ``cfm`` and the samples' read at the end of ``vocoder``."""
    import traceback
    import warnings

    from autostyle_tts_tpu_torch.utils import timing
    from autostyle_tts_tpu_torch.utils.timing import Stopwatch

    eng = _stream_engine(cuda)
    src, prm = _feat(eng.cfg, 80, 1), _feat(eng.cfg, 40, 2)
    list(eng.inference_vc(src, prm, stream=True))       # records the graph

    def quiet(f):
        def run(*a, **k):
            torch.cuda.set_sync_debug_mode(0)
            try:
                return f(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("warn")
        return run

    monkeypatch.setattr(Stopwatch, "read", quiet(Stopwatch.read))
    monkeypatch.setattr(Stopwatch, "wait", quiet(Stopwatch.wait))
    found = []

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            ours = [f for f in traceback.extract_stack() if "autostyle_tts_tpu_torch" in f.filename]
            at = f"{ours[-1].filename}:{ours[-1].lineno}" if ours else f"{filename}:{lineno}"
            found.append((tuple(s.name for s in timing._OPEN), at))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            list(eng.inference_vc(src, prm, stream=True, cfm_noise=_window_noise(eng, prm, 5, 3)))
            list(eng.inference_vc(src, prm, stream=True))
            torch.ones(1, device=cuda).item()     # a sync outside every span: seen
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert found and found[-1][0] == ()
    hidden = sorted({(names[-1], at) for names, at in found if {"cfm", "vocoder"} & set(names)})
    assert not hidden, "syncs inside a window (innermost span, call site):\n" + "\n".join(
        f"{n} {at}" for n, at in hidden)
    assert all(s.counters["graph_replays"] == 1 for s in eng.last_trace if s.name == "cfm")


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


# ----------------------------------------------------------------------------- the device mesh on the card


def test_tp_embed_ranks_sharing_the_card_match_unsharded(cuda):
    """Two ranks on the card (gloo on CUDA tensors) at tp 2: the flash
    kernel on each rank's local heads (2:1 of 4:2), the embed within 2e-2
    of the largest |component| of the unsharded embed on the card."""
    from autostyle_tts_tpu_torch.parallel.launch import launch
    from autostyle_tts_tpu_torch.utils.config import TransformerConfig

    import torch_parallel_workers as workers

    kw = dict(vocab_size=272, dim=128, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=256, max_seq_len=128)
    toks = np.random.default_rng(0).integers(16, 272, (4, 64)).astype(np.int64)
    cfg = TransformerConfig(**kw)
    with torch.no_grad():
        t = torch.as_tensor(toks, device=cuda)
        want = transformer.embed_text(transformer.init_params(cfg, rng.PRNGKey(0, cuda)), cfg, t,
                                      torch.ones_like(t)).cpu().numpy()
    for got, launches in launch(workers.embed_on_card, 2, kw, toks, backend="gloo", join_s=300):
        assert launches == cfg.n_layers
        np.testing.assert_allclose(got, want, atol=2e-2 * np.abs(want).max())


def test_engine_dp2_ranks_sharing_the_card_matches_unsharded(cuda):
    """The tiny engine at dp 2 (two ranks on the card, gloo): every rank's
    wavs those of the unsharded engine on the card, within 1e-4 (the JAX
    test's)."""
    from autostyle_tts_tpu_torch.parallel.launch import launch

    import torch_parallel_workers as workers

    sr = tiny_config().audio.prompt_sample_rate
    t = np.arange(sr) / sr
    r = np.random.default_rng(7)
    wav = lambda f: (0.3 * np.sin(2 * np.pi * f * t) + 0.02 * r.standard_normal(t.size)).astype(np.float32)  # noqa: E731
    case = {"seed": 3, "texts": ["hello world", "ok then"], "styles": ["style one", "style two"],
            "sty": [wav(200), wav(300)], "tim": [wav(180), wav(260)]}
    want = Engine(tiny_config(), seed=3).synthesize_batch(case["texts"], case["styles"], case["sty"], case["tim"])
    for got in launch(workers.engine_on_card, 2, case, backend="gloo", join_s=300):
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-4)
