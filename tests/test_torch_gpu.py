"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without CUDA every test here skips (decided inside the
fixture, never at import). On a machine with a card, from the repository
root (``--noconftest`` because the repository's conftest imports JAX, which
that machine does not need):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: bf16 outputs, two bf16 ulps at the values' scale (flash);
the decode step's residual and cache rows within 2e-2 of max(|h|, 1) after
two layers, and the same greedy and sampled token.
"""

import pytest
import torch

from autostyle_tts_tpu_torch.models import token_lm
from autostyle_tts_tpu_torch.ops import decode_step
from autostyle_tts_tpu_torch.ops.flash_attn import flash_attention, flash_attention_plain
from autostyle_tts_tpu_torch.utils.config import tiny_config
from autostyle_tts_tpu_torch.weights import quantize_tree

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("H,K,hd,offsets", [(4, 4, 64, [0, 37]), (8, 2, 32, [5, 130]),
                                            (4, 1, 16, [64, 0])])
def test_flash_kernel_matches_plain(cuda, H, K, hd, offsets):
    g = torch.Generator(device=cuda).manual_seed(0)
    B, T = len(offsets), 192
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
    q = torch.zeros((1, 128, 2, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q, torch.zeros((1,), dtype=torch.int32, device=cuda))


def test_flash_kernel_rejects_f32(cuda):
    q = torch.zeros((1, 64, 4, 64), device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention(q, q, q, torch.zeros((1,), dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("greedy", [True, False])
def test_decode_step_kernel_matches_plain(cuda, greedy):
    cfg = tiny_config().token_lm
    g = torch.Generator(device=cuda).manual_seed(1)
    lm = quantize_tree(token_lm.init_params(cfg, g))
    mp = token_lm.mega_decode_params(lm, cfg)
    L, N, S, off = cfg.n_layers, cfg.dim, 48, 4
    k1 = (torch.randn((L, S, N), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    v1 = (torch.randn((L, S, N), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    k2, v2 = k1.clone(), v1.clone()
    kw = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim, eps=cfg.norm_eps,
              pad_id=cfg.speech_pad, bos_id=cfg.speech_bos, eos_id=cfg.speech_eos,
              greedy=greedy, temperature=0.8, top_k=5)
    tok = torch.tensor([3], dtype=torch.int32, device=cuda)
    for i, t in enumerate(range(20, 26)):
        hk, tk = decode_step.mega_decode_step(tok, mp, k1, v1, t, off, i == 0, 77 + i, **kw)
        hp, tp = decode_step.mega_decode_step_plain(tok, mp, k2, v2, t, off, i == 0, 77 + i, **kw)
        torch.cuda.synchronize()
        scale = max(hp.float().abs().max().item(), 1.0)
        assert (hk.float() - hp.float()).abs().max().item() <= 2e-2 * scale
        assert (k1[:, t].float() - k2[:, t].float()).abs().max().item() <= 2e-2 * scale
        assert int(tk[0]) == int(tp[0])
        tok = tp
    assert torch.equal(k1[:, :20], k2[:, :20]) and torch.equal(v1[:, 26:], v2[:, 26:])



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
