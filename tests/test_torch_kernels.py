"""Port parity for the two kernel modules, on the CPU through their plain
PyTorch twins, against the JAX package (Pallas kernels in interpret mode).

Tolerances:
- flash, f32 inputs: atol 1e-5 on real query rows (f32 online softmax vs
  one softmax; pad rows t < offset are never read and are not compared).
- decode step: h_last and the new cache row are bf16; a sum taken in another
  order can flip one bf16 rounding of the residual (one ulp is 1/128
  relative), so they are held to rtol 2e-2 / atol 2e-2. The greedy token
  must be equal; every other cache row must be untouched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autostyle_tts_tpu.models import token_lm as jlm
from autostyle_tts_tpu.ops.attention import causal_mask as jcausal_mask
from autostyle_tts_tpu.ops.attention import sdpa as jsdpa
from autostyle_tts_tpu.ops.pallas_attn import flash_attention as jflash
from autostyle_tts_tpu.ops.pallas_decode import mega_decode_step as jmega
from autostyle_tts_tpu.ops.quant import quantize_tree as jquantize_tree
from autostyle_tts_tpu.ops.sampling import SamplerConfig as JSampler
from autostyle_tts_tpu.ops.sampling import transform_logits as jtransform
from autostyle_tts_tpu.utils.config import tiny_config as jtiny
from autostyle_tts_tpu_torch.models import token_lm as tlm
from autostyle_tts_tpu_torch.ops import decode_step
from autostyle_tts_tpu_torch.ops.flash_attn import flash_attention
from autostyle_tts_tpu_torch.ops.sampling import SamplerConfig, sample, transform_logits
from autostyle_tts_tpu_torch.utils.config import tiny_config
from autostyle_tts_tpu_torch.weights import tree_from_numpy

# --------------------------------------------------------------------- flash


def _flash_inputs(kv_heads):
    rng = np.random.default_rng(0)
    B, T, H, hd = 2, 128, 4, 64
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, kv_heads, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, kv_heads, hd)).astype(np.float32)
    off = np.asarray([0, 37], np.int32)
    real = (np.arange(T)[None, :] >= off[:, None])[:, :, None, None]
    return q, k, v, off, real


def _port_flash(q, k, v, off):
    flash_attention.launches = 0
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(off)).numpy()
    assert flash_attention.launches == 0   # the CPU takes the plain twin
    return out


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_flash_plain_matches_pallas_interpret(kv_heads):
    q, k, v, off, real = _flash_inputs(kv_heads)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(off), block_t=64, block_s=64, interpret=True))
    got = _port_flash(q, k, v, off)
    np.testing.assert_allclose(np.where(real, got, 0), np.where(real, want, 0), atol=1e-5)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_flash_plain_matches_jax_sdpa(kv_heads):
    q, k, v, off, real = _flash_inputs(kv_heads)
    T = q.shape[1]
    slot = jnp.arange(T)
    mask = jcausal_mask(T, T) & (slot[None, :] >= jnp.asarray(off)[:, None])[:, None, None, :]
    want = np.asarray(jsdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask))
    got = _port_flash(q, k, v, off)
    np.testing.assert_allclose(np.where(real, got, 0), np.where(real, want, 0), atol=1e-5)


def test_flash_cuda_tensor_never_falls_back():
    """A non-CPU tensor goes to the kernel or raises (here: no CUDA build)."""
    q = torch.zeros((1, 128, 4, 64), dtype=torch.float32, device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        flash_attention(q, q, q, torch.zeros((1,), dtype=torch.int32))


# --------------------------------------------------------------- decode step


def _tiny_lm(seed):
    cfg = jtiny().token_lm
    jp = jquantize_tree(jlm.init_params(jax.random.PRNGKey(seed), cfg))
    tp = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return cfg, jp, tp


def test_mega_decode_step_plain_matches_pallas_interpret():
    cfg, jp, tp = _tiny_lm(3)
    jmp = jlm.mega_decode_params(jp, cfg, tile_f=64)
    tmp = tlm.mega_decode_params(tp, tiny_config().token_lm)
    L, N, S, off = cfg.n_layers, cfg.dim, 24, 3
    rng = np.random.default_rng(5)
    k0 = (rng.standard_normal((L, S, N)) * 0.5).astype(np.float32)
    v0 = (rng.standard_normal((L, S, N)) * 0.5).astype(np.float32)
    jk = jnp.asarray(k0, jnp.bfloat16)
    jv = jnp.asarray(v0, jnp.bfloat16)
    tk = torch.from_numpy(k0).to(torch.bfloat16)
    tv = torch.from_numpy(v0).to(torch.bfloat16)
    kw = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim, eps=cfg.norm_eps,
              pad_id=cfg.speech_pad, bos_id=cfg.speech_bos, eos_id=cfg.speech_eos,
              greedy=True)
    tok = 5
    decode_step.mega_decode_step.launches = 0
    for i, t in enumerate(range(10, 15)):
        suppress = int(i == 0)
        jh, jtok, jk, jv = jmega(
            jnp.int32(tok), jmp, jk, jv, jnp.int32(t), jnp.int32(off),
            jnp.int32(suppress), jnp.int32(0), vocab=cfg.speech_vocab_size,
            interpret=True, **kw)
        th, ttok = decode_step.mega_decode_step(
            torch.tensor([tok], dtype=torch.int32), tmp, tk, tv, t, off,
            bool(suppress), 0, **kw)
        assert int(ttok[0]) == int(jtok[0, 0])
        np.testing.assert_allclose(th.float().numpy(), np.asarray(jh, np.float32),
                                   rtol=2e-2, atol=2e-2)
        jkf, tkf = np.asarray(jk, np.float32), tk.float().numpy()
        np.testing.assert_allclose(tkf[:, t], jkf[:, t], rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(tv.float().numpy()[:, t], np.asarray(jv, np.float32)[:, t],
                                   rtol=2e-2, atol=2e-2)
        untouched = [s for s in range(S) if s < 10 or s > t]
        np.testing.assert_array_equal(tkf[:, untouched], k0.astype(np.float32)[:, untouched]
                                      .astype(jnp.bfloat16).astype(np.float32))
        tok = int(jtok[0, 0])
    assert decode_step.mega_decode_step.launches == 0


def test_generate_from_ids_greedy_matches_jax_scan():
    """Port generate (plain flash prefill + plain decode step) == the JAX
    scanned decode, greedy: same tokens, same lengths."""
    cfg, jp, tp = _tiny_lm(3)
    rng = np.random.default_rng(3)
    text = rng.integers(16, 200, (1, 10)).astype(np.int32)
    sty = rng.integers(0, 64, (1, 6)).astype(np.int32)
    spk = rng.standard_normal((1, cfg.spk_dim)).astype(np.float32)
    want = jlm.generate_speech_from_ids(
        jp, cfg, jnp.asarray(text), jnp.asarray([10]), jnp.asarray(sty),
        jnp.asarray([6]), jnp.asarray(spk), jax.random.PRNGKey(0),
        max_new_tokens=24, sampler=JSampler(greedy=True), fused=False)
    tcfg = tiny_config().token_lm
    got = tlm.generate_speech_from_ids(
        tp, tcfg, torch.from_numpy(text), torch.tensor([10]), torch.from_numpy(sty),
        torch.tensor([6]), torch.from_numpy(spk), None, max_new_tokens=24,
        decode_params=tlm.mega_decode_params(tp, tcfg), sampler=SamplerConfig(greedy=True))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert int(got.lengths[0]) == int(want.lengths[0])


def test_generate_stops_at_eos_and_pads(monkeypatch):
    """EOS semantics of the host loop: EOS is masked while i < min_tokens,
    the loop stops after EOS, later slots are pad, and gen_len counts the
    tokens before EOS. The decode step is scripted to emit EOS as soon as
    it is allowed."""
    cfg = tiny_config().token_lm
    _, _, tp = _tiny_lm(4)
    seen = []

    def scripted(tok_in, mp, k_all, v_all, t, off, suppress, seed, **kw):
        seen.append((t, bool(suppress)))
        nxt = 7 if suppress else kw["eos_id"]
        return None, torch.tensor([nxt], dtype=torch.int32)

    monkeypatch.setattr(tlm, "mega_decode_step", scripted)
    text = torch.randint(16, 200, (1, 8), generator=torch.Generator().manual_seed(0))
    out = tlm.generate_speech_from_ids(
        tp, cfg, text.int(), torch.tensor([8]), torch.zeros((1, 4), dtype=torch.int32),
        torch.tensor([4]), torch.zeros((1, cfg.spk_dim)), None, max_new_tokens=16,
        decode_params=tlm.mega_decode_params(tp, cfg), sampler=SamplerConfig(greedy=True),
        min_tokens=3)
    toks = out.tokens[0].tolist()
    assert toks[0] != cfg.speech_eos and toks[1:4] == [7, 7, cfg.speech_eos]
    assert all(t == cfg.speech_pad for t in toks[4:])
    assert int(out.lengths[0]) == 3 and out.decode_steps == 3
    P = 128   # 1 + 8 + 1 + 4 padded to the 128 multiple
    assert seen == [(P, True), (P + 1, True), (P + 2, False)]


def test_sampler_top_k_tie_rule_and_law():
    """The decode step's sampler keeps the reference's top-k tie rule (each
    strip removes every value tied at the running max) and draws from the
    softmax of the kept logits (Gumbel-max over Philox bits)."""
    V = 16
    logits = torch.full((V,), -5.0)
    logits[[1, 2]] = 3.0          # tied maximum
    logits[[5, 6, 7]] = 2.0       # tied second value
    logits[9] = 1.0
    kw = dict(pad_id=15, bos_id=14, eos_id=13, suppress=False, greedy=False, temperature=1.0)
    # k=2: strip {1, 2}; the max of the rest is 2.0, so {1, 2, 5, 6, 7} stay
    picks = [decode_step.sample_plain(logits, top_k=2, seed=s, **kw) for s in range(3000)]
    counts = np.bincount(picks, minlength=V)
    assert set(np.nonzero(counts)[0]) == {1, 2, 5, 6, 7}
    p = torch.softmax(logits[[1, 2, 5, 6, 7]], 0).numpy()
    np.testing.assert_allclose(counts[[1, 2, 5, 6, 7]] / 3000, p, atol=0.03)
    # greedy takes the smallest id at the maximum; masked ids never win
    g = dict(kw, greedy=True)
    assert decode_step.sample_plain(logits, top_k=0, seed=0, **g) == 1
    logits[15] = 10.0
    assert decode_step.sample_plain(logits, top_k=0, seed=0, **g) == 1


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 25, 1.0), (0.7, 0, 0.9), (1.3, 5, 0.5)])
def test_sampler_transform_matches_jax(temperature, top_k, top_p):
    """The plain sampler (token 0 of every request) keeps the same logits
    as the JAX sampler for temperature, top-k and top-p; greedy is argmax."""
    logits = np.random.default_rng(0).standard_normal((3, 67)).astype(np.float32) * 3
    want = np.asarray(jtransform(jnp.asarray(logits), JSampler(
        temperature=temperature, top_k=top_k, top_p=top_p, top_p_cap=0)))
    got = transform_logits(torch.from_numpy(logits), SamplerConfig(
        temperature=temperature, top_k=top_k, top_p=top_p)).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_allclose(np.where(want > -1e29, got, 0), np.where(want > -1e29, want, 0),
                               rtol=1e-6)
    g = torch.Generator().manual_seed(0)
    picks = sample(torch.from_numpy(logits), SamplerConfig(temperature=temperature, top_k=top_k,
                                                           top_p=top_p), g)
    assert bool(np.all(want[np.arange(3), picks.numpy()] > -1e29))
    assert sample(torch.from_numpy(logits), SamplerConfig(greedy=True)).tolist() == \
        np.argmax(logits, -1).tolist()
