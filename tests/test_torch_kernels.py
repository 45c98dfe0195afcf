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

import dataclasses

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
from autostyle_tts_tpu_torch.weights import quantize_tree as tquantize_tree
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


# ------------------------------------------------- half-layers, list flavour, int4
#
# attn_step / mlp_step: the tolerance of the JAX package's own tests of these
# kernels (rtol 0.05, atol 0.02 on bf16 outputs); rows of the cache other than
# row t must be untouched. Greedy tokens must be equal. The int4 values
# (q4, s4) must equal the JAX packer's exactly: the same f32 operations in
# the same order on the same int8 weights.


def _port_rows(qt):
    """JAX input-major QTensor -> the port's output-major int8 rows + scales."""
    q = torch.tensor(np.asarray(qt.q)).transpose(-1, -2).contiguous()
    return q, torch.tensor(np.asarray(qt.s)).squeeze(-2).contiguous()


def test_attn_step_plain_matches_pallas_interpret():
    from autostyle_tts_tpu.ops.attention import rope_table as jrope_table
    from autostyle_tts_tpu.ops.pallas_decode import attn_step as jattn_step
    from autostyle_tts_tpu.ops.quant import quantize as jquantize
    from autostyle_tts_tpu_torch.ops.attention import rope_inv_freq

    H, hd, S, t, off = 4, 16, 24, 9, 3
    D = H * hd
    rng = np.random.default_rng(0)
    h = (rng.standard_normal((1, D)) * 0.5).astype(np.float32)
    norm = (1.0 + 0.1 * rng.standard_normal((1, D))).astype(np.float32)
    wqkv = jquantize(jnp.asarray(rng.standard_normal((D, 3 * D)) * 0.02, jnp.float32))
    wo = jquantize(jnp.asarray(rng.standard_normal((D, D)) * 0.02, jnp.float32))
    k0 = (rng.standard_normal((S, D)) * 0.3).astype(np.float32)   # slots outside [off, t) are garbage
    v0 = (rng.standard_normal((S, D)) * 0.3).astype(np.float32)
    cos_tab, sin_tab = jrope_table(64, hd)
    cosf = jnp.tile(jnp.concatenate([cos_tab[t - off]] * 2), H)[None, :]
    sinf = jnp.tile(jnp.concatenate([sin_tab[t - off]] * 2), H)[None, :]
    want_h, want_k, want_v = jattn_step(
        jnp.asarray(h, jnp.bfloat16), jnp.asarray(norm), wqkv, wo, cosf, sinf,
        jnp.asarray(k0, jnp.bfloat16), jnp.asarray(v0, jnp.bfloat16), jnp.int32(t), jnp.int32(off),
        n_heads=H, head_dim=hd, eps=1e-5, interpret=True)

    th = torch.from_numpy(h).to(torch.bfloat16)
    tk, tv = torch.from_numpy(k0).to(torch.bfloat16), torch.from_numpy(v0).to(torch.bfloat16)
    k_before, v_before = tk.clone(), tv.clone()
    decode_step.attn_step.launches = 0
    out = decode_step.attn_step(th, torch.from_numpy(norm[0]), *_port_rows(wqkv), *_port_rows(wo),
                                rope_inv_freq(hd), tk, tv, t, off, n_heads=H, head_dim=hd, eps=1e-5)
    assert decode_step.attn_step.launches == 0 and out.data_ptr() == th.data_ptr()   # plain, in place
    np.testing.assert_allclose(th.float().numpy(), np.asarray(want_h, np.float32), rtol=0.05, atol=0.02)
    np.testing.assert_allclose(tk[t].float().numpy(), np.asarray(want_k[t], np.float32), rtol=0.05, atol=0.02)
    np.testing.assert_allclose(tv[t].float().numpy(), np.asarray(want_v[t], np.float32), rtol=0.05, atol=0.02)
    rest = [s for s in range(S) if s != t]
    assert torch.equal(tk[rest], k_before[rest]) and torch.equal(tv[rest], v_before[rest])
    np.testing.assert_array_equal(tk[rest].float().numpy(), np.asarray(want_k, np.float32)[rest])


def test_mlp_step_plain_matches_pallas_interpret():
    from autostyle_tts_tpu.ops.pallas_decode import mlp_step as jmlp_step
    from autostyle_tts_tpu.ops.quant import quantize as jquantize

    D, F = 64, 128
    rng = np.random.default_rng(1)
    h = (rng.standard_normal((1, D)) * 0.5).astype(np.float32)
    norm = (1.0 + 0.1 * rng.standard_normal((1, D))).astype(np.float32)
    wgu = jquantize(jnp.asarray(rng.standard_normal((D, 2 * F)) * 0.02, jnp.float32))
    wdn = jquantize(jnp.asarray(rng.standard_normal((F, D)) * 0.02, jnp.float32))
    want = jmlp_step(jnp.asarray(h, jnp.bfloat16), jnp.asarray(norm), wgu, wdn, eps=1e-5,
                     tile_f=64, interpret=True)
    th = torch.from_numpy(h).to(torch.bfloat16)
    decode_step.mlp_step.launches = 0
    decode_step.mlp_step(th, torch.from_numpy(norm[0]), *_port_rows(wgu), *_port_rows(wdn), eps=1e-5)
    assert decode_step.mlp_step.launches == 0
    np.testing.assert_allclose(th.float().numpy(), np.asarray(want, np.float32), rtol=0.05, atol=0.02)


def test_half_layers_non_cpu_tensor_never_falls_back():
    h = torch.zeros((1, 64), dtype=torch.bfloat16, device="meta")
    z = torch.zeros((4,), device="meta")
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        decode_step.mlp_step(h, z, z, z, z, z, eps=1e-5)
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        decode_step.attn_step(h, z, z, z, z, z, z, torch.zeros((8, 64), device="meta"),
                              torch.zeros((8, 64), device="meta"), 1, 0, n_heads=4, head_dim=16, eps=1e-5)


_LIB = {"decode_max_splits": 16, "decode_part_pad": 4, "decode_bar_words": 7}   # what the built library says


def _plan_inputs(bits, seed=21):
    """A tiny LM's per-layer decode weights at ``bits``, a residual, caches
    and (CPU tensors of the kernels' shapes) a half-layer scratch."""
    cfg = tiny_config().token_lm
    mp = tlm.mega_decode_params(tquantize_tree(tlm.init_params(cfg, torch.Generator().manual_seed(seed))), cfg,
                                bits=bits)
    layers = [{k: mp[k][l] for k in decode_step.ATTN_KEYS + decode_step.MLP_KEYS} for l in range(cfg.n_layers)]
    g = torch.Generator().manual_seed(seed + 1)
    k = (torch.randn((cfg.n_layers, 40, cfg.dim), generator=g) * 0.5).to(torch.bfloat16)
    v = (torch.randn((cfg.n_layers, 40, cfg.dim), generator=g) * 0.5).to(torch.bfloat16)
    h = (torch.randn((1, cfg.dim), generator=g) * 0.5).to(torch.bfloat16)
    scratch = {name: torch.zeros(shape, dtype=dt) for name, (shape, dt) in
               decode_step._half_scratch_spec(cfg.n_heads, cfg.head_dim, cfg.ffn_dim).items()}
    return cfg, dict(h=h, layers=layers, invf=mp["invf"], k_all=k, v_all=v, scratch=scratch,
                     kw=dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim, eps=cfg.norm_eps))


def _swap(where, name, make):
    where[name] = make(where[name])


PLAN_FAULTS = {   # what the kernels cannot take, and the name the plan's error gives it
    "h f32": (lambda c: _swap(c, "h", lambda t: t.float()), "h must be"),
    "wqkv f32": (lambda c: _swap(c["layers"][1], "wqkv", lambda t: t.float()), "layer 1: wqkv must be"),
    "wqkv input-major": (lambda c: _swap(c["layers"][0], "wqkv", lambda t: t.t().contiguous()), "wqkv rows"),
    "wo short": (lambda c: _swap(c["layers"][0], "wo", lambda t: t[:-1]), "layer 0: wo must be"),
    "wqs short": (lambda c: _swap(c["layers"][1], "wqs", lambda t: t[:-1]), "layer 1: wqs must be"),
    "attn_norm strided": (lambda c: _swap(c["layers"][0], "attn_norm", lambda t: t.repeat(2)[::2]),
                          "attn_norm must be contiguous"),
    "wgus bf16": (lambda c: _swap(c["layers"][1], "wgus", lambda t: t.bfloat16()), "layer 1: wgus must be"),
    "wds missing": (lambda c: c["layers"][0].pop("wds"), r"lacks \['wds'\]"),
    "ffn width": (lambda c: [_swap(lw, k, lambda t: t[..., :-8] if k == "wd" else t[:-16])
                             for lw in c["layers"] for k in ("wd", "wgu", "wgus")], "must be multiples of"),
    "invf short": (lambda c: _swap(c, "invf", lambda t: t[:-1]), "invf must be"),
    "k_all layers": (lambda c: _swap(c, "k_all", lambda t: t[:1]), "k_all / v_all must be"),
    "v_all slots": (lambda c: _swap(c, "v_all", lambda t: t[:, :-8]), "k_all / v_all must be"),
    "GQA cache": (lambda c: [_swap(c, k, lambda t: t[..., :32].contiguous()) for k in ("k_all", "v_all")],
                  "cache width 32"),
    "scratch qkvx int32": (lambda c: _swap(c["scratch"], "qkvx", lambda t: t.int()), "scratch qkvx must be"),
    "scratch part short": (lambda c: _swap(c["scratch"], "part", lambda t: t[:, :1].contiguous()),
                           "scratch part must be"),
    "scratch actx short": (lambda c: _swap(c["scratch"], "actx", lambda t: t[:-1]), "scratch actx must be"),
    "scratch without bar": (lambda c: c["scratch"].pop("bar"), "scratch lacks 'bar'"),
}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("fault", [None, *PLAN_FAULTS])
def test_half_layer_plan_checks_every_tensor_once(monkeypatch, fault, bits):
    """``plan_half_layers`` checks every layer's weights, the residual, the
    caches, the widths and the scratch at plan time and names what the
    kernels cannot take; what it passes, it plans (on the CPU, for the
    plain half-layers)."""
    monkeypatch.setattr(decode_step, "_lib_int", _LIB.__getitem__)
    cfg, c = _plan_inputs(bits)
    if fault is None:
        plan = decode_step.plan_half_layers(c["h"], c["layers"], c["invf"], c["k_all"], c["v_all"],
                                            scratch=c["scratch"], **c["kw"])
        assert plan.n_layers == cfg.n_layers and plan.cards is None and plan.h is c["h"]
        return
    mutate, match = PLAN_FAULTS[fault]
    mutate(c)
    with pytest.raises(ValueError, match=match):
        decode_step.plan_half_layers(c["h"], c["layers"], c["invf"], c["k_all"], c["v_all"],
                                     scratch=c["scratch"], **c["kw"])


@pytest.mark.parametrize("bits", [8, 4])
def test_layers_planned_matches_the_public_half_layers_and_refuses_another_layer_count(monkeypatch, bits):
    """A planned loop runs every layer of a plan as the public half-layers
    do (on the CPU both are the plain versions: bit for bit, residual and
    cache rows), and refuses a plan made for another number of layers."""
    monkeypatch.setattr(decode_step, "_lib_int", _LIB.__getitem__)
    cfg, c = _plan_inputs(bits, seed=22)
    h, k, v = c["h"], c["k_all"], c["v_all"]
    hp, kp, vp = h.clone(), k.clone(), v.clone()
    plan = decode_step.plan_half_layers(h, c["layers"], c["invf"], k, v, **c["kw"])
    for t in (20, 21):
        decode_step.layers_planned(plan, t, 3, cfg.n_layers)
        for l, lw in enumerate(c["layers"]):
            decode_step.attn_step(hp, *(lw[n] for n in decode_step.ATTN_KEYS), c["invf"], kp[l], vp[l], t, 3,
                                  **c["kw"])
            decode_step.mlp_step(hp, *(lw[n] for n in decode_step.MLP_KEYS), eps=cfg.norm_eps)
        assert torch.equal(h, hp) and torch.equal(k, kp) and torch.equal(v, vp)
    with pytest.raises(ValueError, match="plan holds 2 layers, the LM 3"):
        decode_step.layers_planned(plan, 22, 3, cfg.n_layers + 1)
    with pytest.raises(ValueError, match="t"):
        decode_step.attn_step_planned(plan, 0, 40, 3)    # t past the cache's slots
    with pytest.raises(ValueError, match="k_all / v_all must be"):   # caches of another layer count
        decode_step.plan_half_layers(h, c["layers"][:1], c["invf"], k, v, **c["kw"])


def _generate_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    text = rng.integers(16, 200, (1, 10)).astype(np.int32)
    sty = rng.integers(0, 64, (1, 6)).astype(np.int32)
    spk = rng.standard_normal((1, cfg.spk_dim)).astype(np.float32)
    return text, sty, spk


def _port_generate(tp, decode_params, text, sty, spk, n, **kw):
    tcfg = tiny_config().token_lm
    return tlm.generate_speech_from_ids(
        tp, tcfg, torch.from_numpy(text), torch.tensor([10]), torch.from_numpy(sty),
        torch.tensor([6]), torch.from_numpy(spk), None, max_new_tokens=n,
        decode_params=decode_params, sampler=SamplerConfig(greedy=True), **kw)


def test_list_flavour_greedy_matches_jax_scan_and_mega_flavour():
    cfg, jp, tp = _tiny_lm(3)
    tcfg = tiny_config().token_lm
    text, sty, spk = _generate_inputs(cfg, 3)
    want = jlm.generate_speech_from_ids(
        jp, cfg, jnp.asarray(text), jnp.asarray([10]), jnp.asarray(sty), jnp.asarray([6]),
        jnp.asarray(spk), jax.random.PRNGKey(0), max_new_tokens=24,
        sampler=JSampler(greedy=True), fused=False)
    mp = tlm.mega_decode_params(tp, tcfg)
    shared = tlm.share_decode_weights(tp, mp)
    layers = tlm.unstack_decode_params(shared, tcfg)
    assert len(layers) == tcfg.n_layers
    assert layers[1]["wd"].data_ptr() == mp["wd"][1].data_ptr()      # views of the one int8 copy
    copied = tlm.unstack_decode_params(tp, tcfg)                     # input-major params: copies
    assert torch.equal(copied[1]["wd"], layers[1]["wd"]) and torch.equal(copied[0]["wqs"], layers[0]["wqs"])
    got_list = _port_generate(shared, layers, text, sty, spk, 24)
    got_mega = _port_generate(shared, mp, text, sty, spk, 24)
    np.testing.assert_array_equal(got_list.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got_list.tokens.numpy(), got_mega.tokens.numpy())
    assert int(got_list.lengths[0]) == int(want.lengths[0]) == int(got_mega.lengths[0])
    # fused=False takes the scanned decode, as in the reference
    got_scan = _port_generate(shared, layers, text, sty, spk, 24, fused=False)
    np.testing.assert_array_equal(got_scan.tokens.numpy(), np.asarray(want.tokens))


def test_list_flavour_stops_at_eos_and_draws_from_the_generator(monkeypatch):
    """Token i is sampled on the host from the previous logits, then runs at
    slot P + i; the loop ends at EOS without running the layers again."""
    cfg = tiny_config().token_lm
    _, _, tp = _tiny_lm(4)
    layers = tlm.unstack_decode_params(tp, cfg)
    slots = []
    real = decode_step.attn_step_planned

    def spy(plan, l, t, off):   # the loop's attention half-layers, on its plan of the layers
        slots.append(t)
        return real(plan, l, t, off)

    monkeypatch.setattr(decode_step, "attn_step_planned", spy)
    script = iter([5, 7, cfg.speech_eos])
    suppressed = []

    def scripted(logits, sampler, generator):
        suppressed.append(bool(logits[0, cfg.speech_eos] <= -1e29))
        return torch.tensor([next(script)], dtype=torch.int32)

    monkeypatch.setattr(tlm, "sample", scripted)
    text = torch.randint(16, 200, (1, 8), generator=torch.Generator().manual_seed(0)).int()
    out = tlm.generate_speech_from_ids(
        tp, cfg, text, torch.tensor([8]), torch.zeros((1, 4), dtype=torch.int32), torch.tensor([4]),
        torch.zeros((1, cfg.spk_dim)), None, max_new_tokens=16, decode_params=layers, min_tokens=2)
    assert out.tokens[0, :3].tolist() == [5, 7, cfg.speech_eos]
    assert all(t == cfg.speech_pad for t in out.tokens[0, 3:].tolist())
    assert int(out.lengths[0]) == 2 and out.decode_steps == 2
    assert slots == [128, 128, 129, 129]          # 2 tokens x 2 layers at P, P + 1
    assert suppressed == [True, True, False]


def _unpack_jax_int4(packed):
    """The JAX byte layout (signed high nibble, offset-binary low nibble,
    output channels (c, c + C/2) per byte) -> int values [..., C]."""
    v = np.asarray(packed).astype(np.int32)
    hi = np.floor_divide(v, 16)
    lo = v - 16 * hi - 8
    return np.concatenate([lo, hi], axis=-1)


def test_int4_values_and_scales_equal_jax_packer():
    cfg, jp, tp = _tiny_lm(5)
    tcfg = tiny_config().token_lm
    L, D, F, V, tf = cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.speech_vocab_size, 64
    jm = jlm.mega_decode_params(jp, cfg, tile_f=tf, bits=4)
    tm = tlm.mega_decode_params(tp, tcfg, bits=4)
    assert decode_step.weight_bits(tm) == 4 and tm["wqkv"].dtype == torch.int8
    assert tm["wqkv"].shape == (L, 3 * D, D // 2) and tm["wd"].shape == (L, D, F // 2)
    got = {k: decode_step.unpack4(tm[k]).numpy() for k in decode_step.WEIGHT_KEYS}
    # un-permute the JAX layouts into output-major rows
    q = _unpack_jax_int4(jm["wqkv3"])                                   # [L, 3, D, N]
    want = {"wqkv": q.transpose(0, 1, 3, 2).reshape(L, 3 * D, D)}
    want["wo"] = _unpack_jax_int4(jm["wo"]).transpose(0, 2, 1)           # [L, N, D] -> [L, D, N]
    gu = _unpack_jax_int4(jm["wgu_t"])                                  # [L, JM, D, 2*tf]
    g = gu[..., :tf].transpose(0, 1, 3, 2).reshape(L, F, D)
    u = gu[..., tf:].transpose(0, 1, 3, 2).reshape(L, F, D)
    want["wgu"] = np.concatenate([g, u], axis=1)
    want["wd"] = _unpack_jax_int4(jm["wd_t"]).reshape(L, F, D).transpose(0, 2, 1)
    head = _unpack_jax_int4(jm["head_t"])                               # [JH, D, TV]
    want["head"] = head.transpose(1, 0, 2).reshape(D, -1)[:, :V].T
    for k in decode_step.WEIGHT_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    gs = np.asarray(jm["wgus_t"])                                       # [L, JM, 1, 2*tf]
    scales = {
        "wqs": np.asarray(jm["wqs3"]).reshape(L, 3 * D),
        "wos": np.asarray(jm["wos"]).reshape(L, D),
        "wgus": np.concatenate([gs[..., :tf].reshape(L, F), gs[..., tf:].reshape(L, F)], axis=1),
        "wds": np.asarray(jm["wds"]).reshape(L, D),
        "head_s": np.asarray(jm["head_s"]).transpose(1, 0, 2).reshape(-1)[:V],
    }
    for k, w in scales.items():
        np.testing.assert_array_equal(tm[k].numpy(), w, err_msg=k)
    for k in ("emb", "invf", "attn_norm", "mlp_norm", "final_norm"):     # untouched by the packing
        assert tm[k].dtype != torch.int8
    with pytest.raises(ValueError, match="packed already"):
        tlm.requantize_int4(tm)
    with pytest.raises(ValueError, match="even"):
        decode_step.pack4(torch.zeros((2, 3), dtype=torch.int8))
    r = torch.randint(-8, 8, (3, 5, 32), generator=torch.Generator().manual_seed(0)).to(torch.int8)
    assert torch.equal(decode_step.unpack4(decode_step.pack4(r)), r)


# ------------------------------------------------- int4 on the tensor cores: the layout and the sums
# The int4 kernels read pack4's mma fragment order and sum the exact bf16
# products in their own f32 order (matvec4_plain); an f32 sum of C exact
# products in any order lies within 2 C 2^-24 sum|w x| of the exact sum.


@pytest.mark.parametrize("shape", [(2, 35, 128), (16, 64), (3, 5, 32), (40, 96), (10,), (2, 16, 160),
                                   (17, 32), (16, 48)])
def test_int4_fragment_layout_round_trips_and_places_every_nibble(shape):
    """pack4 / unpack4 round-trip; in complete row-groups of 16 over a width
    that is a multiple of 32, lane L = 4 g + q's word s of tile kt holds in
    nibble t row g + 8 (t & 1), element 64 kt + 16 s + 8 ((t >> 1) & 1) +
    2 q + (t >> 2) (its A fragment of k-step s), 16 bytes a lane in a tile
    and 8 in the half tile that ends a width of 32 mod 64; other rows and
    widths keep the plain byte order (element 2j low, 2j + 1 high)."""
    q = torch.randint(-8, 8, shape, generator=torch.Generator().manual_seed(len(shape))).to(torch.int8)
    b = decode_step.pack4(q)
    assert b.shape == shape[:-1] + (shape[-1] // 2,) and b.dtype == torch.int8
    assert torch.equal(decode_step.unpack4(b), q)
    u = (b.to(torch.int16) & 0xFF).reshape(-1, *b.shape[-2:]) if len(shape) > 1 else (b.to(torch.int16) & 0xFF)[None, None]
    v = (q.to(torch.int16) + 8).reshape(-1, *q.shape[-2:]) if len(shape) > 1 else (q.to(torch.int16) + 8)[None, None]
    C = shape[-1]
    rt = (v.shape[1] // 16 * 16) if C % 32 == 0 else 0
    for m in range(v.shape[0]):
        for j in range(rt // 16):
            grp = u[m, 16 * j:16 * j + 16].reshape(-1)
            for kt in range(-(-C // 64)):
                steps = min(4, C // 16 - 4 * kt)
                for L in range(32):
                    g, qq = divmod(L, 4)
                    for st in range(steps):
                        for t in range(8):
                            byte = int(grp[kt * 512 + L * 4 * steps + st * 4 + t // 2])
                            row = 16 * j + g + 8 * (t & 1)
                            k = 64 * kt + 16 * st + 8 * ((t >> 1) & 1) + 2 * qq + (t >> 2)
                            assert (byte >> (4 * (t % 2))) & 15 == int(v[m, row, k])
        plain = v[m, rt:, 0::2] | (v[m, rt:, 1::2] << 4)
        assert torch.equal(u[m, rt:], plain)


@pytest.mark.parametrize("R,C,slices", [(48, 64, 8), (35, 128, 8), (64, 256, 4), (19, 1024, 8),
                                          (32, 96, 8), (16, 32, 4), (40, 160, 2)])
def test_matvec4_kernel_order_matches_the_exact_product(R, C, slices):
    """The kernel's order of f32 sums (mma k-steps, even / odd
    accumulators, warps in order) and the plain f32 product, each within
    the f32 bound of the exact sum; rows past the last group of 16 are the
    plain product."""
    rng = np.random.default_rng(R * C)
    q = torch.from_numpy(rng.integers(-8, 8, (R, C)).astype(np.int8))
    x = torch.from_numpy(rng.standard_normal(C).astype(np.float32)).to(torch.bfloat16).float()
    exact = q.double() @ x.double()
    bound = 2 * C * 2.0 ** -24 * (q.double().abs() @ x.double().abs())
    got = decode_step.matvec4_plain(q, x, slices)
    assert got.dtype == torch.float32
    assert bool(((got.double() - exact).abs() <= bound).all())
    assert bool(((decode_step.matvec_plain(q, x).double() - exact).abs() <= bound).all())
    tail = R // 16 * 16
    assert torch.equal(got[tail:], decode_step.matvec_plain(q, x)[tail:])


def test_int4_kernel_order_matches_plain_step_and_half_layers():
    """The int4 step and its half-layers with the kernel's order of sums
    (matvec4_plain) against the plain product, on the JAX-initialised tiny
    LM re-quantized to int4; the half-layer wrappers take the packed rows.
    Tolerances: the logits and qkv within the f32 bound; the bf16 residual
    and cache rows within 2e-2 of max(|h|, 1) (a sum in another order may
    flip one bf16 rounding); the greedy token equal."""
    cfg, _, tp = _tiny_lm(11)
    tcfg = tiny_config().token_lm
    mp4 = tlm.mega_decode_params(tp, tcfg, bits=4)
    mpu = decode_step.unpack_decode_params(mp4)
    L, N, S, off, t = cfg.n_layers, cfg.dim, 40, 3, 29
    rng = np.random.default_rng(11)
    kc = torch.from_numpy((rng.standard_normal((L, S, N)) * 0.5).astype(np.float32)).to(torch.bfloat16)
    vc = torch.from_numpy((rng.standard_normal((L, S, N)) * 0.5).astype(np.float32)).to(torch.bfloat16)
    kw = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim, eps=cfg.norm_eps)
    tok = torch.tensor([7], dtype=torch.int32)
    skw = dict(pad_id=tcfg.speech_pad, bos_id=tcfg.speech_bos, eos_id=tcfg.speech_eos)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    h_want, t_want = decode_step.mega_decode_step_plain(tok, mp4, k1, v1, t, off, False, 0, **kw, **skw)
    h_got, t_got = decode_step.mega_decode_step_plain(tok, mp4, k2, v2, t, off, False, 0, **kw, **skw,
                                                      matvec=decode_step.matvec4_plain)
    scale = max(float(h_want.float().abs().max()), 1.0)
    assert float((h_got.float() - h_want.float()).abs().max()) <= 2e-2 * scale
    assert float((k2[:, t].float() - k1[:, t].float()).abs().max()) <= 2e-2 * scale
    assert int(t_got[0]) == int(t_want[0])
    logits = decode_step.head_logits_plain(h_want, mpu, cfg.norm_eps)
    logits4 = decode_step.head_logits_plain(h_want, mpu, cfg.norm_eps, decode_step.matvec4_plain)
    xn = (h_want.float() * torch.rsqrt((h_want.float() ** 2).mean() + cfg.norm_eps) * mpu["final_norm"])
    xn = xn.reshape(-1).to(torch.bfloat16).float()
    bound = 2 * cfg.dim * 2.0 ** -24 * ((mpu["head"].double().abs() @ xn.double().abs()) * mpu["head_s"].double())
    assert bool(((logits4.double() - logits.double()).abs() <= 2 * bound).all())
    # the half-layers: the wrappers on packed int4 rows (the CPU takes the plain product)
    h0 = torch.from_numpy((rng.standard_normal((1, cfg.dim)) * 0.5).astype(np.float32)).to(torch.bfloat16)
    a4 = (mp4["attn_norm"][1], mp4["wqkv"][1], mp4["wqs"][1], mp4["wo"][1], mp4["wos"][1], mp4["invf"])
    au = (mpu["attn_norm"][1], mpu["wqkv"][1], mpu["wqs"][1], mpu["wo"][1], mpu["wos"][1], mpu["invf"])
    k3, v3 = kc[1].clone(), vc[1].clone()
    h = decode_step.attn_step(h0.clone(), *a4, k3, v3, t, off, **kw)
    want = decode_step.attn_step_plain(h0, *au, kc[1].clone(), vc[1].clone(), t, off, **kw,
                                       matvec=decode_step.matvec4_plain)
    assert float((h.float() - want.float()).abs().max()) <= 2e-2 * max(float(want.float().abs().max()), 1.0)
    m4 = (mp4["mlp_norm"][1], mp4["wgu"][1], mp4["wgus"][1], mp4["wd"][1], mp4["wds"][1])
    mu = (mpu["mlp_norm"][1], mpu["wgu"][1], mpu["wgus"][1], mpu["wd"][1], mpu["wds"][1])
    hm = decode_step.mlp_step(want.clone(), *m4, eps=cfg.norm_eps)
    want_m = decode_step.mlp_step_plain(want, *mu, eps=cfg.norm_eps, matvec=decode_step.matvec4_plain)
    assert float((hm.float() - want_m.float()).abs().max()) <= 2e-2 * max(float(want_m.float().abs().max()), 1.0)


def _edge_tied_logits(seed, V, rows):
    """Logits with ties across every block edge (the last entry of a block
    and the first of the next) and a run of equal values over three
    blocks."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(V).astype(np.float32)
    for e in range(rows, V, rows):
        y[e] = y[e - 1]
    top = float(np.sort(y)[-4])
    y[max(0, rows - 2):min(V, 2 * rows + 2)] = top
    return torch.from_numpy(y)


@pytest.mark.parametrize("greedy,top_k", [(True, 0), (False, 0), (False, 1), (False, 2), (False, 5),
                                          (False, 25), (False, 40)])
@pytest.mark.parametrize("rows", [32, 16, 7, 3])
def test_sample_merged_matches_sample_plain(greedy, top_k, rows):
    """The step kernel's sampler (each block's list of at most k levels
    with its records, then one merge) picks ``sample_plain``'s token:
    ties at the k-th value, ties straddling block edges, k at or above
    the logits a block holds (rows 3, 7), blocks whose every id is masked
    (pad / BOS / EOS at the end of the vocabulary), fewer distinct values
    than k, and temperatures that scale masked entries below and above
    -1e30."""
    V = 67
    cases = [_tied_logits(s, V, min(max(top_k, 1), 40), tie) for s, tie in ((0, 1), (1, 3))]
    cases += [_edge_tied_logits(s, V, rows) for s in (2, 3)]
    cases.append(torch.from_numpy(np.repeat(np.float32([0.5, -1.0, 2.0]), [30, 30, 7])))
    for logits in cases:
        for temperature in (0.8, 1.5):
            for suppress, seed in ((True, 5), (False, 6)):
                kw = dict(pad_id=V - 1, bos_id=V - 3, eos_id=V - 2, suppress=suppress, greedy=greedy,
                          temperature=temperature, top_k=top_k, seed=seed)
                assert decode_step.sample_merged_plain(logits, **kw, rows=rows) == \
                    decode_step.sample_plain(logits, **kw), (kw, rows)


def test_generate_int4_matches_int8_on_four_bit_exact_weights():
    """Weights made 4-bit exact (q in [-7, 7], one 7 per output channel):
    the int4 decode must give the int8 decode's greedy tokens, in the port
    and against the JAX megakernel with bits=4 (interpret mode)."""
    from autostyle_tts_tpu.ops.quant import QTensor as JQTensor

    cfg = jtiny().token_lm
    tcfg = tiny_config().token_lm
    jp = jquantize_tree(jlm.init_params(jax.random.PRNGKey(5), cfg))
    jp = jax.tree_util.tree_map(
        lambda t: JQTensor(q=jnp.clip(t.q, -7, 7).at[..., 0, :].set(7), s=t.s) if isinstance(t, JQTensor) else t,
        jp, is_leaf=lambda x: isinstance(x, JQTensor))
    tp = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    text, sty, spk = _generate_inputs(cfg, 5)
    want = jlm.generate_speech_from_ids(
        jp, cfg, jnp.asarray(text), jnp.asarray([10]), jnp.asarray(sty), jnp.asarray([6]),
        jnp.asarray(spk), jax.random.PRNGKey(13), max_new_tokens=12, sampler=JSampler(greedy=True),
        fused=True, decode_params=jlm.mega_decode_params(jp, cfg, tile_f=64, bits=4))
    mp8 = tlm.mega_decode_params(tp, tcfg)
    mp4 = tlm.requantize_int4(mp8)
    np.testing.assert_allclose(mp4["wqs"].numpy(), mp8["wqs"].numpy(), rtol=1e-6)
    assert torch.equal(decode_step.unpack4(mp4["wgu"]), mp8["wgu"])
    got8 = _port_generate(tp, mp8, text, sty, spk, 12)
    got4 = _port_generate(tp, mp4, text, sty, spk, 12)
    np.testing.assert_array_equal(got4.tokens.numpy(), got8.tokens.numpy())
    np.testing.assert_array_equal(got4.tokens.numpy(), np.asarray(want.tokens))
    assert int(got4.lengths[0]) == int(got8.lengths[0]) == int(want.lengths[0])


def test_engine_with_int4_serves_and_keeps_int8_prefill():
    import dataclasses

    from autostyle_tts_tpu_torch.pipeline import engine as tengine
    from autostyle_tts_tpu_torch.utils.config import tiny_config as full_tiny

    cfg = full_tiny()
    cfg.quantize_lm_int8 = cfg.quantize_lm_int4 = True
    cfg.vocoder = dataclasses.replace(
        cfg.vocoder, kind="istft", istft_hop=cfg.audio.hop_length,
        istft_n_fft=4 * cfg.audio.hop_length, istft_channels=32, istft_blocks=2)
    eng = tengine.Engine(cfg, device="cpu")
    assert decode_step.weight_bits(eng._mega_params) == 4
    assert eng.params.token_lm["layers"]["wqkv"].q.shape[-2:] == (cfg.token_lm.dim, 3 * cfg.token_lm.dim)
    f = tengine.PromptFeatures(tokens=np.arange(5, dtype=np.int32), spk=np.zeros(16, np.float32),
                               mel24=np.zeros((10, 16), np.float32))
    wav = next(eng.inference_tts_with_st("hi", "style", f, f, max_seconds=1.0))["tts_speech"]
    assert wav.shape[1] > 0 and np.isfinite(wav).all()


# ------------------------------------------- split attention and tiled sampler


def _attn_vector_inputs(n, seed=0, H=4, hd=16):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    # scores a few units wide, so the running max really moves between splits
    return f(H, hd) * 3.0, f(H, hd), f(H, hd), f(n, H, hd), f(n, H, hd)


def _even_bounds(n, splits):
    per = -(-n // splits) if n else 0
    return [(min(n, s * per), min(n, (s + 1) * per)) for s in range(splits)]


@pytest.mark.parametrize("n,bounds", [
    (40, _even_bounds(40, 1)), (40, _even_bounds(40, 2)), (40, _even_bounds(40, 3)),
    (40, _even_bounds(40, 8)),
    (37, [(0, 16), (16, 32), (32, 37)]),            # ragged last split
    (37, [(0, 1), (1, 30), (30, 30), (30, 37)]),    # an empty split in the middle
    (5, _even_bounds(5, 8)),                        # more splits than slots
    (0, [(0, 0)]), (0, []),                         # t == off: the current token alone
], ids=["1", "2", "3", "8", "ragged", "empty-split", "5-in-8", "t==off", "t==off-no-bounds"])
def test_attn_split_merge_matches_one_piece(n, bounds):
    """Partials over any partition of the live slots, merged as the wo
    prologue merges them, equal the one-piece attention to 1e-6 in f32,
    before the bf16 rounding."""
    q, k, v, kc, vc = _attn_vector_inputs(n)
    want = decode_step.attn_vector_plain(q, k, v, kc, vc)
    got = decode_step.attn_vector_split_plain(q, k, v, kc, vc, bounds)
    assert got.shape == want.shape == (4, 16)
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("n", [0, 1, 7, 23, 24, 25, 220, 383, 384, 385, 1000])
def test_split_bounds_partition_the_live_slots(n):
    """The kernels' own split rule: contiguous, covering [0, n), at most
    MAX_SPLITS splits, 160 blocks of (head, split) at the flagship state."""
    b = decode_step.split_bounds(n)
    assert len(b) == decode_step.attn_splits(n) <= decode_step.MAX_SPLITS
    assert b[0][0] == 0 and b[-1][1] == n
    assert all(b[i][1] == b[i + 1][0] for i in range(len(b) - 1))
    assert all(j1 >= j0 for j0, j1 in b)
    if n == 220:
        assert 16 * len(b) >= 128


@pytest.mark.parametrize("t,off", [(21, 4), (4, 4), (47, 0)])
def test_attn_step_plain_split_path_matches_one_piece(t, off):
    """The whole half-layer through the kernels' partition: same residual
    (one bf16 ulp where a rounding flips) and the same cache row."""
    cfg, _, tp = _tiny_lm(5)
    tcfg = tiny_config().token_lm
    mp = tlm.mega_decode_params(tp, tcfg)
    rng = np.random.default_rng(6)
    S, N = 48, cfg.dim
    kc = torch.from_numpy((rng.standard_normal((S, N)) * 0.5).astype(np.float32)).to(torch.bfloat16)
    vc = torch.from_numpy((rng.standard_normal((S, N)) * 0.5).astype(np.float32)).to(torch.bfloat16)
    h = torch.from_numpy((rng.standard_normal((1, cfg.dim)) * 0.5).astype(np.float32)).to(torch.bfloat16)
    args = (mp["attn_norm"][0], mp["wqkv"][0], mp["wqs"][0], mp["wo"][0], mp["wos"][0], mp["invf"])
    kw = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim, eps=cfg.norm_eps)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    want = decode_step.attn_step_plain(h, *args, k1, v1, t, off, **kw)
    got = decode_step.attn_step_plain(h, *args, k2, v2, t, off, **kw,
                                      bounds=decode_step.split_bounds(t - off))
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=1e-2, atol=1e-2)


def _tied_logits(seed, V, k, tie):
    """Logits whose k-th largest distinct value is shared by `tie` entries,
    with more ties above and below it."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(V).astype(np.float32)
    order = np.argsort(-y)
    y[order[1]] = y[order[0]]                       # a tie at the maximum: one level
    kth = y[order[k]]                               # level k (levels 0..k-1 above it)
    y[order[k + 1:k + tie]] = kth
    y[order[k + tie + 3]] = y[order[k + tie + 2]]   # a tie below the threshold
    return torch.from_numpy(y)


@pytest.mark.parametrize("top_k", [1, 2, 5, 24, 25])
@pytest.mark.parametrize("rows", [1024, 256, 7])
def test_topk_threshold_merged_matches_reference_with_ties(top_k, rows):
    """The kernel's sampler threshold over tiles of ``rows`` logits (each
    tile's list at most k levels, then one merge: ``topk_threshold_merged``)
    on ties at and around the k-th value."""
    for seed, tie in ((0, 1), (1, 3), (2, 6)):
        y = _tied_logits(seed, 515, top_k, tie)
        want = decode_step.topk_threshold_plain(y, top_k)
        got = decode_step.topk_threshold_merged(y, top_k, rows)
        assert float(got) == float(want)


@pytest.mark.parametrize("values,top_k", [
    ([1.0, 1.0, 1.0, 1.0], 3),                      # fewer distinct values than k
    ([2.0, 1.0, -1e30, -1e30], 3),                  # masked entries at -1e30
    ([2.0, 1.0, -1.25e30, -1.25e30], 4),            # masked entries scaled below -1e30
    ([2.0, 1.0, -6.7e29, -6.7e29], 3),              # ... and above it (temperature > 1)
    ([3.0], 2),
], ids=["all-tied", "masked", "masked-below", "masked-above", "one-value"])
def test_topk_threshold_merged_degenerate_cases(values, top_k):
    """The merged threshold over tiles of 1, 2 and 1024 logits on what the
    reference treats apart: ties, masked and scaled masked entries."""
    y = torch.tensor(values, dtype=torch.float32)
    for rows in (1, 2, 1024):
        assert float(decode_step.topk_threshold_merged(y, top_k, rows)) == \
            float(decode_step.topk_threshold_plain(y, top_k))


@pytest.mark.parametrize("tie", [1, 4])
def test_sample_with_tiled_threshold_matches_sample_plain(tie):
    """The whole sampler with the kernel's selection: same scores, same
    token, with ties at the k-th value kept as the reference keeps them."""
    logits = _tied_logits(3, 67, 5, tie)
    kw = dict(pad_id=66, bos_id=64, eos_id=65, suppress=True, greedy=False,
              temperature=0.8, top_k=5, seed=11)
    want = decode_step.sample_scores_plain(logits, **kw)
    got = decode_step.sample_scores_plain(logits, **kw, threshold=decode_step.topk_threshold_merged)
    assert torch.equal(got, want)
    assert int((want > -1e29).sum()) == 5 + tie - 1 + 1    # levels 0..4, level 0 and 4 tied
    assert decode_step.sample_plain(logits, **kw, threshold=decode_step.topk_threshold_merged) == \
        decode_step.sample_plain(logits, **kw)
    assert decode_step.sample_merged_plain(logits, **kw) == decode_step.sample_plain(logits, **kw)


def test_decode_scratch_is_for_the_card_only():
    """The kernels' buffers are sized from the built library, so there are
    none on the CPU: the plain step takes no scratch and ignores one."""
    cfg, _, tp = _tiny_lm(7)
    tcfg = tiny_config().token_lm
    mp = tlm.mega_decode_params(tp, tcfg)
    with pytest.raises(ValueError, match="CUDA"):
        decode_step.decode_scratch(mp, cfg.n_heads, cfg.head_dim, "cpu")
    sc = decode_step.DecodeScratch({"h": torch.zeros(1)})
    assert sc.plan is None and list(sc) == ["h"]


@pytest.mark.parametrize("n,cap,want", [(220, 16, 10), (220, 8, 8), (220, 0, 1), (0, 8, 1),
                                        (24, 8, 1), (25, 8, 2), (1000, 99, 16)])
def test_attn_splits_cap(n, cap, want):
    """The whole step's kernel caps the splits at its blocks per head."""
    assert decode_step.attn_splits(n, cap) == want


@pytest.mark.parametrize("sms", [108, 114, 132])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("vocab", [67, 4099, 8185, 8192, 8193])
def test_step_serves_and_the_plan_take_one_rule(monkeypatch, sms, bits, vocab):
    """``step_serves`` (by which the engine picks the decode kernel) and the
    step's plan (which raises on what the kernel cannot run) agree on every
    vocabulary, whatever the card's SM count: the sampler merges a list a
    head unit, so its reach (8192) does not depend on the SMs."""
    tcfg = dataclasses.replace(tiny_config().token_lm, speech_vocab_size=vocab)
    lm = tquantize_tree(tlm.init_params(tcfg, torch.Generator().manual_seed(0)))
    mp = tlm.mega_decode_params(lm, tcfg, bits=bits)

    class Planned(Exception):
        pass

    def past_the_checks(*a, **k):
        raise Planned

    monkeypatch.setattr(decode_step, "_sms", lambda device: sms)
    monkeypatch.setattr(decode_step, "_scratch_spec", past_the_checks)   # the built library's sizes
    cache = torch.zeros((tcfg.n_layers, 8, tcfg.n_heads * tcfg.head_dim), dtype=torch.bfloat16)
    const = (tcfg.n_heads, tcfg.head_dim, tcfg.norm_eps, tcfg.speech_pad, tcfg.speech_bos,
             tcfg.speech_eos, False, 1.0, 25)
    serves = decode_step.step_serves(dim=tcfg.dim, n_heads=tcfg.n_heads, n_kv_heads=tcfg.n_kv_heads,
                                      head_dim=tcfg.head_dim, ffn_dim=tcfg.ffn_dim, vocab=vocab, bits=bits)
    assert serves == (vocab <= decode_step.MAX_VOCAB == 8192)
    with pytest.raises(Planned if serves else ValueError):
        decode_step._make_plan(mp, cache, cache.clone(), decode_step.DecodeScratch({}), const)
