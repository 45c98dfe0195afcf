"""The port's JAX-compatible key draw (``utils/rng.py``) against
``jax.random`` on the CPU, and the embedder's init drawn through it.

Bitwise: keys, ``split``, ``fold_in``, ``bits``, ``uniform`` and
``named_key``. ``truncated_normal`` within 4 ulp (its ``log1p`` is torch's,
not XLA's: 2-3 ulp at worst, ~99% of elements bitwise). The init
functions at a tiny embedder: f32 weights within 4 ulp; quantized values
equal on >= 99.99% of elements and never more than one step apart; scales
within 1e-6 relative. ``tests/fixtures/jax_base_probe.npz`` (slices of the
3B base the ft3b adapter was trained over, ``scripts/make_jax_base_probe.py``)
is held to the port's CPU draw of the same slices.
"""

import importlib.util
import math
import os
import random
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autostyle_tts_tpu.models import transformer as jcore
from autostyle_tts_tpu.utils import config as jconfig
from autostyle_tts_tpu.utils import rng as jrng
from autostyle_tts_tpu_torch.models import transformer as tcore
from autostyle_tts_tpu_torch.utils import config as tconfig
from autostyle_tts_tpu_torch.utils import rng
from autostyle_tts_tpu_torch.weights import (Q4Tensor, QTensor, _flat_keys, embedder_from_jax, lora_from_jax,
                                             quantize, unpack4)

REPO = Path(__file__).resolve().parent.parent
PROBE = REPO / "tests" / "fixtures" / "jax_base_probe.npz"
MAX_ULP = 4


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _ulps(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 5, 2**32 + 3, -1])
def test_prng_key_split_fold_in_bits_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    assert (_u32(tk) == np.asarray(jk)).all()
    assert (_u32(rng.split(tk, 12)) == np.asarray(jax.random.split(jk, 12))).all()
    assert (_u32(rng.split(tk)) == np.asarray(jax.random.split(jk))).all()
    for data in (0, 7, 2**31 + 11):
        assert (_u32(rng.fold_in(tk, data)) == np.asarray(jax.random.fold_in(jk, data))).all()
    for shape in ((5, 7), (1,), (3, 1, 9)):
        assert (_u32(rng.random_bits(tk, shape)) == np.asarray(jax.random.bits(jk, shape))).all()


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.5, 3.1), (-0.9973002, 0.9973002), (1e-3, 2e-3)])
def test_uniform_bitwise(lo, hi):
    jk, tk = jax.random.PRNGKey(9), rng.PRNGKey(9)
    got = rng.uniform(tk, (400, 33), lo, hi).numpy()
    want = np.asarray(jax.random.uniform(jk, (400, 33), jnp.float32, lo, hi))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lower,upper,shape", [(-3, 3, (300, 70)), (-2.0, 1.5, (64, 5, 9)), (-3, 3, (7,))])
def test_truncated_normal_within_ulps(lower, upper, shape):
    jk, tk = jax.random.PRNGKey(5), rng.PRNGKey(5)
    got = rng.truncated_normal(tk, lower, upper, shape).numpy()
    want = np.asarray(jax.random.truncated_normal(jk, lower, upper, shape, jnp.float32))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _ulps(got, want).max() <= MAX_ULP
    if got.size > 100:
        assert (got == want).mean() >= 0.97
    # the elements at chosen flat positions are the same draw's
    idx = torch.tensor([0, got.size - 1, got.size // 2])
    np.testing.assert_array_equal(rng.truncated_normal_at(tk, lower, upper, idx).numpy(),
                                  got.reshape(-1)[idx.numpy()])


def test_erf_and_erf_inv_follow_xla():
    """erf bitwise below XLA's saturation point (3.7439), and at the
    truncated normal's bounds; erf_inv within 2 ulp on (-1, 1)."""
    r = np.random.default_rng(0)
    x = r.uniform(-3.7, 3.7, 200_000).astype(np.float32)
    x = np.concatenate([x, np.float32([-3, 3, 2, -2.0]) / np.float32(math.sqrt(2))])
    np.testing.assert_array_equal(rng.erf(torch.from_numpy(x)).numpy(), np.asarray(jax.lax.erf(x)))
    u = np.concatenate([r.uniform(-1, 1, 200_000), 1 - r.uniform(0, 1e-3, 20_000)]).astype(np.float32)
    got, want = rng.erf_inv(torch.from_numpy(u)).numpy(), np.asarray(jax.lax.erf_inv(u))
    assert _ulps(got, want).max() <= 2 and (got == want).mean() >= 0.97
    assert bool(torch.isinf(rng.erf_inv(torch.tensor([1.0, -1.0]))).all())


def test_named_key_root_key_seed_python():
    jk, tk = jrng.root_key(3), rng.root_key(3)
    assert (_u32(tk) == np.asarray(jk)).all()
    for name in ("lm", "cfm", "biography", "语音"):
        assert (_u32(rng.named_key(tk, name)) == np.asarray(jrng.named_key(jk, name))).all()
    rng.seed_python(2**33 + 7)
    a = (random.random(), np.random.rand())
    jrng.seed_python(2**33 + 7)
    assert a == (random.random(), np.random.rand())


def test_init_params_and_lora_match_jax():
    jc, tc = jconfig.tiny_config().embedder, tconfig.tiny_config().embedder
    want = _flat_keys(embedder_from_jax(jax.tree_util.tree_map(np.asarray, jcore.init_params(
        jax.random.PRNGKey(11), jc)), tc))
    got = _flat_keys(tcore.init_params(tc, rng.PRNGKey(11)))
    assert set(got) == set(want)
    for k in want:
        assert _ulps(got[k], want[k]).max() <= MAX_ULP, k
    jl = lora_from_jax(jax.tree_util.tree_map(np.asarray, jcore.init_lora(jax.random.PRNGKey(12), jc, 8)), tc, 8)
    tl = tcore.init_lora(tc, 8, rng.PRNGKey(12))
    for k, v in _flat_keys(jl).items():
        assert _ulps(_flat_keys(tl)[k], v).max() <= MAX_ULP, k


def _assert_quant_close(got_q, want_q, got_s, want_s, what):
    diff = (got_q.astype(np.int64) - want_q.astype(np.int64))
    assert np.abs(diff).max() <= 1 and (diff == 0).mean() >= 0.9999, what
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=0, err_msg=what)


@pytest.mark.parametrize("bits", [8, 4])
def test_init_params_quantized_values_match_jax(bits):
    jc = jconfig.tiny_config().embedder
    tc = tconfig.tiny_config().embedder
    want = embedder_from_jax(jax.tree_util.tree_map(np.asarray, jcore.init_params_quantized(
        jax.random.PRNGKey(21), jc, bits=bits)), tc)
    got = tcore.init_params_quantized(tc, rng.PRNGKey(21), bits=bits)
    for name in ("wqkv", "wo", "w_gate_up", "w_down"):
        g, w = got["layers"][name], want["layers"][name]
        assert isinstance(g, Q4Tensor if bits == 4 else QTensor) and type(w) is type(g)
        gq, wq = (g.q, w.q) if bits == 8 else (unpack4(g), unpack4(w))
        _assert_quant_close(gq.numpy(), wq.numpy(), g.s.numpy(), w.s.numpy(), name)
        if bits == 4:   # the packed bytes, too
            assert (g.packed == w.packed).float().mean() >= 0.9999
    assert _ulps(got["tok_emb"], want["tok_emb"]).max() <= MAX_ULP


def _load_probe_script():
    spec = importlib.util.spec_from_file_location("make_jax_base_probe", REPO / "scripts" / "make_jax_base_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_probe_script_slices_the_jax_init():
    """The probe's per-slice draw equals the JAX package's
    ``init_params_quantized`` bit for bit (tiny geometry, both layers)."""
    probe = _load_probe_script()
    cfg = jconfig.tiny_config().embedder
    cols = (0, 1, -2, -1)
    got = probe.probe_slices(cfg, seed=42, rows=3, cols=cols)
    full = jax.tree_util.tree_map(np.asarray, jcore.init_params_quantized(jax.random.PRNGKey(42), cfg, bits=8))
    np.testing.assert_array_equal(got["tok_emb"], full["tok_emb"][:3])
    for name in ("wqkv", "w_down"):
        for l in (0, cfg.n_layers - 1):
            np.testing.assert_array_equal(got[f"{name}/{l}/q"], full["layers"][name].q[l][:, list(cols)])
            np.testing.assert_array_equal(got[f"{name}/{l}/s"], full["layers"][name].s[l])


def port_probe_slices(cfg, key: torch.Tensor, rows: int, cols, layers):
    """The port's draw of the probe's slices, without drawing the whole base."""
    shapes = tcore.proj_shapes(cfg)
    keys = rng.split(key, 12)
    scale = float(np.float32(1.0 / math.sqrt(cfg.dim)))
    out = {"tok_emb": rng.truncated_normal(keys[0], -3, 3, (rows, cfg.dim)) * scale}
    for name, ki in (("wqkv", 1), ("w_down", 7)):
        fan_in, fan_out = shapes[name]
        cidx = torch.tensor([c % fan_out for c in cols])
        flat = torch.arange(fan_in)[:, None] * fan_out + cidx[None, :]
        layer_keys = rng.split(keys[ki], cfg.n_layers)
        for l in layers:
            w = rng.truncated_normal_at(layer_keys[l], -3, 3, flat) * float(np.float32(1.0 / math.sqrt(fan_in)))
            out[f"{name}/{l}"] = quantize(w, fold_reciprocal=True)
    return out


def test_port_draw_matches_jax_base_probe():
    """The 3B base's slices (``PRNGKey(42)``, int8) drawn by the port on the
    CPU against the JAX package's."""
    probe = np.load(PROBE)
    cfg = tconfig.Config().embedder
    cols = [int(c) for c in probe["cols"]]
    L = cfg.n_layers
    got = port_probe_slices(cfg, rng.PRNGKey(int(probe["seed"])), probe["tok_emb"].shape[0], cols, (0, L - 1))
    assert _ulps(got["tok_emb"], probe["tok_emb"]).max() <= MAX_ULP
    for name in ("wqkv", "w_down"):
        for l in (0, L - 1):
            t = got[f"{name}/{l}"]
            s_cols = probe[f"{name}/{l}/s"][..., cols]
            _assert_quant_close(t.q.numpy(), probe[f"{name}/{l}/q"], t.s.numpy(), s_cols, f"{name}/{l}")


NEW_MODULES = ["utils.rng", "retrieval.milvus_import", "cli.import_milvus", "cli.retrieval_report",
               "cli.llm_bio_extract", "pipeline.simeval"]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_import_no_jax(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('autostyle_tts_tpu_torch.{module}')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'autostyle_tts_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
