"""The port's int4 weights (``weights.Q4Tensor`` and friends) against the
JAX package's ``ops/quant.py`` on the CPU.

On the same f32 weights the packed bytes and the scales are equal (both
divide by 7 eagerly); ``unpack4`` / ``dequantize4`` equal; ``q4matmul`` and
``matmul_any`` close in f32 (1e-5 of the output's scale: the two packages sum
in another order); ``quantize_tree(bits=4)`` quantizes the same leaves; the
flat-key files round-trip between the packages; an int4 tiny embedder's
embeddings agree to 1e-5 (f32 activations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autostyle_tts_tpu.models import frontend
from autostyle_tts_tpu.models import transformer as jcore
from autostyle_tts_tpu.ops import quant as jquant
from autostyle_tts_tpu.pipeline import rag as jrag
from autostyle_tts_tpu.utils import checkpoint as jckpt
from autostyle_tts_tpu.utils import config as jconfig
from autostyle_tts_tpu_torch.models import transformer as tcore
from autostyle_tts_tpu_torch.pipeline import rag as trag
from autostyle_tts_tpu_torch.utils import config as tconfig
from autostyle_tts_tpu_torch.utils import rng
from autostyle_tts_tpu_torch.weights import (Q4Tensor, QTensor, _flat_keys, dequantize4, embedder_from_jax, load_npz,
                                             load_tree, q4matmul, quantize4, quantize_tree, save_tree, unpack4)


def _w(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 32), (3, 128, 48), (2, 10, 7)])
def test_quantize4_packing_byte_equal(shape):
    w = _w(shape)
    jt = jquant.quantize4(jnp.asarray(w))
    tt = quantize4(torch.from_numpy(w))
    assert tt.packed.dtype == torch.uint8 and tuple(tt.packed.shape) == shape[:-2] + (shape[-2] // 2, shape[-1])
    np.testing.assert_array_equal(tt.packed.numpy(), np.asarray(jt.packed))
    np.testing.assert_array_equal(tt.s.numpy(), np.asarray(jt.s))
    np.testing.assert_array_equal(unpack4(tt).numpy(), np.asarray(jquant.unpack4(jt)))
    np.testing.assert_array_equal(dequantize4(tt).numpy(), np.asarray(jquant.dequantize4(jt)))
    assert int(unpack4(tt).abs().max()) <= 7


def test_quantize4_rejects_odd_contraction():
    with pytest.raises(ValueError, match="even contraction dim"):
        quantize4(torch.zeros(5, 4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q4matmul_and_matmul_any(dtype):
    w, x = _w((96, 40), 1), _w((3, 5, 96), 2)
    jt = jquant.quantize4(jnp.asarray(w))
    tt = quantize4(torch.from_numpy(w))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jquant.q4matmul(jx, jt).astype(jnp.float32))
    got = q4matmul(tx, tt)
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol * np.abs(want).max())
    want_any = np.asarray(jcore.matmul_any(jx, jt))
    got_any = tcore.matmul_any(tx, tt)
    assert got_any.dtype == torch.float32
    np.testing.assert_allclose(got_any.numpy(), want_any, rtol=tol, atol=tol * np.abs(want_any).max())
    # the same product as the dequantized weight's
    dq = dequantize4(tt)
    np.testing.assert_allclose(q4matmul(torch.from_numpy(x), tt).numpy(), torch.from_numpy(x) @ dq,
                               rtol=1e-5, atol=1e-5 * float(dq.abs().max()) * 96)


def test_quantize_tree_bits4_matches_jax():
    cfg = jconfig.tiny_config().embedder
    jp = jax.tree_util.tree_map(np.asarray, jcore.init_params(jax.random.PRNGKey(4), cfg))
    want = jax.tree_util.tree_map(np.asarray, jquant.quantize_tree(jax.tree_util.tree_map(jnp.asarray, jp), bits=4))
    got = quantize_tree(embedder_from_jax(jp, tconfig.tiny_config().embedder), bits=4)
    assert isinstance(got["layers"]["wqkv"], Q4Tensor) and isinstance(got["lm_head"], Q4Tensor)
    assert got["tok_emb"].dtype == torch.float32
    want_t = _flat_keys(embedder_from_jax(want, tconfig.tiny_config().embedder))
    for k, v in _flat_keys(got).items():
        np.testing.assert_array_equal(v.numpy(), want_t[k].numpy(), err_msg=k)
    assert isinstance(quantize_tree({"wo": torch.zeros(4, 4)}, bits=8)["wo"], QTensor)
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        quantize_tree({}, bits=3)


def test_int4_checkpoint_round_trip(tmp_path):
    """An int4 tree written by either package loads in the other
    (``<name>/packed`` and ``<name>/s`` keys)."""
    cfg_t, cfg_j = tconfig.tiny_config().embedder, jconfig.tiny_config().embedder
    jp = jcore.init_params_quantized(jax.random.PRNGKey(2), cfg_j, bits=4)
    jckpt.save_pytree(tmp_path / "j.npz", jp)
    tree = embedder_from_jax(load_npz(tmp_path / "j.npz"), cfg_t)
    assert isinstance(tree["layers"]["w_down"], Q4Tensor)
    like = tcore.init_params_quantized(cfg_t, rng.PRNGKey(0), bits=4)
    back = load_tree(tmp_path / "j.npz", like)
    save_tree(str(tmp_path / "t.npz"), back)
    again = jckpt.load_pytree(tmp_path / "t.npz", jp)
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for k, v in _flat_keys(tree).items():
        np.testing.assert_array_equal(v.numpy(), _flat_keys(back)[k].numpy())


def test_int4_embedder_embed_matches_jax():
    kw = dict(vocab_size=frontend.VOCAB_SIZE, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=64,
              max_seq_len=1600, dtype="float32")
    jcfg, tcfg = jconfig.TransformerConfig(**kw), tconfig.TransformerConfig(**kw)
    jp = jcore.init_params_quantized(jax.random.PRNGKey(3), jcfg, bits=4)
    tp = embedder_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    assert isinstance(tp["layers"]["wqkv"], Q4Tensor)
    texts = ["hello world", "an int4 base embeds this line", "你好"]
    want = jrag.EmbedderService(jcfg, jp).embed(texts)
    got = trag.EmbedderService(tcfg, tp, device="cpu").embed(texts)
    np.testing.assert_allclose(got, want, atol=1e-5)
