"""Port parity: config tree and weights carried across from the JAX package."""

import jax
import numpy as np
import pytest
import torch

from autostyle_tts_tpu.ops.quant import quantize_tree as jquantize_tree
from autostyle_tts_tpu.pipeline.engine import EngineParams as JEngineParams
from autostyle_tts_tpu.utils import checkpoint as jcheckpoint
from autostyle_tts_tpu.utils import config as jconfig
from autostyle_tts_tpu_torch.utils import config as tconfig
from autostyle_tts_tpu_torch.weights import (QTensor, from_jax_tree, load_npz,
                                             quantize_tree)


@pytest.mark.parametrize("name", ["tiny_config", "demo_config", "Config"])
def test_config_to_dict_matches(name):
    j = getattr(jconfig, name)()
    t = getattr(tconfig, name)()
    assert tconfig.to_dict(t) == jconfig.to_dict(j)
    # overrides round-trip the same way in both packages
    over = ["token_lm.n_layers=3", "cfm.n_steps=2", "quantize_lm_int8=true"]
    assert tconfig.to_dict(tconfig.apply_overrides(t, over)) == jconfig.to_dict(
        jconfig.apply_overrides(j, over))
    assert tconfig.to_dict(tconfig.from_dict(jconfig.to_dict(j))) == jconfig.to_dict(j)


def _jax_tree_numpy(cfg):
    tree = JEngineParams.init(jax.random.PRNGKey(0), cfg).tree()
    return jax.tree_util.tree_map(np.asarray, tree)


def test_from_jax_tree_quantize_bit_exact():
    """int8 q equal bit for bit (torch.round and jnp.round both round half
    to even); scales within 1e-7 (one f32 division each)."""
    cfg = jconfig.tiny_config()
    tree = _jax_tree_numpy(cfg)
    port = from_jax_tree(tree, tconfig.tiny_config())
    jq = jax.tree_util.tree_map(
        np.asarray, jquantize_tree(jax.tree_util.tree_map(jax.numpy.asarray, tree["token_lm"])))
    tq = quantize_tree(port["token_lm"])
    names = [("layers", "wqkv"), ("layers", "wo"), ("layers", "w_gate_up"),
             ("layers", "w_down"), ("speech_head",)]
    for path in names:
        j, t = jq, tq
        for p in path:
            j, t = j[p], t[p]
        assert isinstance(t, QTensor)
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
        np.testing.assert_allclose(t.s.numpy(), np.asarray(j.s), rtol=0, atol=1e-7)
    # unquantized leaves carried as they are
    np.testing.assert_array_equal(tq["tok_emb"].numpy(), tree["token_lm"]["tok_emb"])
    np.testing.assert_array_equal(port["cfm"]["layers"]["wq"].numpy(),
                                  tree["cfm"]["layers"]["wq"])


def test_from_jax_tree_rejects_wrong_shapes():
    tree = _jax_tree_numpy(jconfig.tiny_config())
    bad = tconfig.tiny_config()
    bad.token_lm = tconfig.TokenLMConfig(dim=128, n_layers=2, n_heads=4, n_kv_heads=4,
                                         ffn_dim=128, spk_dim=16)
    with pytest.raises(ValueError, match="config shape"):
        from_jax_tree(tree, bad)


def test_load_npz_reads_jax_checkpoint(tmp_path):
    """A flat-key .npz written by the JAX checkpoint writer (int8 leaves as
    q/s pairs, lists as numeric segments) loads into the same tree."""
    cfg = jconfig.tiny_config()
    tree = _jax_tree_numpy(cfg)
    lm = jquantize_tree(jax.tree_util.tree_map(jax.numpy.asarray, tree["token_lm"]))
    full = dict(tree, token_lm=lm)
    path = tmp_path / "engine.npz"
    jcheckpoint.save_pytree(str(path), full)
    got = from_jax_tree(load_npz(str(path)), tconfig.tiny_config())
    np.testing.assert_array_equal(got["token_lm"]["layers"]["wqkv"].q.numpy(),
                                  np.asarray(lm["layers"]["wqkv"].q))
    np.testing.assert_array_equal(got["vocoder"]["ups"][1]["t"]["w"].numpy(),
                                  tree["vocoder"]["ups"][1]["t"]["w"])
    assert got["cfm"]["tok_emb"].dtype == torch.float32
