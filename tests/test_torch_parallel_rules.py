"""The port's sharding rules against the JAX package's, leaf by leaf, and
the slicing they imply (pure functions: no process group but the
one-process world of the mesh-error test).

- Rules: for every leaf of the tiny engine trees (token LM f32 and int8,
  CFM, vocoder, speaker encoder, speech tokenizer), of an embedder with its
  LoRA tree and of the SFT optimizer state, the port's spec equals the
  ``PartitionSpec`` of JAX ``param_shardings(make_mesh(2, 4), tree)``.
- Slicing: every model rank's ``shard_params`` slices join back to the
  tree bitwise; a fused ``wqkv`` is cut per head block; a piece of one
  cut is rebuilt from the pieces of another that hold it (``recut``).
- Mesh errors: ``best_mesh_shape`` and ``make_mesh`` raise as JAX's do."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding

from autostyle_tts_tpu.models import transformer as jtransformer
from autostyle_tts_tpu.ops.quant import quantize_tree as jquantize_tree
from autostyle_tts_tpu.parallel.mesh import best_mesh_shape as jbest_mesh_shape
from autostyle_tts_tpu.parallel.mesh import make_mesh as jmake_mesh
from autostyle_tts_tpu.parallel.sharding import param_shardings as jparam_shardings
from autostyle_tts_tpu.pipeline.engine import EngineParams as JEngineParams
from autostyle_tts_tpu.train import lora_sft as jsft
from autostyle_tts_tpu.utils import config as jconfig
from autostyle_tts_tpu_torch.parallel import mesh as tmesh
from autostyle_tts_tpu_torch.parallel import sharding as tsh
from autostyle_tts_tpu_torch.train import lora_sft as tsft
from autostyle_tts_tpu_torch.utils.config import TrainConfig, tiny_config
from autostyle_tts_tpu_torch.weights import quantize_tree, tree_from_numpy

NP = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


class LayoutMesh:
    """A mesh's shape and one rank's place in it, without process groups."""

    def __init__(self, data, model, rank=0, data_rank=0):
        self.shape, self.model_rank, self.device = {"data": data, "model": model}, rank, torch.device("cpu")
        self.data_rank = data_rank


def _key(path) -> str:
    parts = []
    for e in path:
        for attr in ("key", "idx", "name"):
            if hasattr(e, attr):
                parts.append(str(getattr(e, attr)))
                break
    return "/".join(parts)


def _jax_specs(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(jparam_shardings(jmake_mesh(2, 4), tree),
                                                   is_leaf=lambda x: isinstance(x, NamedSharding))
    return {_key(p): tuple(s.spec) for p, s in flat}


@pytest.fixture(scope="module")
def trees():
    cfg = jconfig.tiny_config()
    eng = NP(JEngineParams.init(jax.random.PRNGKey(0), cfg).tree())
    eng["token_lm_int8"] = NP(jquantize_tree(eng["token_lm"]))
    ecfg = cfg.embedder
    eng["embedder"] = NP(jtransformer.init_params(jax.random.PRNGKey(1), ecfg))
    eng["embedder_lora"] = NP(jtransformer.init_lora(jax.random.PRNGKey(2), ecfg, 8))
    return eng


@pytest.mark.parametrize("name", ["token_lm", "token_lm_int8", "cfm", "vocoder", "speaker", "speech_tokenizer",
                                  "embedder", "embedder_lora"])
def test_specs_equal_jax_leaf_by_leaf(trees, name):
    tree = trees[name]
    want = _jax_specs(tree)
    got = tsh.param_shardings(LayoutMesh(2, 4), tree_from_numpy(tree))
    assert got == want


def test_sft_optimizer_state_specs_equal_jax(trees):
    """The moments shard like their parameters, the counts stay whole."""
    lora = trees["embedder_lora"]
    tcfg = jconfig.TrainConfig()
    jspecs = _jax_specs(jsft.make_optimizer(tcfg, 10).init(lora))
    tstate = tsft.make_optimizer(TrainConfig(), 10).init(tree_from_numpy(lora))
    tspecs = tsh.param_shardings(LayoutMesh(2, 4), tstate)
    lora_specs = tsh.param_shardings(LayoutMesh(2, 4), tree_from_numpy(lora))
    for specs in (jspecs, tspecs):
        moments = {k: v for k, v in specs.items() if "/mu/" in k or "/nu/" in k}
        assert len(moments) == 2 * len(lora_specs)
        for k, v in moments.items():
            assert v == lora_specs[k.split("/mu/")[-1].split("/nu/")[-1]], k
        assert all(v == () for k, v in specs.items() if k not in moments)


@pytest.mark.parametrize("name,heads", [("token_lm_int8", (4, 4)), ("embedder", (4, 2)), ("embedder_lora", (4, 2)),
                                        ("cfm", (4, 4)), ("speech_tokenizer", (4, 4))])
@pytest.mark.parametrize("model", [2, 4])
def test_shard_slices_join_back_bitwise(trees, name, heads, model):
    full = tree_from_numpy(trees[name])
    lay = tsh.layouts(LayoutMesh(1, model), full, heads)
    pieces = [tsh._leaves(tsh.shard_params(LayoutMesh(1, model, m), full, heads)) for m in range(model)]
    for i, (key, _, leaf, _) in enumerate(tsh._leaves(full)):
        joined = tsh.join([p[i][2] for p in pieces], lay[key])
        assert torch.equal(joined, leaf), key
    assert any(v is not None for v in lay.values())


def test_int4_row_parallel_leaves_stay_whole(trees):
    """A packed int4 ``wo`` / ``w_down`` keeps its rows; its column-parallel
    partners are cut."""
    full = quantize_tree(tree_from_numpy(trees["embedder"]), bits=4)
    lay = tsh.layouts(LayoutMesh(1, 2), full, (4, 2))
    assert lay["layers/wo/packed"] is None and lay["layers/w_down/packed"] is None
    assert lay["layers/wqkv/packed"] is not None and lay["layers/w_gate_up/packed"] is not None


def test_fused_wqkv_is_cut_per_head_block():
    H, K, hd, D = 4, 2, 3, 5
    w = torch.arange(D * (H + 2 * K) * hd, dtype=torch.float32).reshape(D, (H + 2 * K) * hd)
    q, k, v = torch.split(w, [H * hd, K * hd, K * hd], dim=-1)
    for m in range(2):
        got = tsh.cut(w, (1, (H, K, K)), 2, m)
        want = torch.cat([q[:, m * 2 * hd : (m + 1) * 2 * hd], k[:, m * hd : (m + 1) * hd],
                          v[:, m * hd : (m + 1) * hd]], dim=-1)
        assert torch.equal(got, want)


@pytest.mark.parametrize("layout", [(1, (4, 2, 2)), (0, (1,)), (1, (1, 1))])
@pytest.mark.parametrize("n_from,n_to", [(2, 1), (2, 2), (2, 4), (4, 2), (1, 4)])
def test_recut_reads_only_the_pieces_it_needs(layout, n_from, n_to):
    """A piece of an n_to-way cut built from the n_from-way pieces that
    ``sources`` names equals the piece cut from the whole leaf; at an
    unchanged count each rank reads its own piece alone."""
    w = torch.arange(8 * 32, dtype=torch.float32).reshape(8, 32)
    pieces = {s: tsh.cut(w, layout, n_from, s) for s in range(n_from)}
    for r in range(n_to):
        have = tsh.sources(n_from, n_to, r)
        if n_from == n_to:
            assert list(have) == [r]
        got = tsh.recut({s: pieces[s] for s in have}, layout, n_from, n_to, r)
        assert torch.equal(got, tsh.cut(w, layout, n_to, r))


def test_batch_rows_per_data_rank():
    mesh = LayoutMesh(4, 2, data_rank=2)
    assert tsh.batch_sharding(mesh, 8) == slice(4, 6)
    assert tsh.batch_sharding(mesh, 3) == slice(0, 3)      # fewer rows than ranks or ragged: whole
    assert tsh.batch_sharding(mesh, 6) == slice(0, 6)
    assert tsh.batch_sharding(None, 5) == slice(0, 5)


@pytest.mark.parametrize("n,model", [(8, None), (8, 2), (8, 3), (6, 4)])
def test_best_mesh_shape_equals_jax(n, model):
    try:
        want = jbest_mesh_shape(n, model)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            tmesh.best_mesh_shape(n, model)
        return
    assert tmesh.best_mesh_shape(n, model) == want


def test_make_mesh_past_the_world_raises_as_jax():
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        jmake_mesh(data=16)
    assert not dist.is_initialized()
    try:
        with pytest.raises(ValueError, match="need 2 devices, have 1"):
            tmesh.make_mesh(data=2, device="cpu")
        mesh = tmesh.make_mesh(device="cpu")        # the world of one process
        assert mesh.shape == {"data": 1, "model": 1} and mesh.backend == "gloo"
        assert (mesh.data_group, mesh.model_group) == (None, None)
    finally:
        dist.destroy_process_group()
