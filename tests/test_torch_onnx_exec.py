"""The port's ONNX graph runner (``ops/onnx_exec.py``) and the
graph-executed campplus compat against the JAX package's
(``tests/test_onnx_exec.py``), on the CPU.

Every graph of the JAX file goes through both runners on the same feeds:
outputs within 1e-5 (float; ``Conv``/``MatMul`` sums in another order) or
equal (integers, tokens), the same errors for what neither supports.

``kaldi_fbank`` against the JAX function: within 1e-4 in every mel bin but
the lowest three, where preemphasis leaves about 1e-3 of the power and
both f32 implementations sit about 1.4e-4 from the float64 clean-room
reference of the JAX file (measured: port 1.2e-4, JAX 1.4e-4, port against
JAX 1.6e-4), so there within 3e-4; both within the JAX file's 2e-3 of the
clean-room reference. The campplus x-vector on the same fbank within 1e-4.
"""

import numpy as np
import pytest
import torch

from autostyle_tts_tpu.models.compat import campplus as jcampplus
from autostyle_tts_tpu.ops import onnx_exec as jox
from autostyle_tts_tpu_torch.models.compat import campplus
from autostyle_tts_tpu_torch.ops import onnx_exec as ox
from autostyle_tts_tpu_torch.utils import synth_release as sr
from autostyle_tts_tpu_torch.utils.onnx_load import OnnxNode, load_onnx_graph, write_onnx_model
from test_onnx_exec import _kaldi_fbank_cleanroom
from torch_one_thread import one_thread  # noqa: F401

import jax.numpy as jnp

N = OnnxNode


def _graph(tensors, nodes, inputs, outputs):
    """Round-trip through the wire format so the parser is always in play."""
    return load_onnx_graph(write_onnx_model(None, tensors, nodes, inputs, outputs))


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ the JAX file's graphs


def g_mlp():
    W1, b1, W2 = rand(0, 6, 10), rand(1, 10), rand(2, 10, 3)
    nodes = [N("Gemm", ["x", "W1", "b1"], ["h"], attrs={"alpha": 1.0, "beta": 1.0, "transB": 0}),
             N("Relu", ["h"], ["r"]), N("MatMul", ["r", "W2"], ["m"]),
             N("Softmax", ["m"], ["y"], attrs={"axis": -1})]
    return _graph({"W1": W1, "b1": b1, "W2": W2}, nodes, ["x"], ["y"]), {"x": rand(3, 4, 6)}


def g_conv2d_pool():
    nodes = [N("Conv", ["x", "W", "b"], ["c"], attrs={"kernel_shape": [3, 3], "pads": [1, 1, 1, 1],
                                                      "strides": [1, 1], "dilations": [1, 1], "group": 1}),
             N("Relu", ["c"], ["r"]),
             N("MaxPool", ["r"], ["p"], attrs={"kernel_shape": [2, 2], "strides": [2, 2], "pads": [0, 0, 0, 0]}),
             N("GlobalAveragePool", ["p"], ["gap"])]
    return _graph({"W": rand(4, 3, 2, 3, 3), "b": rand(5, 3)}, nodes, ["x"], ["gap"]), {"x": rand(6, 1, 2, 6, 6)}


def g_static_shape_plumbing():
    nodes = [N("Shape", ["x"], ["shp"]), N("Gather", ["shp", "zero"], ["b"], attrs={"axis": 0}),
             N("Unsqueeze", ["b", "zero_l"], ["b1"]), N("Concat", ["b1", "minus1"], ["tgt"], attrs={"axis": 0}),
             N("Reshape", ["x", "tgt"], ["flat"]), N("MatMul", ["flat", "W"], ["y"])]
    t = {"W": rand(7, 12, 5), "zero": np.asarray(0, np.int64), "zero_l": np.asarray([0], np.int64),
         "minus1": np.asarray([-1], np.int64)}
    return _graph(t, nodes, ["x"], ["y"]), {"x": rand(8, 3, 4, 3)}


def g_campplus():
    g = load_onnx_graph(sr.build_campplus_onnx(sr.SynthGeometry()))
    return g, {g.inputs[0]: rand(9, 1, 24, 80)}


def g_avgpool_exclude_pad():
    nodes = [N("AveragePool", ["x"], ["y"], attrs={"kernel_shape": [3], "pads": [1, 1], "strides": [1]})]
    return _graph({}, nodes, ["x"], ["y"]), {"x": np.asarray([[[3.0, 6.0, 9.0, 12.0]]], np.float32)}


def g_avgpool_include_pad():
    nodes = [N("AveragePool", ["x"], ["y"], attrs={"kernel_shape": [3], "pads": [1, 1], "strides": [1],
                                                   "count_include_pad": 1})]
    return _graph({}, nodes, ["x"], ["y"]), {"x": np.asarray([[[3.0, 6.0, 9.0, 12.0]]], np.float32)}


def g_vq_argmin_pad():
    nodes = [N("Unsqueeze", ["x", "two"], ["xu"]), N("Sub", ["xu", "cb"], ["dlt"]), N("Mul", ["dlt", "dlt"], ["sq"]),
             N("ReduceSum", ["sq"], ["d2"], attrs={"axes": [-1], "keepdims": 0}),
             N("ArgMin", ["d2"], ["code"], attrs={"axis": -1, "keepdims": 0}),
             N("Pad", ["code", "padspec"], ["y"], attrs={"mode": "constant"})]
    t = {"cb": rand(10, 7, 4), "two": np.asarray([2], np.int64), "padspec": np.asarray([0, 1, 0, 2], np.int64)}
    return _graph(t, nodes, ["x"], ["y"]), {"x": rand(11, 1, 5, 4)}


def g_comparisons_where():
    nodes = [N("Greater", ["x", "thr"], ["m"]), N("Where", ["m", "x", "zero"], ["y"])]
    t = {"thr": np.asarray(0.5, np.float32), "zero": np.asarray(0.0, np.float32)}
    return _graph(t, nodes, ["x"], ["y"]), {"x": np.asarray([[0.2, 0.7, 1.4, -3.0]], np.float32)}


def g_einsum_trilu_sincos():
    nodes = [N("Einsum", ["q", "k"], ["s"], attrs={"equation": "bthd,bshd->bhts"}), N("Sin", ["s"], ["ss"]),
             N("Cos", ["s"], ["cc"]), N("Mul", ["ss", "cc"], ["m"]), N("Trilu", ["m"], ["y"], attrs={"upper": 0})]
    return _graph({}, nodes, ["q", "k"], ["y"]), {"q": rand(12, 1, 3, 2, 4), "k": rand(13, 1, 3, 2, 4)}


def g_gather_negative_prelu():
    nodes = [N("Shape", ["x"], ["shp"]), N("Gather", ["shp", "neg1"], ["last_dim"], attrs={"axis": 0}),
             N("PRelu", ["x", "slope"], ["p"]), N("ReduceSum", ["p"], ["s"], attrs={"keepdims": 0})]
    t = {"neg1": np.asarray(-1, np.int64), "slope": np.asarray([0.1, 0.5, 2.0], np.float32)}
    return _graph(t, nodes, ["x"], ["last_dim", "s"]), {"x": rand(14, 1, 3, 5)}


def g_traced_gather_negative():
    nodes = [N("Gather", ["x", "neg1"], ["y"], attrs={"axis": 2})]
    return _graph({"neg1": np.asarray(-1, np.int64)}, nodes, ["x"], ["y"]), {"x": rand(14, 1, 3, 5)}


def g_tokenizer():
    g = load_onnx_graph(sr.build_tokenizer_graph_onnx(sr.SynthGeometry(), seed=3))
    return g, {"mel": rand(15, 1, 12, sr.SynthGeometry().n_mels)}


def g_more_ops():
    """Ops the JAX file's graphs leave out: Split, Slice with a negative
    step, reflect/edge Pad, Clip, Cast, Expand, LayerNormalization, Erf,
    Elu, LeakyRelu, exact Gelu, InstanceNormalization, Max / Min,
    ReduceMax, Flatten, Squeeze."""
    t = {"axes0": np.asarray([0], np.int64), "sizes": np.asarray([2, 3], np.int64),
         "st": np.asarray([-1], np.int64), "en": np.asarray([-100], np.int64), "ax": np.asarray([2], np.int64),
         "stp": np.asarray([-1], np.int64), "pads": np.asarray([0, 0, 2, 0, 0, 1], np.int64),
         "lo": np.asarray(-0.5, np.float32), "hi": np.asarray(0.7, np.float32),
         "shp": np.asarray([2, 4, 5], np.int64), "lns": rand(16, 5), "lnb": rand(17, 5),
         "ins": rand(18, 4), "inb": rand(19, 4)}
    nodes = [N("Split", ["x", "sizes"], ["a", "b"], attrs={"axis": 2}),
             N("Slice", ["x", "st", "en", "ax", "stp"], ["rev"]),
             N("Pad", ["rev", "pads"], ["pr"], attrs={"mode": "reflect"}),
             N("Pad", ["rev", "pads"], ["pe"], attrs={"mode": "edge"}),
             N("Clip", ["x", "lo", "hi"], ["cl"]),
             N("Cast", ["b"], ["bi"], attrs={"to": 6}),
             N("Cast", ["bi"], ["bf"], attrs={"to": 1}),
             N("LayerNormalization", ["x", "lns", "lnb"], ["ln"], attrs={"axis": -1, "epsilon": 1e-5}),
             N("Erf", ["ln"], ["er"]), N("Elu", ["er"], ["el"], attrs={"alpha": 0.7}),
             N("LeakyRelu", ["el"], ["lr"], attrs={"alpha": 0.2}), N("Gelu", ["lr"], ["ge"]),
             N("InstanceNormalization", ["ge", "ins", "inb"], ["inn"], attrs={"epsilon": 1e-5}),
             N("Max", ["inn", "cl", "x"], ["mx"]), N("Min", ["mx", "ln"], ["mn"]),
             N("ReduceMax", ["mn"], ["rm"], attrs={"axes": [1], "keepdims": 1}),
             N("Expand", ["rm", "shp"], ["ex"]), N("Add", ["ex", "a2"], ["exa"]),
             N("Flatten", ["rm"], ["fl"], attrs={"axis": 1}), N("Unsqueeze", ["fl", "axes0"], ["u"]),
             N("Squeeze", ["u", "axes0"], ["sq"])]
    nodes.insert(1, N("Concat", ["a", "a", "a"], ["a3"], attrs={"axis": 2}))
    nodes.insert(2, N("Slice", ["a3", "zero1", "five", "ax"], ["a2"]))
    t.update({"zero1": np.asarray([0], np.int64), "five": np.asarray([5], np.int64)})
    return _graph(t, nodes, ["x"], ["pr", "pe", "bf", "exa", "sq"]), {"x": rand(20, 2, 4, 5)}


GRAPHS = {f.__name__[2:]: f for f in (
    g_mlp, g_conv2d_pool, g_static_shape_plumbing, g_campplus, g_avgpool_exclude_pad, g_avgpool_include_pad,
    g_vq_argmin_pad, g_comparisons_where, g_einsum_trilu_sincos, g_gather_negative_prelu,
    g_traced_gather_negative, g_tokenizer, g_more_ops)}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_matches_the_jax_runner(name):
    g, feeds = GRAPHS[name]()
    assert ox.unsupported_ops(g) == jox.unsupported_ops(g) == []
    assert ox.op_histogram(g) == jox.op_histogram(g)
    got = ox.OnnxRunner(g)(feeds)
    want = jox.OnnxRunner(g)(feeds)
    assert len(got) == len(want) == len(g.outputs)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert isinstance(a, torch.Tensor) and tuple(a.shape) == b.shape
        if np.issubdtype(b.dtype, np.integer) or b.dtype == np.bool_:
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=1e-5)


def test_avgpool_values_and_pool_errors():
    g, feeds = g_avgpool_exclude_pad()
    np.testing.assert_allclose(ox.OnnxRunner(g)(feeds)[0][0, 0].numpy(), [4.5, 6.0, 9.0, 10.5], rtol=1e-6)
    x = feeds["x"]
    for bad in ({"kernel_shape": [3], "ceil_mode": 1}, {"kernel_shape": [3], "auto_pad": "SAME_UPPER"}):
        gb = _graph({}, [N("AveragePool", ["x"], ["y"], attrs=bad)], ["x"], ["y"])
        with pytest.raises(ValueError):
            ox.run(gb, {"x": x})
        with pytest.raises(ValueError):
            jox.run(gb, {"x": x})


def test_unsupported_ops_reported_as_in_jax():
    g = _graph({}, [N("LSTM", ["x"], ["y"])], ["x"], ["y"])
    assert ox.unsupported_ops(g) == jox.unsupported_ops(g) == ["LSTM"]
    with pytest.raises(NotImplementedError, match="LSTM"):
        ox.OnnxRunner(g)
    nodes = [N("AveragePool", ["x"], ["p"], attrs={"kernel_shape": [2], "ceil_mode": 1}),
             N("Pad", ["p", "pads", "cval", "axes"], ["y"], attrs={"mode": "constant"})]
    t = {"pads": np.asarray([1, 1], np.int64), "cval": np.asarray(0.0, np.float32), "axes": np.asarray([1], np.int64)}
    g = _graph(t, nodes, ["x"], ["y"])
    assert ox.unsupported_ops(g) == jox.unsupported_ops(g)
    assert {"AveragePool(ceil_mode=1)", "Pad(axes input)"} <= set(ox.unsupported_ops(g))


def test_shape_targets_must_be_static():
    """A Reshape whose target is computed from the data is refused, as the
    JAX runner refuses it under jit."""
    nodes = [N("Cast", ["x"], ["xi"], attrs={"to": 7}), N("Reshape", ["x", "xi"], ["y"])]
    g = _graph({}, nodes, ["x"], ["y"])
    with pytest.raises(ValueError, match="statically known"):
        ox.OnnxRunner(g)({"x": np.asarray([2.0, 1.0], np.float32)})


def test_tokenizer_graph_matches_the_rule_converted_module():
    """The two serving paths of one tokenizer artifact agree in the port:
    the rule-converted ``s3_tokenizer`` and the node graph through the
    runner (same seed = same weights): equal tokens."""
    from autostyle_tts_tpu_torch.models.compat import s3_tokenizer
    from autostyle_tts_tpu_torch.utils import cosyvoice_convert as cc
    from autostyle_tts_tpu_torch.weights import compat_trees_to_torch

    geo = sr.SynthGeometry()
    tree, report = cc.apply_rules(sr.build_tokenizer_onnx(geo, seed=3), cc.RULESETS["speech_tokenizer_v1.onnx"])
    assert report.unmapped_src == []
    tt = compat_trees_to_torch({"s3": tree}, "cpu")["s3"]
    mel = rand(4, 1, 12, geo.n_mels)
    toks, _ = s3_tokenizer.encode(tt, s3_tokenizer.infer_config(tt, n_heads=2), torch.from_numpy(mel),
                                  torch.ones((1, 12)))
    g = load_onnx_graph(sr.build_tokenizer_graph_onnx(geo, seed=3))
    toks_graph, hidden = ox.OnnxRunner(g)({"mel": mel})
    assert bool(torch.isfinite(hidden).all())
    np.testing.assert_array_equal(toks.numpy()[0], toks_graph.numpy()[0])


# ------------------------------------------------------------------ campplus


def _voiced(seconds=2.0, gated=False):
    rng = np.random.default_rng(0)
    t = np.arange(int(16000 * seconds)) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
         + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    if gated:
        x[4000:12000] = 0.0
        x[20000:24000] *= 1e-5
    return x


@pytest.mark.parametrize("gated", [False, True])
def test_kaldi_fbank_matches_jax_and_the_cleanroom_reference(gated):
    wav = _voiced(gated=gated)
    got = campplus.kaldi_fbank(torch.from_numpy(wav)).numpy()
    want = np.asarray(jcampplus.kaldi_fbank(jnp.asarray(wav)))
    ref = _kaldi_fbank_cleanroom(wav.astype(np.float64))
    assert got.shape == want.shape == ref.shape
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=3e-4, rtol=0)
    np.testing.assert_allclose(got, ref, atol=2e-3)
    np.testing.assert_allclose(got.mean(axis=0), 0.0, atol=1e-4)


def test_campplus_embedding_matches_jax():
    blob = sr.build_campplus_onnx(sr.SynthGeometry())
    comp, jcomp = campplus.CampPlusCompat(blob), jcampplus.CampPlusCompat(blob)
    feat = np.asarray(jcampplus.kaldi_fbank(jnp.asarray(_voiced(1.0))))
    got = comp.embed_fbank(torch.tensor(feat))
    want = jcomp.embed_fbank(jnp.asarray(feat))
    assert got.shape == (sr.SynthGeometry().spk_dim,)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    for bucket in (False, True):
        np.testing.assert_allclose(comp.embed_wav16(_voiced(1.0), bucket=bucket),
                                   jcomp.embed_wav16(_voiced(1.0), bucket=bucket), atol=1e-4, rtol=1e-4)


def test_campplus_short_prompt_rejected():
    comp = campplus.CampPlusCompat(sr.build_campplus_onnx(sr.SynthGeometry()))
    with pytest.raises(ValueError, match="too short"):
        comp.embed_wav16(np.zeros(campplus.FRAME_LEN - 1, np.float32))
