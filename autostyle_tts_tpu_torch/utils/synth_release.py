"""Synthetic CosyVoice-300M release directories.

Counterpart of the JAX ``utils/synth_release.py``, a copy of its code with
the same torch and numpy draws: a release built by either copy from the
same seeds (and the same global torch RNG state, which the weight-norm
gains draw from) is byte-identical. ``llm.pt`` / ``flow.pt`` / ``hift.pt``
/ ``speech_tokenizer_v1.onnx`` / ``campplus.onnx`` carry the key names and
shape relations of the documented upstream topologies (wenet
TransformerLM, Matcha-style ConditionalDecoder flow, HiFT/NSF vocoder) at
a configurable geometry: ``SynthGeometry()`` is tiny; the published
CosyVoice-300M widths are expressible but for the gaps listed in
``PERF.md``.

Three additions, whose defaults keep the JAX copy's bytes:

- ``SynthGeometry.n_positions`` (64): rows of the tokenizer's positional
  table, which bounds the tokens one prompt can give (whisper's is 1500);
- ``SynthGeometry.s3_mels`` (0: ``n_mels``): the tokenizer's mel bins
  (the published tokenizer takes 128, the flow 80);
- ``scale`` of the builders (0.3, the JAX copy's draw scale, chosen for
  16-wide layers): ``"fan_in"`` draws each matrix or conv weight at
  1 / sqrt(fan-in) (the product of its dimensions after the first) and
  each vector at 0.3. At 1024 wide, 0.3 saturates the attention (scores
  of std ~92, the largest probability 0.96 on average in a trunk layer):
  the outputs stay finite, but the greedy decode then turns f32 rounding
  into different tokens (``PERF.md``). Full widths draw at fan-in.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Union

Scale = Union[float, str]


@dataclass(frozen=True)
class SynthGeometry:
    text_vocab: int = 40
    text_in: int = 12
    text_dim: int = 16
    n_text_layers: int = 2
    llm_dim: int = 16
    n_llm_layers: int = 2
    n_heads: int = 2
    ffn: int = 24
    speech_vocab: int = 20
    spk_dim: int = 12
    # flow
    flow_emb: int = 12
    flow_dim: int = 16
    n_flow_layers: int = 2
    n_mels: int = 8
    est_channels: tuple = (16, 16)
    n_tf: int = 1
    n_mid: int = 1
    # hift
    hift_channels: int = 16
    up_rates: tuple = (2, 2)
    resblock_kernels: tuple = (3, 5)
    n_res_convs: int = 2            # convs per resblock (dilations 1,3)
    istft_n_fft: int = 8
    nb_harmonics: int = 3
    n_positions: int = 64           # tokenizer positional-table rows
    s3_mels: int = 0                # tokenizer mel bins (0: n_mels)


def _draw_scale(shape, scale: Scale) -> float:
    """The scale of one draw: ``scale`` itself, or for ``"fan_in"`` the
    inverse square root of the product of the dimensions after the first
    (a vector: 0.3)."""
    if scale != "fan_in":
        return float(scale)
    fan_in = 1
    for d in shape[1:]:
        fan_in *= int(d)
    return fan_in ** -0.5 if len(shape) > 1 else 0.3


def _seeded(seed: int, scale: Scale = 0.3):
    import torch

    g = torch.Generator().manual_seed(seed)

    def t(*shape):
        return torch.randn(*shape, generator=g) * _draw_scale(shape, scale)

    return t


def _encoder_sd(prefix: str, t, in_dim: int, dim: int, n_layers: int,
                heads: int, ffn: int, macaron: bool, cnn: bool,
                in_norm: bool, transformer_norms: bool) -> Dict:
    import torch

    hd = dim // heads
    sd = {
        f"{prefix}.embed.out.0.weight": t(dim, in_dim),
        f"{prefix}.embed.out.0.bias": t(dim),
        f"{prefix}.after_norm.weight": torch.ones(dim),
        f"{prefix}.after_norm.bias": torch.zeros(dim),
    }
    if in_norm:
        sd[f"{prefix}.embed.out.1.weight"] = torch.ones(dim)
        sd[f"{prefix}.embed.out.1.bias"] = torch.zeros(dim)
    for i in range(n_layers):
        e = f"{prefix}.encoders.{i}"
        sd.update({
            f"{e}.self_attn.linear_q.weight": t(dim, dim),
            f"{e}.self_attn.linear_q.bias": t(dim),
            f"{e}.self_attn.linear_k.weight": t(dim, dim),
            f"{e}.self_attn.linear_k.bias": t(dim),
            f"{e}.self_attn.linear_v.weight": t(dim, dim),
            f"{e}.self_attn.linear_v.bias": t(dim),
            f"{e}.self_attn.linear_out.weight": t(dim, dim),
            f"{e}.self_attn.linear_out.bias": t(dim),
            f"{e}.self_attn.linear_pos.weight": t(dim, dim),
            f"{e}.self_attn.pos_bias_u": t(heads, hd),
            f"{e}.self_attn.pos_bias_v": t(heads, hd),
            f"{e}.feed_forward.w_1.weight": t(ffn, dim),
            f"{e}.feed_forward.w_1.bias": t(ffn),
            f"{e}.feed_forward.w_2.weight": t(dim, ffn),
            f"{e}.feed_forward.w_2.bias": t(dim),
        })
        norm_names = (["norm1", "norm2"] if transformer_norms
                      else ["norm_mha", "norm_ff"])
        if macaron:
            sd.update({
                f"{e}.feed_forward_macaron.w_1.weight": t(ffn, dim),
                f"{e}.feed_forward_macaron.w_1.bias": t(ffn),
                f"{e}.feed_forward_macaron.w_2.weight": t(dim, ffn),
                f"{e}.feed_forward_macaron.w_2.bias": t(dim),
            })
            norm_names.append("norm_ff_macaron")
        if cnn:
            sd.update({
                f"{e}.conv_module.pointwise_conv1.weight": t(2 * dim, dim, 1),
                f"{e}.conv_module.pointwise_conv1.bias": t(2 * dim),
                f"{e}.conv_module.depthwise_conv.weight": t(dim, 1, 15),
                f"{e}.conv_module.depthwise_conv.bias": t(dim),
                f"{e}.conv_module.norm.weight": torch.ones(dim),
                f"{e}.conv_module.norm.bias": torch.zeros(dim),
                f"{e}.conv_module.pointwise_conv2.weight": t(dim, dim, 1),
                f"{e}.conv_module.pointwise_conv2.bias": t(dim),
            })
            norm_names += ["norm_conv", "norm_final"]
        for n in norm_names:
            sd[f"{e}.{n}.weight"] = torch.ones(dim)
            sd[f"{e}.{n}.bias"] = torch.zeros(dim)
    return sd


def build_llm_pt(g: SynthGeometry, seed: int = 0, scale: Scale = 0.3) -> Dict:
    t = _seeded(seed, scale)
    sd = {
        "text_embedding.weight": t(g.text_vocab, g.text_in),
        "text_encoder_affine_layer.weight": t(g.llm_dim, g.text_dim),
        "text_encoder_affine_layer.bias": t(g.llm_dim),
        "llm_embedding.weight": t(2, g.llm_dim),
        "speech_embedding.weight": t(g.speech_vocab + 1, g.llm_dim),
        "llm_decoder.weight": t(g.speech_vocab + 1, g.llm_dim),
        "llm_decoder.bias": t(g.speech_vocab + 1),
        "spk_embed_affine_layer.weight": t(g.llm_dim, g.spk_dim),
        "spk_embed_affine_layer.bias": t(g.llm_dim),
    }
    # conformer text encoder exercises macaron + cnn paths; plain
    # transformer LM trunk (norm1/norm2 spelling, no input LayerNorm)
    sd.update(_encoder_sd("text_encoder", t, g.text_in, g.text_dim,
                          g.n_text_layers, g.n_heads, g.ffn,
                          macaron=True, cnn=True, in_norm=True,
                          transformer_norms=False))
    sd.update(_encoder_sd("llm", t, g.llm_dim, g.llm_dim, g.n_llm_layers,
                          g.n_heads, g.ffn, macaron=False, cnn=False,
                          in_norm=False, transformer_norms=True))
    return sd


def build_flow_pt(g: SynthGeometry, seed: int = 1, scale: Scale = 0.3) -> Dict:
    import torch

    t = _seeded(seed, scale)
    M = g.n_mels
    ch = g.est_channels
    in_ch = 4 * M                       # x | mu | spk(->M) | cond
    tdim = 4 * ch[0]
    sd = {
        "input_embedding.weight": t(g.speech_vocab + 1, g.flow_emb),
        "spk_embed_affine_layer.weight": t(M, g.spk_dim),
        "spk_embed_affine_layer.bias": t(M),
        "encoder_proj.weight": t(M, g.flow_dim),
        "encoder_proj.bias": t(M),
        # InterpolateRegulator: [conv, GroupNorm(1), Mish] + final 1x1 conv
        "length_regulator.model.0.weight": t(M, M, 3),
        "length_regulator.model.0.bias": t(M),
        "length_regulator.model.1.weight": torch.ones(M),
        "length_regulator.model.1.bias": torch.zeros(M),
        "length_regulator.model.3.weight": t(M, M, 1),
        "length_regulator.model.3.bias": t(M),
    }
    sd.update(_encoder_sd("encoder", t, g.flow_emb, g.flow_dim,
                          g.n_flow_layers, g.n_heads, g.ffn,
                          macaron=False, cnn=False, in_norm=True,
                          transformer_norms=False))
    est = "decoder.estimator"
    sd.update({
        f"{est}.time_mlp.linear_1.weight": t(tdim, in_ch),
        f"{est}.time_mlp.linear_1.bias": t(tdim),
        f"{est}.time_mlp.linear_2.weight": t(tdim, tdim),
        f"{est}.time_mlp.linear_2.bias": t(tdim),
        f"{est}.final_block.block.0.weight": t(ch[-1], ch[-1], 3),
        f"{est}.final_block.block.0.bias": t(ch[-1]),
        f"{est}.final_block.block.1.weight": torch.ones(ch[-1]),
        f"{est}.final_block.block.1.bias": torch.zeros(ch[-1]),
        f"{est}.final_proj.weight": t(M, ch[-1], 1),
        f"{est}.final_proj.bias": t(M),
    })

    def resnet(base: str, dim_in: int, dim_out: int):
        sd.update({
            f"{base}.mlp.1.weight": t(dim_out, tdim),
            f"{base}.mlp.1.bias": t(dim_out),
            f"{base}.block1.block.0.weight": t(dim_out, dim_in, 3),
            f"{base}.block1.block.0.bias": t(dim_out),
            f"{base}.block1.block.1.weight": torch.ones(dim_out),
            f"{base}.block1.block.1.bias": torch.zeros(dim_out),
            f"{base}.block2.block.0.weight": t(dim_out, dim_out, 3),
            f"{base}.block2.block.0.bias": t(dim_out),
            f"{base}.block2.block.1.weight": torch.ones(dim_out),
            f"{base}.block2.block.1.bias": torch.zeros(dim_out),
            f"{base}.res_conv.weight": t(dim_out, dim_in, 1),
            f"{base}.res_conv.bias": t(dim_out),
        })

    def tfblocks(base: str, dim: int):
        for j in range(g.n_tf):
            b = f"{base}.{j}"
            inner = dim
            sd.update({
                f"{b}.attn1.to_q.weight": t(inner, dim),
                f"{b}.attn1.to_k.weight": t(inner, dim),
                f"{b}.attn1.to_v.weight": t(inner, dim),
                f"{b}.attn1.to_out.0.weight": t(dim, inner),
                f"{b}.attn1.to_out.0.bias": t(dim),
                f"{b}.norm1.weight": torch.ones(dim),
                f"{b}.norm1.bias": torch.zeros(dim),
                f"{b}.norm3.weight": torch.ones(dim),
                f"{b}.norm3.bias": torch.zeros(dim),
                f"{b}.ff.net.0.proj.weight": t(8 * dim, dim),
                f"{b}.ff.net.0.proj.bias": t(8 * dim),
                f"{b}.ff.net.2.weight": t(dim, 4 * dim),
                f"{b}.ff.net.2.bias": t(dim),
            })

    prev = in_ch
    for i, c in enumerate(ch):
        base = f"{est}.down_blocks.{i}"
        resnet(f"{base}.0", prev, c)
        tfblocks(f"{base}.1", c)
        last = i == len(ch) - 1
        key = f"{base}.2.weight" if last else f"{base}.2.conv.weight"
        sd[key] = t(c, c, 3)
        sd[key.replace("weight", "bias")] = t(c)
        prev = c
    for i in range(g.n_mid):
        base = f"{est}.mid_blocks.{i}"
        resnet(f"{base}.0", ch[-1], ch[-1])
        tfblocks(f"{base}.1", ch[-1])
    up_ch = tuple(reversed(ch)) + (ch[0],)
    for i in range(len(up_ch) - 1):
        base = f"{est}.up_blocks.{i}"
        resnet(f"{base}.0", 2 * up_ch[i], up_ch[i + 1])
        tfblocks(f"{base}.1", up_ch[i + 1])
        last = i == len(up_ch) - 2
        if last:
            sd[f"{base}.2.weight"] = t(up_ch[i + 1], up_ch[i + 1], 3)
            sd[f"{base}.2.bias"] = t(up_ch[i + 1])
        else:
            # ConvTranspose1d [in, out, K]
            sd[f"{base}.2.conv.weight"] = t(up_ch[i + 1], up_ch[i + 1], 4)
            sd[f"{base}.2.conv.bias"] = t(up_ch[i + 1])
    return sd


def build_hift_pt(g: SynthGeometry, seed: int = 2, scale: Scale = 0.3) -> Dict:
    import torch

    t = _seeded(seed, scale)
    M = g.n_mels
    C = g.hift_channels
    n_bins2 = g.istft_n_fft + 2
    sd = {}

    def wn_conv(name: str, out_c: int, in_c: int, k: int, dim0: int = None):
        v = t(out_c, in_c, k)
        gshape = (out_c, 1, 1)
        sd[f"{name}.weight_v"] = v
        sd[f"{name}.weight_g"] = torch.rand(*gshape) + 0.5
        sd[f"{name}.bias"] = t(out_c)

    def wn_convT(name: str, in_c: int, out_c: int, k: int):
        sd[f"{name}.weight_v"] = t(in_c, out_c, k)
        sd[f"{name}.weight_g"] = torch.rand(in_c, 1, 1) + 0.5
        sd[f"{name}.bias"] = t(out_c)

    # f0 predictor: 3 weight-normed convs (Sequential indices 0, 2, 4) + ELU
    cond = C
    wn_conv("f0_predictor.condnet.0", cond, M, 3)
    wn_conv("f0_predictor.condnet.2", cond, cond, 3)
    wn_conv("f0_predictor.condnet.4", cond, cond, 3)
    sd["f0_predictor.classifier.weight"] = t(1, cond)
    sd["f0_predictor.classifier.bias"] = t(1)
    sd["m_source.l_linear.weight"] = t(1, g.nb_harmonics + 1)
    sd["m_source.l_linear.bias"] = t(1)
    wn_conv("conv_pre", C, M, 7)
    ch = C
    n_up = len(g.up_rates)
    for i, r in enumerate(g.up_rates):
        out_c = ch // 2
        wn_convT(f"ups.{i}", ch, out_c, 2 * r)
        stride = 1
        for rr in g.up_rates[i + 1:]:
            stride *= rr
        k = 2 * stride if stride > 1 else 1
        sd[f"source_downs.{i}.weight"] = t(out_c, n_bins2, k)
        sd[f"source_downs.{i}.bias"] = t(out_c)
        for conv in ("convs1", "convs2"):
            for j in range(g.n_res_convs):
                wn_conv(f"source_resblocks.{i}.{conv}.{j}", out_c, out_c, 7)
        for jk, kern in enumerate(g.resblock_kernels):
            for conv in ("convs1", "convs2"):
                for j in range(g.n_res_convs):
                    wn_conv(
                        f"resblocks.{i * len(g.resblock_kernels) + jk}"
                        f".{conv}.{j}", out_c, out_c, kern,
                    )
        ch = out_c
    wn_conv("conv_post", n_bins2, ch, 7)
    return sd


def build_tokenizer_onnx(g: SynthGeometry, seed: int = 3, scale: Scale = 0.3) -> Dict:
    """Whisper-style S3 tokenizer tensors in upstream key space (numpy —
    written with our own ONNX wire writer, utils/onnx_load)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    D = g.flow_dim
    mels = g.s3_mels or g.n_mels

    def t(*shape):
        return (rng.standard_normal(shape) * _draw_scale(shape, scale)).astype(np.float32)

    sd = {
        "encoder.conv1.weight": t(D, mels, 3),
        "encoder.conv1.bias": t(D),
        "encoder.conv2.weight": t(D, D, 3),
        "encoder.conv2.bias": t(D),
        "encoder.ln_post.weight": np.ones(D, np.float32),
        "encoder.ln_post.bias": np.zeros(D, np.float32),
        "encoder.positional_embedding": t(g.n_positions, D),
        "quantizer._codebook.embed": t(g.speech_vocab, D),
    }
    for i in range(2):
        e = f"encoder.blocks.{i}"
        sd.update({
            f"{e}.attn.query.weight": t(D, D),
            f"{e}.attn.query.bias": t(D),
            f"{e}.attn.key.weight": t(D, D),
            f"{e}.attn.value.weight": t(D, D),
            f"{e}.attn.value.bias": t(D),
            f"{e}.attn.out.weight": t(D, D),
            f"{e}.attn.out.bias": t(D),
            f"{e}.attn_ln.weight": np.ones(D, np.float32),
            f"{e}.attn_ln.bias": np.zeros(D, np.float32),
            f"{e}.mlp.0.weight": t(4 * D, D),
            f"{e}.mlp.0.bias": t(4 * D),
            f"{e}.mlp.2.weight": t(D, 4 * D),
            f"{e}.mlp.2.bias": t(D),
            f"{e}.mlp_ln.weight": np.ones(D, np.float32),
            f"{e}.mlp_ln.bias": np.zeros(D, np.float32),
        })
    return sd


def build_tokenizer_graph_onnx(g: SynthGeometry, seed: int = 3) -> bytes:
    """The SAME tokenizer tensors as build_tokenizer_onnx (identical seed =
    identical weights), but with the whisper-encoder compute expressed as
    REAL NodeProtos. Exists for cross-validation: the rule-converted native
    module (models/compat/s3_tokenizer) and the graph executor
    (ops/onnx_exec) must produce the same tokens from the same artifact —
    two independent serving paths checking each other
    (tests/test_onnx_exec.py)."""
    import numpy as np

    from .onnx_load import OnnxNode, write_onnx_model

    sd = build_tokenizer_onnx(g, seed)
    D = g.flow_dim
    H, hd = 2, D // 2
    t = dict(sd)
    t["scale"] = np.asarray(hd ** -0.5, np.float32)
    t["zero"] = np.asarray([0], np.int64)
    t["one_ax"] = np.asarray([1], np.int64)
    t["two"] = np.asarray([2], np.int64)
    t["head_shape_tail"] = np.asarray([H, hd], np.int64)
    t["flat_tail"] = np.asarray([D], np.int64)
    N = OnnxNode
    nodes = [
        # conv stem (ONNX NCT; torch conv layouts consumed directly)
        N("Transpose", ["mel"], ["x0"], attrs={"perm": [0, 2, 1]}),
        N("Conv", ["x0", "encoder.conv1.weight", "encoder.conv1.bias"],
          ["c1"], attrs={"kernel_shape": [3], "pads": [1, 1],
                         "strides": [1], "dilations": [1], "group": 1}),
        N("Gelu", ["c1"], ["g1"], attrs={"approximate": "tanh"}),
        N("Conv", ["g1", "encoder.conv2.weight", "encoder.conv2.bias"],
          ["c2"], attrs={"kernel_shape": [3], "pads": [1, 1],
                         "strides": [2], "dilations": [1], "group": 1}),
        N("Gelu", ["c2"], ["g2"], attrs={"approximate": "tanh"}),
        N("Transpose", ["g2"], ["h0"], attrs={"perm": [0, 2, 1]}),
        # positions: pos_emb[:T2] via static-folded Shape -> Slice
        N("Shape", ["h0"], ["hshp"]),
        N("Gather", ["hshp", "one_ax"], ["t2"], attrs={"axis": 0}),
        N("Slice",
          ["encoder.positional_embedding", "zero", "t2", "zero"], ["pe"]),
        N("Add", ["h0", "pe"], ["h1"]),
        # head reshape target [1, T2, H, hd] (batch/T from Shape fold)
        N("Slice", ["hshp", "zero", "two", "zero"], ["bt"]),
        N("Concat", ["bt", "head_shape_tail"], ["hshape"],
          attrs={"axis": 0}),
        N("Concat", ["bt", "flat_tail"], ["fshape"], attrs={"axis": 0}),
    ]

    def block(i: int, hin: str, hout: str):
        e = f"encoder.blocks.{i}"
        p = f"b{i}_"
        out = [
            N("LayerNormalization",
              [hin, f"{e}.attn_ln.weight", f"{e}.attn_ln.bias"], [p + "n"]),
        ]
        for nm, dst, bias in (("attn.query", "q", True),
                              ("attn.key", "k", False),
                              ("attn.value", "v", True)):
            out.append(N("Transpose", [f"{e}.{nm}.weight"], [p + dst + "wt"],
                         attrs={"perm": [1, 0]}))
            out.append(N("MatMul", [p + "n", p + dst + "wt"],
                         [p + dst + ("0" if bias else "h")]))
            if bias:
                out.append(N("Add", [p + dst + "0", f"{e}.{nm}.bias"],
                             [p + dst + "h"]))
            out.append(N("Reshape", [p + dst + "h", "hshape"], [p + dst]))
        out += [
            N("Einsum", [p + "q", p + "k"], [p + "s0"],
              attrs={"equation": "bthd,bshd->bhts"}),
            N("Mul", [p + "s0", "scale"], [p + "s"]),
            N("Softmax", [p + "s"], [p + "pr"], attrs={"axis": -1}),
            N("Einsum", [p + "pr", p + "v"], [p + "att0"],
              attrs={"equation": "bhts,bshd->bthd"}),
            N("Reshape", [p + "att0", "fshape"], [p + "att"]),
            N("Transpose", [f"{e}.attn.out.weight"], [p + "owt"],
              attrs={"perm": [1, 0]}),
            N("MatMul", [p + "att", p + "owt"], [p + "o0"]),
            N("Add", [p + "o0", f"{e}.attn.out.bias"], [p + "o1"]),
            N("Add", [hin, p + "o1"], [p + "h1"]),
            N("LayerNormalization",
              [p + "h1", f"{e}.mlp_ln.weight", f"{e}.mlp_ln.bias"],
              [p + "n2"]),
            N("Transpose", [f"{e}.mlp.0.weight"], [p + "m1wt"],
              attrs={"perm": [1, 0]}),
            N("MatMul", [p + "n2", p + "m1wt"], [p + "m10"]),
            N("Add", [p + "m10", f"{e}.mlp.0.bias"], [p + "m11"]),
            N("Gelu", [p + "m11"], [p + "m1g"],
              attrs={"approximate": "tanh"}),
            N("Transpose", [f"{e}.mlp.2.weight"], [p + "m2wt"],
              attrs={"perm": [1, 0]}),
            N("MatMul", [p + "m1g", p + "m2wt"], [p + "m20"]),
            N("Add", [p + "m20", f"{e}.mlp.2.bias"], [p + "m21"]),
            N("Add", [p + "h1", p + "m21"], [hout]),
        ]
        return out

    nodes += block(0, "h1", "h2")
    nodes += block(1, "h2", "h3")
    nodes += [
        N("LayerNormalization",
          ["h3", "encoder.ln_post.weight", "encoder.ln_post.bias"],
          ["hidden"]),
        # VQ: nearest codebook row by L2
        N("Unsqueeze", ["hidden", "two"], ["hu"]),
        N("Sub", ["hu", "quantizer._codebook.embed"], ["dlt"]),
        N("Mul", ["dlt", "dlt"], ["sq"]),
        N("ReduceSum", ["sq"], ["d2"], attrs={"axes": [-1], "keepdims": 0}),
        N("ArgMin", ["d2"], ["tokens"], attrs={"axis": -1, "keepdims": 0}),
    ]
    return write_onnx_model(None, t, nodes, ["mel"], ["tokens", "hidden"])


def build_campplus_onnx(g: SynthGeometry, seed: int = 4, scale: Scale = 0.3) -> bytes:
    """CAM++-shaped speaker-embedding GRAPH (not just tensors): conv1d
    front-end -> dilated D-TDNN-ish block -> context gate (the CAM flavor:
    global pooled stats gate the trunk) -> mean‖std stats pooling -> linear
    to the x-vector. campplus.onnx is served by GRAPH EXECUTION
    (ops/onnx_exec — its initializer names are not blind-reconstructible
    into a rule table), so this fixture carries real NodeProtos; the
    executor must run it regardless of what any tensor is called."""
    import numpy as np

    from .onnx_load import OnnxNode, write_onnx_model

    rng = np.random.default_rng(seed)
    C = g.hift_channels
    E = g.spk_dim                      # engine-coherent x-vector width

    def t(*shape):
        return (rng.standard_normal(shape) * _draw_scale(shape, scale)).astype(np.float32)

    tensors = {
        "tdnn1.weight": t(C, 80, 5), "tdnn1.bias": t(C),
        "bn1.scale": np.abs(t(C)) + 0.5, "bn1.bias": t(C),
        "bn1.mean": t(C), "bn1.var": np.abs(t(C)) + 0.5,
        "tdnn2.weight": t(C, C, 3), "tdnn2.bias": t(C),
        "bn2.scale": np.abs(t(C)) + 0.5, "bn2.bias": t(C),
        "bn2.mean": t(C), "bn2.var": np.abs(t(C)) + 0.5,
        "gate.weight": t(C, C, 1), "gate.bias": t(C),
        "eps": np.asarray(1e-5, np.float32),
        "mean_axes": np.asarray([2], np.int64),
        "fc.weight": t(2 * C, E), "fc.bias": t(E),
    }
    N = OnnxNode
    nodes = [
        N("Transpose", ["fbank"], ["x"], attrs={"perm": [0, 2, 1]}),
        N("Conv", ["x", "tdnn1.weight", "tdnn1.bias"], ["c1"],
          attrs={"kernel_shape": [5], "pads": [2, 2], "strides": [1],
                 "dilations": [1], "group": 1}),
        N("BatchNormalization",
          ["c1", "bn1.scale", "bn1.bias", "bn1.mean", "bn1.var"], ["b1"],
          attrs={"epsilon": 1e-5}),
        N("Relu", ["b1"], ["r1"]),
        N("Conv", ["r1", "tdnn2.weight", "tdnn2.bias"], ["c2"],
          attrs={"kernel_shape": [3], "pads": [2, 2], "strides": [1],
                 "dilations": [2], "group": 1}),
        N("BatchNormalization",
          ["c2", "bn2.scale", "bn2.bias", "bn2.mean", "bn2.var"], ["b2"],
          attrs={"epsilon": 1e-5}),
        N("Relu", ["b2"], ["r2"]),
        # context-aware gate
        N("GlobalAveragePool", ["r2"], ["ctx"]),
        N("Conv", ["ctx", "gate.weight", "gate.bias"], ["gpre"],
          attrs={"kernel_shape": [1], "pads": [0, 0], "strides": [1],
                 "dilations": [1], "group": 1}),
        N("Sigmoid", ["gpre"], ["gsig"]),
        N("Mul", ["r2", "gsig"], ["h"]),
        # stats pooling: mean ‖ std over time
        N("ReduceMean", ["h", "mean_axes"], ["mu"], attrs={"keepdims": 1}),
        N("Sub", ["h", "mu"], ["hc"]),
        N("Mul", ["hc", "hc"], ["hc2"]),
        N("ReduceMean", ["hc2", "mean_axes"], ["var"],
          attrs={"keepdims": 0}),
        N("Add", ["var", "eps"], ["vare"]),
        N("Sqrt", ["vare"], ["sd"]),
        N("Squeeze", ["mu", "mean_axes"], ["mu2"]),
        N("Concat", ["mu2", "sd"], ["stats"], attrs={"axis": 1}),
        N("Gemm", ["stats", "fc.weight", "fc.bias"], ["embedding"],
          attrs={"alpha": 1.0, "beta": 1.0}),
    ]
    return write_onnx_model(None, tensors, nodes, ["fbank"], ["embedding"])


def build_release_dir(path, g: SynthGeometry = SynthGeometry(),
                      seed: int = 0, scale: Scale = 0.3) -> Path:
    """Write llm.pt / flow.pt / hift.pt / speech_tokenizer_v1.onnx /
    campplus.onnx into `path` (upstream key space)."""
    import torch

    from .onnx_load import write_onnx_tensors

    d = Path(path)
    d.mkdir(parents=True, exist_ok=True)
    torch.save(build_llm_pt(g, seed, scale), d / "llm.pt")
    torch.save(build_flow_pt(g, seed + 1, scale), d / "flow.pt")
    torch.save(build_hift_pt(g, seed + 2, scale), d / "hift.pt")
    write_onnx_tensors(
        d / "speech_tokenizer_v1.onnx", build_tokenizer_onnx(g, seed + 3, scale)
    )
    (d / "campplus.onnx").write_bytes(build_campplus_onnx(g, seed + 4, scale))
    return d
