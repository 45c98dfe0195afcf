"""CosyVoice-300M release ingestion and rule-driven conversion.

Counterpart of the JAX ``utils/cosyvoice_convert.py``, a copy of its numpy
code: the converted trees are f32 numpy, bitwise equal to the JAX
package's. A release directory holds torch state dicts (``llm.pt``,
``flow.pt``, ``hift.pt``) and ONNX models (``speech_tokenizer_v1.onnx``,
``campplus.onnx``):

- ingestion: every tensor of every artifact, torch (``torch.load`` with
  ``weights_only=True``) and ONNX (``utils/onnx_load.py``);
- a declarative mapping engine (regex source -> target tree path, with
  transpose / leading-[L] stacking / fusion transforms) that reports
  mapped, unmapped-source and unfilled-target keys, so coverage is never
  silent;
- ``inventory``: an artifact directory's key and shape tree.

The rule tables follow the documented upstream topologies; they are
checked on synthetic releases in the upstream key names
(``utils/synth_release.py``), not on the real release files.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .onnx_load import load_onnx_weights

ARTIFACTS = (
    "llm.pt", "flow.pt", "hift.pt",
    "speech_tokenizer_v1.onnx", "campplus.onnx",
)


def load_torch_tensors(path) -> Dict[str, np.ndarray]:
    """torch .pt checkpoint -> {key: float32 ndarray} (CPU, no grad)."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    out = {}
    for k, v in obj.items():
        if hasattr(v, "detach"):
            out[k] = v.detach().cpu().float().numpy()
        else:
            out[k] = np.asarray(v)
    return out


def load_artifact(path) -> Dict[str, np.ndarray]:
    p = str(path)
    if p.endswith(".onnx"):
        return load_onnx_weights(p)
    return load_torch_tensors(p)


def inventory(model_dir) -> Dict[str, Dict[str, List[int]]]:
    """{artifact: {tensor name: shape}} for every artifact present."""
    out: Dict[str, Dict[str, List[int]]] = {}
    d = Path(model_dir)
    for name in ARTIFACTS:
        p = d / name
        if p.exists():
            out[name] = {
                k: list(v.shape) for k, v in load_artifact(p).items()
            }
    return out


# ------------------------------------------------------------- mapping engine


Transform = Callable[[np.ndarray], np.ndarray]

_TRANSFORMS: Dict[str, Transform] = {
    "none": lambda x: x,
    "T": lambda x: x.T,                       # torch Linear [out,in] -> [in,out]
    # torch Conv1d [out, in, K] -> our channels-last conv1d [K, in, out]
    "conv1d": lambda x: np.transpose(x, (2, 1, 0)),
    # torch ConvTranspose1d [in, out, K] -> our taps layout [K, in, out]
    # (ops/conv.conv_transpose1d flips taps itself)
    "convT1d": lambda x: np.transpose(x, (2, 0, 1)),
    # torch depthwise Conv1d [C, 1, K] -> [K, 1, C] (feature_group_count=C)
    "dwconv1d": lambda x: np.transpose(x, (2, 1, 0)),
    # torch pointwise Conv1d [out, in, 1] -> plain matrix [in, out]
    "pwconv1d": lambda x: x[:, :, 0].T,
    # rank-dispatch for Sequential stacks mixing convs and norms under the
    # same key pattern (InterpolateRegulator): 3-D -> conv layout, else as-is
    "conv1d_or_none": lambda x: (
        np.transpose(x, (2, 1, 0)) if x.ndim == 3 else x
    ),
}


def _weight_norm(v: np.ndarray, g: np.ndarray) -> np.ndarray:
    """torch.nn.utils.weight_norm reconstruction, dim=0 (the HiFi-GAN/HiFT
    default): w = g * v / ||v||_2 with the norm over all dims except 0."""
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes, keepdims=True))
    return (g * v / norm).astype(v.dtype)


@dataclass
class Rule:
    """src regex -> dst path template. Layer-indexed sources (one capture
    group = layer number) stack into a leading [L] dim at the dst; `fuse`
    names combine multiple sources before placing: fuse_op="concat" joins
    along `fuse_axis` (after per-part transform), fuse_op="weight_norm"
    reconstructs w from (v, g) torch weight-norm pairs (then transforms)."""

    src: str
    dst: str
    transform: str = "none"
    fuse: Tuple[str, ...] = ()
    fuse_axis: int = -1
    fuse_op: str = "concat"
    # stack=False: capture groups substitute into dst (\1, \2 ...) instead of
    # leading-[L] stacking — for stages with non-uniform shapes (U-Net)
    stack: bool = True


@dataclass
class ConvertReport:
    mapped: List[str] = field(default_factory=list)
    unmapped_src: List[str] = field(default_factory=list)
    unfilled_dst: List[str] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(self.__dict__, indent=2)

    @property
    def complete(self) -> bool:
        return not self.unmapped_src and not self.unfilled_dst


def _set_path(tree: Dict, path: str, value: np.ndarray, layer: Optional[int],
              n_layers: Optional[int]) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    leaf = parts[-1]
    if layer is None:
        node[leaf] = value
    else:
        buf = node.get(leaf)
        if buf is None:
            assert n_layers is not None
            buf = np.zeros((n_layers,) + value.shape, value.dtype)
            node[leaf] = buf
        buf[layer] = value


def apply_rules(
    src: Dict[str, np.ndarray],
    rules: List[Rule],
    n_layers: Optional[int] = None,
    expected_dst: Optional[List[str]] = None,
) -> Tuple[Dict, ConvertReport]:
    """Run the rule table over a tensor dict -> (param tree, report).

    Layer-stacked rules (one capture group = layer index) infer their own
    layer count from the matching keys (max index + 1), so one table serves
    encoders of different depths; `n_layers` overrides when given."""
    tree: Dict = {}
    report = ConvertReport()
    used = set()
    for rule in rules:
        pat = re.compile(rule.src)
        tf = _TRANSFORMS[rule.transform]
        matches = [(k, pat.fullmatch(k)) for k in src]
        matches = [(k, m) for k, m in matches if m]
        rule_layers = n_layers
        if (rule.stack and rule_layers is None and matches
                and matches[0][1].groups()):
            rule_layers = 1 + max(int(m.group(1)) for _, m in matches)
        for key, m in matches:
            layer = int(m.group(1)) if (m.groups() and rule.stack) else None
            if rule.fuse:
                # gather sibling tensors (e.g. q,k,v or weight_v/weight_g)
                parts = []
                names = []
                ok = True
                for sib in rule.fuse:
                    sk = pat.sub(sib, key) if "\\" in sib else sib.format(
                        *m.groups())
                    if sk not in src:
                        ok = False
                        break
                    parts.append(src[sk])
                    names.append(sk)
                if not ok or names[0] in used:
                    continue
                if rule.fuse_op == "weight_norm":
                    assert len(parts) == 2, "weight_norm fuse takes (v, g)"
                    value = tf(_weight_norm(parts[0], parts[1]))
                else:
                    value = np.concatenate(
                        [tf(p) for p in parts], axis=rule.fuse_axis
                    )
                used.update(names)
                report.mapped.extend(n for n in names)
            else:
                if key in used:
                    continue
                value = tf(src[key])
                used.add(key)
                report.mapped.append(key)
            dst = pat.sub(rule.dst, key) if layer is None else rule.dst
            _set_path(tree, dst, value, layer, rule_layers)
    report.unmapped_src = sorted(set(src) - used)
    if expected_dst is not None:
        have = set(_flatten_paths(tree))
        report.unfilled_dst = sorted(set(expected_dst) - have)
    return tree, report


def _flatten_paths(tree: Dict, prefix: str = "") -> List[str]:
    out = []
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.extend(_flatten_paths(v, p))
        else:
            out.append(p)
    return out


# ------------------------------------------------------------------ rule tables
#
# Per-artifact tables keyed to the documented upstream topologies
# (wenet-conformer TransformerLM for llm.pt, Matcha-style
# ConditionalDecoder flow for flow.pt, HiFT/NSF for hift.pt), checked on
# synthetic release directories whose key names and shapes mirror
# upstream. The converted trees load into models/compat/.


def _encoder_rules(src_prefix: str, dst_prefix: str) -> List[Rule]:
    """wenet encoder stack (ConformerEncoderLayer + TransformerEncoderLayer
    key spellings both covered; layers stack into leading [L])."""
    sp = re.escape(src_prefix)
    e = rf"{sp}\.encoders\.(\d+)\."
    d = f"{dst_prefix}/layers/"
    lin = [("self_attn.linear_q", "q"), ("self_attn.linear_k", "k"),
           ("self_attn.linear_v", "v"), ("self_attn.linear_out", "out"),
           ("feed_forward.w_1", "ff_w1"), ("feed_forward.w_2", "ff_w2"),
           ("feed_forward_macaron.w_1", "ffm_w1"),
           ("feed_forward_macaron.w_2", "ffm_w2")]
    norm = [("norm_mha", "norm_mha"), ("norm_ff", "norm_ff"),
            ("norm_ff_macaron", "norm_ff_macaron"),
            ("norm_conv", "norm_conv"), ("norm_final", "norm_final"),
            # TransformerEncoderLayer spelling (the LM trunk)
            ("norm1", "norm_mha"), ("norm2", "norm_ff")]
    rules = [
        # LinearNoSubsampling input: embed.out.0 Linear (+ .1 LayerNorm)
        Rule(rf"{sp}\.embed\.out\.0\.weight", f"{dst_prefix}/in_proj/w", "T"),
        Rule(rf"{sp}\.embed\.out\.0\.bias", f"{dst_prefix}/in_proj/b"),
        Rule(rf"{sp}\.embed\.out\.1\.weight", f"{dst_prefix}/in_norm/scale"),
        Rule(rf"{sp}\.embed\.out\.1\.bias", f"{dst_prefix}/in_norm/bias"),
        Rule(e + r"self_attn\.linear_pos\.weight", d + "pos/w", "T"),
        Rule(e + r"self_attn\.pos_bias_u", d + "pos_bias_u"),
        Rule(e + r"self_attn\.pos_bias_v", d + "pos_bias_v"),
        # conformer conv module (layer-norm variant)
        Rule(e + r"conv_module\.pointwise_conv1\.weight", d + "conv_pw1/w",
             "pwconv1d"),
        Rule(e + r"conv_module\.pointwise_conv1\.bias", d + "conv_pw1/b"),
        Rule(e + r"conv_module\.depthwise_conv\.weight", d + "conv_dw/w",
             "dwconv1d"),
        Rule(e + r"conv_module\.depthwise_conv\.bias", d + "conv_dw/b"),
        Rule(e + r"conv_module\.norm\.weight", d + "conv_norm/scale"),
        Rule(e + r"conv_module\.norm\.bias", d + "conv_norm/bias"),
        Rule(e + r"conv_module\.pointwise_conv2\.weight", d + "conv_pw2/w",
             "pwconv1d"),
        Rule(e + r"conv_module\.pointwise_conv2\.bias", d + "conv_pw2/b"),
        Rule(rf"{sp}\.after_norm\.weight", f"{dst_prefix}/after_norm/scale"),
        Rule(rf"{sp}\.after_norm\.bias", f"{dst_prefix}/after_norm/bias"),
    ]
    for src_name, dst_name in lin:
        s = re.escape(src_name)
        rules.append(Rule(e + s + r"\.weight", d + dst_name + "/w", "T"))
        rules.append(Rule(e + s + r"\.bias", d + dst_name + "/b"))
    for src_name, dst_name in norm:
        s = re.escape(src_name)
        rules.append(Rule(e + s + r"\.weight", d + dst_name + "/scale"))
        rules.append(Rule(e + s + r"\.bias", d + dst_name + "/bias"))
    return rules


def _estimator_rules() -> List[Rule]:
    """Matcha ConditionalDecoder (decoder.estimator.*): resnet + diffusers
    BasicTransformerBlock stages with skip-concat U-Net structure. stack=False
    keeps torch stage indices as tree keys (stages differ in width)."""
    est = r"decoder\.estimator\."
    rules = [
        Rule(est + r"time_mlp\.linear_1\.weight", "estimator/time_mlp/l1/w",
             "T"),
        Rule(est + r"time_mlp\.linear_1\.bias", "estimator/time_mlp/l1/b"),
        Rule(est + r"time_mlp\.linear_2\.weight", "estimator/time_mlp/l2/w",
             "T"),
        Rule(est + r"time_mlp\.linear_2\.bias", "estimator/time_mlp/l2/b"),
        Rule(est + r"final_block\.block\.0\.weight", "estimator/final_block/conv/w",
             "conv1d"),
        Rule(est + r"final_block\.block\.0\.bias", "estimator/final_block/conv/b"),
        Rule(est + r"final_block\.block\.1\.weight", "estimator/final_block/norm/scale"),
        Rule(est + r"final_block\.block\.1\.bias", "estimator/final_block/norm/bias"),
        Rule(est + r"final_proj\.weight", "estimator/final_proj/w", "conv1d"),
        Rule(est + r"final_proj\.bias", "estimator/final_proj/b"),
    ]
    for kind, torch_kind in (("down", "down_blocks"), ("mid", "mid_blocks"),
                             ("up", "up_blocks")):
        b = est + torch_kind + r"\.(\d+)\."
        dr = f"estimator/{kind}/\\1/res/"
        # ResnetBlock1D at index .0
        res = [
            (r"0\.mlp\.1\.weight", dr + "mlp/w", "T"),
            (r"0\.mlp\.1\.bias", dr + "mlp/b", "none"),
            (r"0\.block1\.block\.0\.weight", dr + "b1_conv/w", "conv1d"),
            (r"0\.block1\.block\.0\.bias", dr + "b1_conv/b", "none"),
            (r"0\.block1\.block\.1\.weight", dr + "b1_norm/scale", "none"),
            (r"0\.block1\.block\.1\.bias", dr + "b1_norm/bias", "none"),
            (r"0\.block2\.block\.0\.weight", dr + "b2_conv/w", "conv1d"),
            (r"0\.block2\.block\.0\.bias", dr + "b2_conv/b", "none"),
            (r"0\.block2\.block\.1\.weight", dr + "b2_norm/scale", "none"),
            (r"0\.block2\.block\.1\.bias", dr + "b2_norm/bias", "none"),
            (r"0\.res_conv\.weight", dr + "res_conv/w", "conv1d"),
            (r"0\.res_conv\.bias", dr + "res_conv/b", "none"),
        ]
        # BasicTransformerBlock list at index .1
        dt = f"estimator/{kind}/\\1/tf/\\2/"
        tf = [
            (r"1\.(\d+)\.attn1\.to_q\.weight", dt + "q/w", "T"),
            (r"1\.(\d+)\.attn1\.to_k\.weight", dt + "k/w", "T"),
            (r"1\.(\d+)\.attn1\.to_v\.weight", dt + "v/w", "T"),
            (r"1\.(\d+)\.attn1\.to_out\.0\.weight", dt + "out/w", "T"),
            (r"1\.(\d+)\.attn1\.to_out\.0\.bias", dt + "out/b", "none"),
            (r"1\.(\d+)\.norm1\.weight", dt + "norm1/scale", "none"),
            (r"1\.(\d+)\.norm1\.bias", dt + "norm1/bias", "none"),
            (r"1\.(\d+)\.norm3\.weight", dt + "norm3/scale", "none"),
            (r"1\.(\d+)\.norm3\.bias", dt + "norm3/bias", "none"),
            (r"1\.(\d+)\.ff\.net\.0\.proj\.weight", dt + "ff_proj/w", "T"),
            (r"1\.(\d+)\.ff\.net\.0\.proj\.bias", dt + "ff_proj/b", "none"),
            (r"1\.(\d+)\.ff\.net\.2\.weight", dt + "ff_out/w", "T"),
            (r"1\.(\d+)\.ff\.net\.2\.bias", dt + "ff_out/b", "none"),
        ]
        for src_s, dst_s, tfm in res + tf:
            rules.append(Rule(b + src_s, dst_s, tfm, stack=False))
        if kind == "down":
            # Downsample1D wraps conv (`.2.conv.*`); last stage is a plain
            # stride-1 Conv1d (`.2.*`) — both regular convs
            rules.append(Rule(b + r"2\.(?:conv\.)?weight",
                              f"estimator/down/\\1/down/w", "conv1d",
                              stack=False))
            rules.append(Rule(b + r"2\.(?:conv\.)?bias",
                              f"estimator/down/\\1/down/b", "none",
                              stack=False))
        if kind == "up":
            # Upsample1D(use_conv_transpose) -> `.2.conv.*` ConvTranspose1d;
            # last stage -> plain Conv1d `.2.*`
            rules.append(Rule(b + r"2\.conv\.weight",
                              f"estimator/up/\\1/up/w", "convT1d",
                              stack=False))
            rules.append(Rule(b + r"2\.conv\.bias",
                              f"estimator/up/\\1/up/b", "none", stack=False))
            rules.append(Rule(b + r"2\.weight", f"estimator/up/\\1/up/w",
                              "conv1d", stack=False))
            rules.append(Rule(b + r"2\.bias", f"estimator/up/\\1/up/b",
                              "none", stack=False))
    return rules


def _wn_conv_rules(src_name: str, dst: str, transform: str,
                   indexed: bool = False) -> List[Rule]:
    """weight-normed torch conv -> materialized w + bias. `indexed` handles
    ModuleList sources (one capture group kept in the dst via stack=False)."""
    s = src_name  # already a regex fragment
    fuse_v = s.replace(r"\.", ".") + ".weight_v"
    fuse_g = s.replace(r"\.", ".") + ".weight_g"
    if indexed:
        fuse_v = fuse_v.replace(r"(\d+)", "{0}")
        fuse_g = fuse_g.replace(r"(\d+)", "{0}")
    return [
        Rule(s + r"\.weight_v", dst + "/w", transform,
             fuse=(fuse_v, fuse_g), fuse_op="weight_norm", stack=False),
        Rule(s + r"\.bias", dst + "/b", stack=False),
    ]


def _hift_rules() -> List[Rule]:
    rules: List[Rule] = []
    rules += _wn_conv_rules(r"f0_predictor\.condnet\.(\d+)",
                            r"f0_predictor/condnet/\1", "conv1d",
                            indexed=True)
    rules += [
        Rule(r"f0_predictor\.classifier\.weight", "f0_predictor/classifier/w",
             "T"),
        Rule(r"f0_predictor\.classifier\.bias", "f0_predictor/classifier/b"),
        Rule(r"m_source\.l_linear\.weight", "m_source/l_linear/w", "T"),
        Rule(r"m_source\.l_linear\.bias", "m_source/l_linear/b"),
    ]
    rules += _wn_conv_rules(r"conv_pre", "conv_pre", "conv1d")
    rules += _wn_conv_rules(r"ups\.(\d+)", r"ups/\1", "convT1d", indexed=True)
    rules += [
        Rule(r"source_downs\.(\d+)\.weight", r"source_downs/\1/w", "conv1d",
             stack=False),
        Rule(r"source_downs\.(\d+)\.bias", r"source_downs/\1/b", stack=False),
    ]
    for group in ("resblocks", "source_resblocks"):
        g = re.escape(group)
        for convs in ("convs1", "convs2"):
            src = rf"{g}\.(\d+)\.{convs}\.(\d+)"
            dst = f"{group}/\\1/{convs}/\\2"
            rules.append(Rule(
                src + r"\.weight_v", dst + "/w", "conv1d",
                fuse=(f"{group}.{{0}}.{convs}.{{1}}.weight_v",
                      f"{group}.{{0}}.{convs}.{{1}}.weight_g"),
                fuse_op="weight_norm", stack=False,
            ))
            rules.append(Rule(src + r"\.bias", dst + "/b", stack=False))
    rules += _wn_conv_rules(r"conv_post", "conv_post", "conv1d")
    return rules


def _s3_tokenizer_rules() -> List[Rule]:
    """speech_tokenizer_v1.onnx -> models/compat/s3_tokenizer.py. Whisper
    module naming (torch export keeps state_dict paths as initializer
    names); the quantizer codebook key is covered under several plausible
    spellings. Confidence: high for the encoder (whisper naming is
    standard), lower for the codebook — the coverage report flags either
    way. campplus.onnx has NO rule table by design: the D-TDNN export's
    initializer names are not reconstructible blind, so the convert CLI
    carries its node graph verbatim into the snapshot and
    models/compat/campplus.py executes it through ops/onnx_exec."""
    e = r"(?:encoder\.)?blocks\.(\d+)\."
    d = "blocks/"
    rules = [
        Rule(r"(?:encoder\.)?conv1\.weight", "conv1/w", "conv1d"),
        Rule(r"(?:encoder\.)?conv1\.bias", "conv1/b"),
        Rule(r"(?:encoder\.)?conv2\.weight", "conv2/w", "conv1d"),
        Rule(r"(?:encoder\.)?conv2\.bias", "conv2/b"),
        Rule(r"(?:encoder\.)?ln_post\.weight", "ln_post/scale"),
        Rule(r"(?:encoder\.)?ln_post\.bias", "ln_post/bias"),
        Rule(r"(?:encoder\.)?positional_embedding", "pos_emb"),
        Rule(r"(?:quantizer\.)?(?:_codebook\.embed|codebook(?:\.weight)?|"
             r"embed\.weight)", "codebook"),
    ]
    lin = [("attn.query", "q", True), ("attn.key", "k", False),
           ("attn.value", "v", True), ("attn.out", "out", True),
           ("mlp.0", "mlp1", True), ("mlp.2", "mlp2", True)]
    for src_name, dst_name, bias in lin:
        sn = re.escape(src_name)
        rules.append(Rule(e + sn + r"\.weight", d + dst_name + "/w", "T"))
        if bias:
            rules.append(Rule(e + sn + r"\.bias", d + dst_name + "/b"))
    for ln_src, ln_dst in (("attn_ln", "attn_ln"), ("mlp_ln", "mlp_ln")):
        rules.append(Rule(e + ln_src + r"\.weight", d + ln_dst + "/scale"))
        rules.append(Rule(e + ln_src + r"\.bias", d + ln_dst + "/bias"))
    return rules


RULESETS: Dict[str, List[Rule]] = {
    "speech_tokenizer_v1.onnx": _s3_tokenizer_rules(),
    "llm.pt": (
        _encoder_rules("text_encoder", "text_encoder")
        + _encoder_rules("llm", "llm")
        + [
            Rule(r"text_embedding\.weight", "text_embedding"),
            Rule(r"text_encoder_affine_layer\.weight",
                 "text_encoder_affine/w", "T"),
            Rule(r"text_encoder_affine_layer\.bias", "text_encoder_affine/b"),
            Rule(r"llm_embedding\.weight", "llm_embedding"),
            Rule(r"speech_embedding\.weight", "speech_embedding"),
            Rule(r"llm_decoder\.weight", "llm_decoder/w", "T"),
            Rule(r"llm_decoder\.bias", "llm_decoder/b"),
            Rule(r"spk_embed_affine_layer\.weight", "spk_affine/w", "T"),
            Rule(r"spk_embed_affine_layer\.bias", "spk_affine/b"),
        ]
    ),
    "flow.pt": (
        _encoder_rules("encoder", "encoder")
        + _estimator_rules()
        + [
            Rule(r"input_embedding\.weight", "input_embedding"),
            Rule(r"spk_embed_affine_layer\.weight", "spk_affine/w", "T"),
            Rule(r"spk_embed_affine_layer\.bias", "spk_affine/b"),
            Rule(r"encoder_proj\.weight", "encoder_proj/w", "T"),
            Rule(r"encoder_proj\.bias", "encoder_proj/b"),
            Rule(r"length_regulator\.model\.(\d+)\.weight",
                 r"length_regulator/seq/\1/w", "conv1d_or_none", stack=False),
            Rule(r"length_regulator\.model\.(\d+)\.bias",
                 r"length_regulator/seq/\1/b", stack=False),
        ]
    ),
    "hift.pt": _hift_rules(),
}


