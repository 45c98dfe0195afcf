"""Weights carried across from the JAX package, and the port's own init.

- ``load_npz`` reads the flat-key ``.npz`` format of the JAX package's
  ``utils/checkpoint.py`` (keys such as ``token_lm/layers/wqkv``; numeric
  path segments are list indices; a ``q``/``s`` pair is an int8 tensor;
  f16 leaves load as f32).
- ``from_jax_tree`` turns the JAX ``EngineParams.tree()`` (leaves as numpy)
  into the port's parameter tree: nested dicts and lists of tensors.
- ``load_tree`` loads a part of the engine (one module's ``.npz``) into the
  structure of a tree of tensors, every key and shape checked; ``save_tree``
  writes a tree in the same format (the JAX ``save_pytree``'s);
  ``load_lora`` loads a LoRA adapter (such as
  ``artifacts/ft3b/adapter_f16.npz``) that way, in f32.
- ``compat_trees_to_torch``: the CosyVoice compat trees (numpy, from a
  conversion or a snapshot) as f32 tensors on a device.
- ``embedder_from_jax`` / ``lora_from_jax``: the RAG embedder's weights
  (dense or int8, with or without the attention bias) and a LoRA tree,
  from the JAX package's numpy leaves, every shape checked.
- ``init_params`` draws random full-width weights with the same shapes and
  scales as the JAX ``init_params`` functions, from an explicit generator.
- ``QTensor`` / ``quantize`` / ``quantize_tree``: int8 weight-only
  quantization with per-output-channel scales, bit-identical to the JAX
  ``ops/quant.py`` (``torch.round`` rounds half to even like ``jnp.round``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .utils.config import Config, TransformerConfig

_FLAT_SEP = "/"


class QTensor(NamedTuple):
    q: torch.Tensor       # int8, same shape as the original weight
    s: torch.Tensor       # f32 scale, shape = weight.shape[:-2] + (1, out)


def quantize(w: torch.Tensor) -> QTensor:
    """Symmetric int8 with one scale per output channel (absmax over the
    contraction dim, axis -2; leading stack dims keep their own scales)."""
    w = w.float()
    absmax = w.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, s=scale)


_QUANT_NAMES = ("wqkv", "wq", "wk", "wv", "wo", "w_gate_up", "w_gate", "w_up",
                "w_down", "lm_head", "speech_head")


def quantize_tree(params: Dict, names: Tuple[str, ...] = _QUANT_NAMES) -> Dict:
    """Quantize the projection weights of a transformer param tree; embeddings
    and norms stay f32. Walks dicts only, as the JAX ``quantize_tree`` does."""

    def walk(d: Any) -> Any:
        if isinstance(d, dict):
            return {
                k: quantize(v)
                if k in names and isinstance(v, torch.Tensor) and v.ndim >= 2
                else walk(v)
                for k, v in d.items()
            }
        return d

    return walk(params)


# ----------------------------------------------------------------------------- trees


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every tensor leaf (QTensor fields included), or to
    the leaves of several trees of the same structure together."""
    if isinstance(tree, QTensor):
        return QTensor(q=fn(tree.q, *(r.q for r in rest)), s=fn(tree.s, *(r.s for r in rest)))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def to_device(tree: Any, device) -> Any:
    return tree_map(lambda t: t.to(device), tree)


def tree_from_numpy(x: Any) -> Any:
    # JAX QTensor leaves arrive as a NamedTuple with fields (q, s)
    if getattr(x, "_fields", None) == ("q", "s"):
        return QTensor(q=tree_from_numpy(x.q), s=tree_from_numpy(x.s))
    if isinstance(x, dict):
        return {k: tree_from_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [tree_from_numpy(v) for v in x]
    return torch.from_numpy(np.array(x, copy=True))


def _check(name: str, t: Any, shape: Tuple[int, ...]) -> None:
    got = tuple((t.q if isinstance(t, QTensor) else t).shape)
    if got != shape:
        raise ValueError(f"{name}: shape {got} != config shape {shape}")


def from_jax_tree(tree: Dict, cfg: Config, device=None) -> Dict:
    """JAX ``EngineParams.tree()`` with numpy leaves -> the port's tree of
    tensors (on ``device``, default CPU). Every module's shapes are checked
    against ``cfg``: the token LM (dense or int8), the CFM, the vocoder of
    either kind, the speech tokenizer and the speaker encoder."""
    out = tree_from_numpy(tree)
    tl = cfg.token_lm
    L, D, F = tl.n_layers, tl.dim, tl.ffn_dim
    H, K, hd = tl.n_heads, tl.n_kv_heads, tl.head_dim
    lm = out["token_lm"]
    _check("token_lm/layers/wqkv", lm["layers"]["wqkv"], (L, D, (H + 2 * K) * hd))
    _check("token_lm/layers/wo", lm["layers"]["wo"], (L, H * hd, D))
    _check("token_lm/layers/w_gate_up", lm["layers"]["w_gate_up"], (L, D, 2 * F))
    _check("token_lm/layers/w_down", lm["layers"]["w_down"], (L, F, D))
    _check("token_lm/speech_emb", lm["speech_emb"], (tl.speech_vocab_size, D))
    _check("token_lm/speech_head", lm["speech_head"], (D, tl.speech_vocab_size))
    _check("token_lm/tok_emb", lm["tok_emb"], (tl.text_vocab_size, D))
    if "lm_head" in lm:
        _check("token_lm/lm_head", lm["lm_head"], (D, tl.text_vocab_size))
    _check_vocoder(out["vocoder"], cfg.vocoder)
    c = cfg.cfm
    _check("cfm/layers/wq", out["cfm"]["layers"]["wq"], (c.n_layers, c.dim, c.dim))
    _check("cfm/out_proj", out["cfm"]["out_proj"], (c.dim, c.n_mels))
    st = cfg.speech_tokenizer
    tok = out["speech_tokenizer"]
    if len(tok["sub"]) != len(st.strides) or len(tok["enc"]) != st.n_layers:
        raise ValueError(f"speech_tokenizer: {len(tok['sub'])} sub / {len(tok['enc'])} enc layers "
                         f"!= config {len(st.strides)} / {st.n_layers}")
    _check("speech_tokenizer/sub/0/conv/w", tok["sub"][0]["conv"]["w"], (4, st.n_mels, st.dim))
    _check("speech_tokenizer/enc/0/w_up", tok["enc"][0]["w_up"], (st.dim, st.ffn_dim))
    _check("speech_tokenizer/codebook", tok["codebook"], (st.codebook_size, st.dim))
    sp = cfg.speaker
    spk = out["speaker"]
    if len(spk["blocks"]) != sp.n_blocks:
        raise ValueError(f"speaker: {len(spk['blocks'])} blocks != config {sp.n_blocks}")
    _check("speaker/stem/w", spk["stem"]["w"], (5, sp.n_mels, sp.channels))
    _check("speaker/head/w", spk["head"]["w"], (2 * sp.channels, sp.emb_dim))
    return out if device is None else to_device(out, device)


def embedder_from_jax(tree: Dict, cfg: TransformerConfig, device=None) -> Dict:
    """The JAX embedder tree (``transformer.init_params`` or
    ``init_params_quantized`` with numpy leaves; int8 projections as
    ``q`` / ``s`` pairs) -> tensors, each shape checked against ``cfg``."""
    from .models.transformer import proj_shapes

    out = tree_from_numpy(tree)
    L, D = cfg.n_layers, cfg.dim
    lay = out["layers"]
    _check("tok_emb", out["tok_emb"], (cfg.vocab_size, D))
    shapes = proj_shapes(cfg)
    for name, (fi, fo) in shapes.items():
        _check(f"layers/{name}", lay[name], (L, fi, fo))
    for name in ("attn_norm", "mlp_norm"):
        _check(f"layers/{name}", lay[name], (L, D))
    if "bqkv" in lay:
        _check("layers/bqkv", lay["bqkv"], (L, shapes["wqkv"][1]))
    if "lm_head" in out:
        _check("lm_head", out["lm_head"], (D, cfg.vocab_size))
    return out if device is None else to_device(out, device)


def _lora_shapes(cfg: TransformerConfig, r: int) -> Dict[str, Tuple[int, ...]]:
    from .models.transformer import proj_shapes

    out = {}
    for name, (fi, fo) in proj_shapes(cfg).items():
        out[name + "_lora_a"], out[name + "_lora_b"] = (cfg.n_layers, fi, r), (cfg.n_layers, r, fo)
    return out


def lora_from_jax(tree: Dict, cfg: TransformerConfig, r: int, device=None) -> Dict:
    """A JAX ``transformer.init_lora`` tree with numpy leaves -> f32
    tensors, each shape checked."""
    out = tree_from_numpy(tree)
    want = _lora_shapes(cfg, r)
    if set(out["layers"]) != set(want):
        raise ValueError(f"lora: keys {sorted(out['layers'])} != {sorted(want)}")
    for name, shape in want.items():
        _check(f"layers/{name}", out["layers"][name], shape)
    out = tree_map(lambda t: t.float(), out)
    return out if device is None else to_device(out, device)


def load_lora(path: str, cfg: TransformerConfig, r: int, device="cpu") -> Dict:
    """A LoRA adapter's ``.npz`` (f16 or f32 leaves) loaded in f32 into
    the structure of ``transformer.init_lora(cfg, r)`` on ``device``."""
    like = {"layers": {k: torch.empty(s, device=device) for k, s in _lora_shapes(cfg, r).items()}}
    return load_tree(path, like)


def compat_trees_to_torch(trees: Dict[str, Dict], device) -> Dict[str, Dict]:
    """The numpy trees of a CosyVoice conversion or snapshot
    ({artifact: tree}, ``utils/cosyvoice_convert`` / ``models/compat``)
    -> the same trees of f32 tensors on ``device``. A graph carried as
    wire bytes (``campplus.onnx``'s ``__onnx__``) is not a weight tree and
    is left out."""
    return {artifact: tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(device), tree)
            for artifact, tree in trees.items() if "__onnx__" not in tree}


def _check_vocoder(p: Dict, v) -> None:
    if getattr(v, "kind", "hifigan") == "istft":
        C = v.istft_channels
        if len(p["blocks"]) != v.istft_blocks:
            raise ValueError(f"vocoder: {len(p['blocks'])} blocks != config {v.istft_blocks}")
        _check("vocoder/pre/w", p["pre"]["w"], (7, v.n_mels, C))
        _check("vocoder/blocks/0/conv/w", p["blocks"][0]["conv"]["w"], (v.istft_kernel, C, C))
        _check("vocoder/head/w", p["head"]["w"], (C, v.istft_n_fft + 2))
        return
    n_up = len(v.upsample_rates)
    if len(p["ups"]) != n_up:
        raise ValueError(f"vocoder: {len(p['ups'])} upsampling stages != config {n_up}")
    ch = v.base_channels
    _check("vocoder/pre/w", p["pre"]["w"], (7, v.n_mels, ch))
    for i, up in enumerate(p["ups"]):
        _check(f"vocoder/ups/{i}/t/w", up["t"]["w"], (v.upsample_kernel_sizes[i], ch, ch // 2))
        ch //= 2
        if len(up["mrf"]) != len(v.resblock_kernel_sizes):
            raise ValueError(f"vocoder/ups/{i}: {len(up['mrf'])} resblocks != config "
                             f"{len(v.resblock_kernel_sizes)}")
        for j, (kern, dils) in enumerate(zip(v.resblock_kernel_sizes, v.resblock_dilations)):
            layers = up["mrf"][j]["layers"]
            if len(layers) != len(dils):
                raise ValueError(f"vocoder/ups/{i}/mrf/{j}: {len(layers)} layers != config {len(dils)}")
            for n, layer in enumerate(layers):
                for c in ("c1", "c2"):
                    _check(f"vocoder/ups/{i}/mrf/{j}/layers/{n}/{c}/w", layer[c]["w"], (kern, ch, ch))
    _check("vocoder/post/w", p["post"]["w"], (7, ch, 1))


def load_npz(path: str) -> Dict:
    """Flat-key ``.npz`` (JAX ``utils/checkpoint.save_pytree`` format) ->
    nested dicts/lists of numpy arrays, ready for ``from_jax_tree``."""
    p = str(path) if str(path).endswith(".npz") else str(path) + ".npz"
    root: Dict = {}
    with np.load(p) as data:
        for key in data.files:
            node = root
            parts = key.split(_FLAT_SEP)
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            arr = data[key]
            node[parts[-1]] = arr.astype(np.float32) if arr.dtype == np.float16 else arr

    def fix(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        if set(node) == {"q", "s"}:
            return QTensor(q=node["q"], s=node["s"])
        return node

    return fix(root)


def _flat_keys(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A tree's leaves by flat key, as the JAX checkpoints name them
    (``layers/wqkv``, list indices as segments, an int8 tensor's ``q`` /
    ``s``)."""
    if isinstance(tree, QTensor):
        tree = {"q": tree.q, "s": tree.s}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flat_keys(v, f"{prefix}{_FLAT_SEP}{k}" if prefix else str(k)))
    return out


def save_tree(path: str, tree: Any, metadata: Optional[Dict] = None) -> None:
    """A tree of tensors as the JAX package's ``utils/checkpoint.save_pytree``
    writes a pytree: one flat-key ``.npz`` (numpy adds the suffix where it
    is missing) and a ``<path>.meta.json`` sidecar holding ``metadata`` and
    the sorted keys. bf16 leaves are written as f32 (exact: numpy has no
    bf16), every other leaf in its own dtype."""
    import json
    from pathlib import Path

    flat = {k: (v.float() if v.dtype == torch.bfloat16 else v).detach().cpu().numpy()
            for k, v in _flat_keys(tree).items()}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)
    with open(str(path) + ".meta.json", "w") as f:
        json.dump({**(metadata or {}), "keys": sorted(flat)}, f, indent=2)


def load_tree(path: str, like: Any, extra_ok: bool = False) -> Any:
    """A flat-key ``.npz`` loaded into the structure of ``like`` (a tree of
    tensors), the counterpart of the JAX ``utils/checkpoint.load_pytree``
    for a part of the engine (one module's weights). The file must hold
    ``like``'s keys, each with its shape, and (unless ``extra_ok``, as a
    training checkpoint restored in part) no others: a missing or extra
    key, or another shape, raises and names it. Leaves take ``like``'s
    dtype and device (f16 leaves load as f32 first)."""
    want = _flat_keys(like)
    p = str(path) if str(path).endswith(".npz") else str(path) + ".npz"
    with np.load(p) as data:
        missing = sorted(set(want) - set(data.files))
        extra = [] if extra_ok else sorted(set(data.files) - set(want))
        if missing or extra:
            raise ValueError(f"{p}: missing keys {missing}, extra keys {extra}")
        got = {}
        for key, leaf in want.items():
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{p}: {key} has shape {tuple(arr.shape)}, expected {tuple(leaf.shape)}")
            arr = arr.astype(np.float32) if arr.dtype == np.float16 else arr
            got[key] = torch.from_numpy(np.array(arr, copy=True)).to(dtype=leaf.dtype, device=leaf.device)

    def build(node: Any, prefix: str) -> Any:
        join = (lambda k: f"{prefix}{_FLAT_SEP}{k}") if prefix else str
        if isinstance(node, QTensor):
            return QTensor(q=got[join("q")], s=got[join("s")])
        if isinstance(node, dict):
            return {k: build(v, join(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v, join(i)) for i, v in enumerate(node)]
        return got[prefix]

    return build(like, "")


# ----------------------------------------------------------------------------- init


def init_params(cfg: Config, generator: torch.Generator) -> Dict:
    """Random weights for every module of the engine with the JAX init's
    shapes and scales, drawn on ``generator.device``."""
    from .models import cfm, speaker, speech_tokenizer, token_lm, vocoder

    return {
        "token_lm": token_lm.init_params(cfg.token_lm, generator),
        "cfm": cfm.init_params(cfg.cfm, generator),
        "vocoder": vocoder.init_params(cfg.vocoder, generator),
        "speaker": speaker.init_params(cfg.speaker, generator),
        "speech_tokenizer": speech_tokenizer.init_params(cfg.speech_tokenizer, generator),
    }


def normal(shape, generator: torch.Generator, scale: float = 1.0) -> torch.Tensor:
    return torch.randn(
        shape, generator=generator, device=generator.device, dtype=torch.float32
    ) * scale


def uniform(shape, generator: torch.Generator, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(
        shape, generator=generator, device=generator.device, dtype=torch.float32
    )
    return lo + (hi - lo) * u


def truncated_normal(
    shape, generator: torch.Generator, scale: float, bound: float = 3.0
) -> torch.Tensor:
    t = torch.empty(shape, device=generator.device, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -bound, bound, generator=generator)
    return t * scale
