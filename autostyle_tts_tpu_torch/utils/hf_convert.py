"""Hugging Face checkpoint -> the transformer core's parameter tree.

Counterpart of the JAX ``utils/hf_convert.py``. The reference loaded its
style embedder from Hugging Face checkpoints (Llama-3.2-3B, Qwen2.5-7B);
this maps a Llama / Qwen2-family state dict (tensors or numpy arrays) onto
the layer-stacked fused tree of ``models/transformer.py``:

- q/k/v projections fuse into ``wqkv`` (transposed: torch stores [out, in]),
  gate/up into ``w_gate_up``; per-layer tensors stack on a leading [L] dim;
- Qwen2's attention biases land in ``bqkv``;
- RoPE / RMSNorm / SwiGLU conventions already match.

``convert_state_dict`` works in torch on the tensors' own device, so a
state dict on the card converts there; its f32 values are the JAX
function's bit for bit. ``load_hf_checkpoint`` needs neither
``transformers`` nor ``safetensors``: it reads ``config.json`` with
``json`` and the weights from ``*.safetensors`` through ``read_safetensors``
(an 8-byte header length, a JSON header, raw little-endian buffers) or
from ``pytorch_model*.bin`` through ``torch.load(weights_only=True)``.
``write_safetensors`` writes that format (tests, synthetic checkpoints).
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .config import TransformerConfig
from .device import DeviceLike, resolve_device

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def _t(x: Any) -> torch.Tensor:
    """One weight as an f32 tensor (on its own device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float()
    return torch.from_numpy(np.array(x, np.float32))


def config_from_hf(hf_config: Any) -> TransformerConfig:
    """Build our TransformerConfig from a HF Llama/Qwen2 config object/dict."""
    get = (lambda k, d=None: getattr(hf_config, k, d)) if not isinstance(
        hf_config, dict
    ) else (lambda k, d=None: hf_config.get(k, d))
    return TransformerConfig(
        vocab_size=get("vocab_size"),
        dim=get("hidden_size"),
        n_layers=get("num_hidden_layers"),
        n_heads=get("num_attention_heads"),
        n_kv_heads=get("num_key_value_heads", get("num_attention_heads")),
        ffn_dim=get("intermediate_size"),
        max_seq_len=min(get("max_position_embeddings", 8192), 8192),
        rope_theta=float(get("rope_theta", 10000.0)),
        norm_eps=float(get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(get("tie_word_embeddings", False)),
    )


def convert_state_dict(sd: Dict[str, Any], cfg: TransformerConfig) -> Dict:
    """HF Llama/Qwen2 state_dict -> parameter tree of f32 tensors (on the
    state dict's device)."""
    L = cfg.n_layers

    def get(name: str, layer: Optional[int] = None) -> torch.Tensor:
        key = name.format(i=layer) if layer is not None else name
        for cand in ("model." + key, key):
            if cand in sd:
                return _t(sd[cand])
        raise KeyError(f"missing weight {key!r}")

    def stack_T(name: str) -> torch.Tensor:
        return torch.stack([get(name, i).T for i in range(L)])

    def stack(name: str) -> torch.Tensor:
        return torch.stack([get(name, i) for i in range(L)])

    layers: Dict[str, torch.Tensor] = {
        "attn_norm": stack("layers.{i}.input_layernorm.weight"),
        "wqkv": torch.cat([stack_T("layers.{i}.self_attn.q_proj.weight"),     # [L, D, H*hd]
                           stack_T("layers.{i}.self_attn.k_proj.weight"),
                           stack_T("layers.{i}.self_attn.v_proj.weight")], dim=-1),
        "wo": stack_T("layers.{i}.self_attn.o_proj.weight"),
        "mlp_norm": stack("layers.{i}.post_attention_layernorm.weight"),
        "w_gate_up": torch.cat([stack_T("layers.{i}.mlp.gate_proj.weight"),
                                stack_T("layers.{i}.mlp.up_proj.weight")], dim=-1),
        "w_down": stack_T("layers.{i}.mlp.down_proj.weight"),
    }
    if any("self_attn.q_proj.bias" in key for key in sd):  # Qwen2 family
        layers["bqkv"] = torch.cat([stack("layers.{i}.self_attn.q_proj.bias"),
                                    stack("layers.{i}.self_attn.k_proj.bias"),
                                    stack("layers.{i}.self_attn.v_proj.bias")], dim=-1)

    params: Dict[str, Any] = {
        "tok_emb": get("embed_tokens.weight"),
        "layers": layers,
        "final_norm": get("norm.weight"),
    }
    if not cfg.tie_embeddings:
        if "lm_head.weight" in sd:
            params["lm_head"] = _t(sd["lm_head.weight"]).T.contiguous()
        else:
            params["lm_head"] = params["tok_emb"].T.contiguous()
    return params


# ----------------------------------------------------------------------------- safetensors


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: CPU tensor}: an 8-byte
    little-endian header length, a JSON header {name: {dtype, shape,
    data_offsets}} (and an optional ``__metadata__``), then the raw
    little-endian buffers. The tensors share one buffer read from the
    file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(data)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape)) if shape else 1
        if end - start != count * torch.empty((), dtype=dtype).element_size():
            raise ValueError(f"{path}: tensor {name!r} spans {end - start} bytes for shape {shape}")
        t = torch.frombuffer(data, dtype=dtype, count=count, offset=start) if count else \
            torch.empty((0,), dtype=dtype)
        out[name] = t.reshape(shape)
    return out


def write_safetensors(path, tensors: Dict[str, torch.Tensor]) -> None:
    """{name: tensor} -> a ``.safetensors`` file (the format
    ``read_safetensors`` reads; data in name order, 8-byte aligned)."""
    header: Dict[str, Any] = {}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous().cpu()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def load_state_dict(model_dir) -> Dict[str, torch.Tensor]:
    """Every tensor of a local HF checkpoint directory (CPU): all
    ``*.safetensors`` files, else all ``pytorch_model*.bin`` files."""
    d = Path(model_dir)
    files = sorted(d.glob("*.safetensors"))
    if files:
        sd: Dict[str, torch.Tensor] = {}
        for f in files:
            sd.update(read_safetensors(f))
        return sd
    files = sorted(d.glob("pytorch_model*.bin"))
    if not files:
        raise FileNotFoundError(f"{d}: no *.safetensors or pytorch_model*.bin weights")
    sd = {}
    for f in files:
        sd.update(torch.load(f, map_location="cpu", weights_only=True))
    return sd


def load_hf_checkpoint(model_dir, device: DeviceLike = None) -> Tuple[TransformerConfig, Dict]:
    """A local HF checkpoint directory (``config.json`` + safetensors or
    bin weights) -> (cfg, params) on ``device`` (the card unless "cpu"):
    the weights move there as stored, then convert there."""
    dev = resolve_device(device)
    cfg = config_from_hf(json.loads((Path(model_dir) / "config.json").read_text()))
    sd = {k: v.to(dev) for k, v in load_state_dict(model_dir).items()}
    return cfg, convert_state_dict(sd, cfg)
