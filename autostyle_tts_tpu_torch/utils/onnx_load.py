"""Dependency-free ONNX reader and writer (the protobuf wire format).

Counterpart of the JAX ``utils/onnx_load.py``, a copy of its numpy code.
The CosyVoice release ships its speech tokenizer and CAM++ speaker encoder
as ONNX models (``speech_tokenizer_v1.onnx``, ``campplus.onnx``); no
``onnx`` package is needed to read them:

  ModelProto.graph (field 7) -> GraphProto.initializer (field 5, repeated
  TensorProto) -> {dims=1, data_type=2, float_data=4, int64_data=7, name=8,
  raw_data=9}

- ``load_onnx_weights``: the initializers alone (the tokenizer, whose
  compute is re-expressed in ``models/compat/s3_tokenizer.py`` through the
  name-keyed rules of ``utils/cosyvoice_convert.py``);
- ``load_onnx_graph``: nodes, attributes and graph I/O, which
  ``ops/onnx_exec.py`` runs op by op (``campplus.onnx``, whose initializer
  names cannot be mapped blind).

``write_onnx_tensors`` / ``write_onnx_model`` emit minimal valid files
(synthetic releases and tests).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

# TensorProto.DataType -> numpy dtype
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}

_WT_VARINT, _WT_I64, _WT_LEN, _WT_I32 = 0, 1, 2, 5


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, payload-bytes) over a message."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == _WT_VARINT:
            v, i = _read_varint(buf, i)
            yield fno, wt, v.to_bytes((v.bit_length() + 7) // 8 or 1, "little")
        elif wt == _WT_I64:
            yield fno, wt, buf[i : i + 8]
            i += 8
        elif wt == _WT_LEN:
            ln, i = _read_varint(buf, i)
            yield fno, wt, buf[i : i + ln]
            i += ln
        elif wt == _WT_I32:
            yield fno, wt, buf[i : i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt} at offset {i}")


def _varint_value(payload: bytes) -> int:
    return int.from_bytes(payload, "little")


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = 1
    name = ""
    raw = b""
    floats: List[bytes] = []
    int64s: List[bytes] = []
    for fno, wt, payload in _fields(buf):
        if fno == 1:   # dims (varint or packed)
            if wt == _WT_VARINT:
                dims.append(_varint_value(payload))
            else:
                i = 0
                while i < len(payload):
                    v, i = _read_varint(payload, i)
                    dims.append(v)
        elif fno == 2:
            dtype = _varint_value(payload)
        elif fno == 4:  # float_data (packed or repeated i32)
            floats.append(payload)
        elif fno == 7:  # int64_data (repeated varint or packed)
            if wt == _WT_VARINT:
                # _fields already decoded the varint to little-endian value
                # bytes — mark with None so the collector reads it as such
                int64s.append((None, payload))
            else:
                int64s.append(("packed", payload))
        elif fno == 8:
            name = payload.decode("utf-8")
        elif fno == 9:
            raw = payload
    np_dtype = _DTYPES.get(dtype)
    if np_dtype is None:
        raise ValueError(f"tensor {name!r}: unsupported data_type {dtype}")
    if raw:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif floats:
        arr = np.frombuffer(b"".join(floats), dtype=np.float32).astype(np_dtype)
    elif int64s:
        vals = []
        for kind, chunk in int64s:
            if kind is None:
                vals.append(_varint_value(chunk))
            else:
                i = 0
                while i < len(chunk):
                    v, i = _read_varint(chunk, i)
                    vals.append(v)
        # two's-complement for negative int64 (e.g. -1 axes/shape entries)
        vals = [v - (1 << 64) if v >= (1 << 63) else v for v in vals]
        arr = np.asarray(vals, np.int64).astype(np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    if not dims and arr.size == 1:
        arr = arr.reshape(())      # no dims entries = a 0-d scalar tensor
    return name, arr.reshape(dims) if dims else arr


def load_onnx_weights(path) -> Dict[str, np.ndarray]:
    """ONNX file -> {initializer name: ndarray}."""
    buf = Path(path).read_bytes()
    out: Dict[str, np.ndarray] = {}
    for fno, wt, payload in _fields(buf):          # ModelProto
        if fno == 7 and wt == _WT_LEN:             # graph
            for g_fno, g_wt, g_payload in _fields(payload):   # GraphProto
                if g_fno == 5 and g_wt == _WT_LEN:  # initializer
                    name, arr = _parse_tensor(g_payload)
                    out[name] = arr
    return out


# --------------------------------------------------------------- graph parse


@dataclass
class OnnxNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str = ""
    attrs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class OnnxGraph:
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    inputs: List[str]           # graph inputs that are NOT initializers
    outputs: List[str]


def _parse_attribute(buf: bytes) -> Tuple[str, Any]:
    """AttributeProto -> (name, python value). Typed fields: f=2, i=3, s=4,
    t=5 (TensorProto), floats=7, ints=8, strings=9; `type` (20) is ignored —
    presence of the value fields is unambiguous for our writer/readers."""
    name = ""
    value: Any = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for fno, wt, payload in _fields(buf):
        if fno == 1:
            name = payload.decode("utf-8")
        elif fno == 2:
            value = struct.unpack("<f", payload)[0]
        elif fno == 3:
            v = _varint_value(payload)
            value = v - (1 << 64) if v >= (1 << 63) else v   # sint via 2c
        elif fno == 4:
            value = payload.decode("utf-8", errors="surrogateescape")
        elif fno == 5:
            value = _parse_tensor(payload)[1]
        elif fno == 7:   # floats: packed or repeated fixed32
            for i in range(0, len(payload), 4):
                floats.append(struct.unpack("<f", payload[i : i + 4])[0])
        elif fno == 8:   # ints: repeated varint or packed
            if wt == _WT_VARINT:
                # _fields already decoded the varint to little-endian
                # VALUE bytes — re-parsing them as varints breaks for
                # values >= 128 (e.g. negative axes in 2's complement)
                v = _varint_value(payload)
                ints.append(v - (1 << 64) if v >= (1 << 63) else v)
            else:
                i = 0
                while i < len(payload):
                    v, i = _read_varint(payload, i)
                    ints.append(v - (1 << 64) if v >= (1 << 63) else v)
        elif fno == 9:
            strings.append(payload)
    if floats:
        value = floats
    elif ints:
        value = ints
    elif strings:
        value = [s.decode("utf-8", errors="surrogateescape") for s in strings]
    return name, value


def _parse_node(buf: bytes) -> OnnxNode:
    node = OnnxNode(op_type="", inputs=[], outputs=[])
    for fno, wt, payload in _fields(buf):
        if fno == 1:
            node.inputs.append(payload.decode("utf-8"))
        elif fno == 2:
            node.outputs.append(payload.decode("utf-8"))
        elif fno == 3:
            node.name = payload.decode("utf-8")
        elif fno == 4:
            node.op_type = payload.decode("utf-8")
        elif fno == 5:
            k, v = _parse_attribute(payload)
            node.attrs[k] = v
    return node


def _value_info_name(buf: bytes) -> str:
    for fno, wt, payload in _fields(buf):
        if fno == 1:
            return payload.decode("utf-8")
    return ""


def load_onnx_graph(source) -> OnnxGraph:
    """ONNX file path or raw bytes -> OnnxGraph (nodes, initializers, I/O)."""
    buf = source if isinstance(source, (bytes, bytearray)) else Path(
        source).read_bytes()
    nodes: List[OnnxNode] = []
    inits: Dict[str, np.ndarray] = {}
    g_in: List[str] = []
    g_out: List[str] = []
    for fno, wt, payload in _fields(bytes(buf)):       # ModelProto
        if fno == 7 and wt == _WT_LEN:                 # graph
            for g_fno, g_wt, g_payload in _fields(payload):
                if g_fno == 1:
                    nodes.append(_parse_node(g_payload))
                elif g_fno == 5:
                    name, arr = _parse_tensor(g_payload)
                    inits[name] = arr
                elif g_fno == 11:
                    g_in.append(_value_info_name(g_payload))
                elif g_fno == 12:
                    g_out.append(_value_info_name(g_payload))
    inputs = [n for n in g_in if n not in inits]
    if not inputs:
        # some exporters list only real inputs; others omit input protos —
        # fall back to names consumed before they are produced
        produced = set(inits)
        for node in nodes:
            for i in node.inputs:
                if i and i not in produced and i not in inputs:
                    inputs.append(i)
            produced.update(node.outputs)
    if not g_out and nodes:
        g_out = list(nodes[-1].outputs)
    return OnnxGraph(nodes=nodes, initializers=inits, inputs=inputs,
                     outputs=g_out)


# --------------------------------------------------------------- test writer


def _emit_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _emit_field(fno: int, wt: int, payload: bytes) -> bytes:
    head = _emit_varint((fno << 3) | wt)
    if wt == _WT_LEN:
        return head + _emit_varint(len(payload)) + payload
    return head + payload


def write_onnx_tensors(path, tensors: Dict[str, np.ndarray]) -> None:
    """Emit a minimal ModelProto containing only graph.initializer entries
    (round-trip fixture for load_onnx_weights; also what a real exporter's
    weight section looks like on the wire)."""
    Path(path).write_bytes(
        _emit_field(7, _WT_LEN, _emit_inits(tensors) + _emit_field(
            2, _WT_LEN, b"g"))
    )


def _emit_tensor(name: str, arr: np.ndarray) -> bytes:
    rev_dtype = {np.dtype(v): k for k, v in _DTYPES.items()}
    t = b""
    for d in arr.shape:
        t += _emit_field(1, _WT_VARINT, _emit_varint(int(d)))
    t += _emit_field(2, _WT_VARINT, _emit_varint(rev_dtype[arr.dtype]))
    t += _emit_field(8, _WT_LEN, name.encode("utf-8"))
    t += _emit_field(9, _WT_LEN, np.ascontiguousarray(arr).tobytes())
    return t


def _emit_inits(tensors: Dict[str, np.ndarray]) -> bytes:
    return b"".join(
        _emit_field(5, _WT_LEN, _emit_tensor(name, arr))
        for name, arr in tensors.items()
    )


def _emit_attr(name: str, value: Any) -> bytes:
    a = _emit_field(1, _WT_LEN, name.encode("utf-8"))
    if isinstance(value, bool):
        value = int(value)
    if isinstance(value, float):
        a += _emit_field(2, _WT_I32, struct.pack("<f", value))
    elif isinstance(value, int):
        a += _emit_field(3, _WT_VARINT, _emit_varint(value & ((1 << 64) - 1)))
    elif isinstance(value, str):
        a += _emit_field(4, _WT_LEN, value.encode("utf-8"))
    elif isinstance(value, np.ndarray):
        a += _emit_field(5, _WT_LEN, _emit_tensor("", value))
    elif isinstance(value, (list, tuple)) and value and isinstance(
            value[0], float):
        for v in value:
            a += _emit_field(7, _WT_I32, struct.pack("<f", v))
    elif isinstance(value, (list, tuple)):
        for v in value:
            a += _emit_field(8, _WT_VARINT,
                             _emit_varint(int(v) & ((1 << 64) - 1)))
    else:
        raise TypeError(f"attr {name}: unsupported value {value!r}")
    return a


def write_onnx_model(
    path,
    tensors: Dict[str, np.ndarray],
    nodes: List["OnnxNode"],
    inputs: List[str],
    outputs: List[str],
) -> None:
    """Emit a ModelProto with a real node graph (the synthetic-release shape
    for graph-executed artifacts like campplus.onnx). `path=None` returns
    the bytes instead of writing."""
    g = b"".join(
        _emit_field(1, _WT_LEN, _node_bytes(node)) for node in nodes
    ) + _emit_inits(tensors)
    g += _emit_field(2, _WT_LEN, b"g")
    for i in inputs:
        g += _emit_field(11, _WT_LEN, _emit_field(1, _WT_LEN,
                                                  i.encode("utf-8")))
    for o in outputs:
        g += _emit_field(12, _WT_LEN, _emit_field(1, _WT_LEN,
                                                  o.encode("utf-8")))
    model = _emit_field(7, _WT_LEN, g)
    if path is None:
        return model
    Path(path).write_bytes(model)


def _node_bytes(node: "OnnxNode") -> bytes:
    n = b""
    for i in node.inputs:
        n += _emit_field(1, _WT_LEN, i.encode("utf-8"))
    for o in node.outputs:
        n += _emit_field(2, _WT_LEN, o.encode("utf-8"))
    if node.name:
        n += _emit_field(3, _WT_LEN, node.name.encode("utf-8"))
    n += _emit_field(4, _WT_LEN, node.op_type.encode("utf-8"))
    for k, v in node.attrs.items():
        n += _emit_field(5, _WT_LEN, _emit_attr(k, v))
    return n
