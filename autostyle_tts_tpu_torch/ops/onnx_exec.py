"""Run an ONNX graph op by op in eager PyTorch.

Counterpart of the JAX ``ops/onnx_exec.py``, over the same op set, the same
attributes and the same errors. The CosyVoice release's ``campplus.onnx``
(a CAM++ D-TDNN export) has initializer names that cannot be mapped blind
into a rule table, so ``models/compat/campplus.py`` runs its graph itself.

Values flow through an env {name: value}. A value that depends only on
initializers, Constants and Shapes is a host numpy array ("static"), as in
the JAX runner, where it stays a compile-time constant: Reshape / Slice /
Unsqueeze targets and axes inputs must be static, and the same graphs that
the JAX runner refuses for a traced shape are refused here. Everything else
is a tensor on the runner's device. As under JAX (64-bit types off), f64
values become f32 when they turn into tensors; ``ArgMax`` / ``ArgMin`` give
int32.

``unsupported_ops`` lists every op configuration the runner cannot
execute, attribute-gated ones included (pool ``ceil_mode``, ``Pad`` axes),
so a converter can report them before the first call.
"""

from __future__ import annotations

import operator
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.onnx_load import OnnxGraph, OnnxNode

# initializer int tensors at most this many elements stay host-static
_STATIC_INT_MAX = 256


def _is_static(v) -> bool:
    return isinstance(v, np.ndarray) or np.isscalar(v)


def _static_int_list(v, what: str) -> List[int]:
    if not _is_static(v):
        raise ValueError(
            f"{what} must be statically known (initializer/Constant); got a "
            f"computed tensor — shapes and axes must be static"
        )
    return [int(x) for x in np.asarray(v).reshape(-1)]


class _Env:
    """The graph's values, and their tensor form on ``device``."""

    def __init__(self, device: torch.device):
        self.values: Dict[str, Any] = {}
        self.device = device

    def get(self, name: str):
        if name not in self.values:
            raise KeyError(f"onnx_exec: value {name!r} not produced yet "
                           f"(graph not topologically ordered?)")
        return self.values[name]

    def as_t(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v
        a = np.asarray(v)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a, copy=True)).to(self.device)

    def t(self, name: str) -> torch.Tensor:
        return self.as_t(self.get(name))


def _arith(fn: Callable):
    """A binary op: numpy when both inputs are static (python operators
    keep numpy as numpy under JAX too), else tensors."""
    def op(e: _Env, n: OnnxNode):
        a, b = e.get(n.inputs[0]), e.get(n.inputs[1])
        if _is_static(a) and _is_static(b):
            return fn(np.asarray(a), np.asarray(b))
        return fn(e.as_t(a), e.as_t(b))
    return op


def _unary(fn: Callable):
    return lambda e, n: fn(e.t(n.inputs[0]))


def _pad_nd(x: torch.Tensor, widths, value: float = 0.0) -> torch.Tensor:
    """Constant pad of every axis by (before, after) pairs."""
    flat = []
    for lo, hi in reversed(widths):
        flat += [int(lo), int(hi)]
    return F.pad(x, flat, value=value)


def _pool_window(x: torch.Tensor, node: OnnxNode, kind: str):
    """Shared MaxPool/AveragePool (N, C, *spatial)."""
    kshape = node.attrs["kernel_shape"]
    nd = len(kshape)
    strides = node.attrs.get("strides", [1] * nd)
    pads = node.attrs.get("pads", [0] * (2 * nd))
    if node.attrs.get("auto_pad", "NOTSET") not in ("NOTSET", ""):
        raise ValueError("Pool auto_pad is not supported; export with "
                         "explicit pads")
    if int(node.attrs.get("ceil_mode", 0)):
        raise ValueError("Pool ceil_mode=1 is not supported")
    widths = [(0, 0), (0, 0)] + [(pads[i], pads[i + nd]) for i in range(nd)]
    pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[nd] if kind == "max" else \
        {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}[nd]
    if kind == "max":
        return pool(_pad_nd(x, widths, float("-inf")), tuple(kshape), tuple(strides))
    total = pool(_pad_nd(x, widths), tuple(kshape), tuple(strides)) * float(np.prod(kshape))
    if int(node.attrs.get("count_include_pad", 0)):
        return total / float(np.prod(kshape))
    # ONNX default: average over the NON-pad elements only — count them
    # with the same window reduction over a ones tensor
    ones = torch.ones(x.shape[:1] + (1,) + x.shape[2:], dtype=x.dtype, device=x.device)
    cnt = pool(_pad_nd(ones, widths), tuple(kshape), tuple(strides)) * float(np.prod(kshape))
    return total / cnt


def _conv(e: _Env, node: OnnxNode):
    """Conv: ONNX NC* layout, torch-convention weights [out, in/g, *k]."""
    x = e.t(node.inputs[0])
    w = e.t(node.inputs[1])
    nd = w.ndim - 2
    strides = node.attrs.get("strides", [1] * nd)
    dilations = node.attrs.get("dilations", [1] * nd)
    group = int(node.attrs.get("group", 1))
    pads = node.attrs.get("pads", [0] * (2 * nd))
    if node.attrs.get("auto_pad", "NOTSET") not in ("NOTSET", ""):
        raise ValueError("Conv auto_pad is not supported; export with "
                         "explicit pads")
    xp = _pad_nd(x, [(0, 0), (0, 0)] + [(pads[i], pads[i + nd]) for i in range(nd)])
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[nd]
    out = conv(xp, w, None, tuple(strides), 0, tuple(dilations), group)
    if len(node.inputs) > 2 and node.inputs[2]:
        out = out + e.t(node.inputs[2]).reshape((1, -1) + (1,) * nd)
    return out


def _gemm(e: _Env, node: OnnxNode):
    a = e.t(node.inputs[0])
    b = e.t(node.inputs[1])
    if int(node.attrs.get("transA", 0)):
        a = a.T
    if int(node.attrs.get("transB", 0)):
        b = b.T
    out = float(node.attrs.get("alpha", 1.0)) * (a @ b)
    if len(node.inputs) > 2 and node.inputs[2]:
        out = out + float(node.attrs.get("beta", 1.0)) * e.t(node.inputs[2])
    return out


def _batchnorm(e: _Env, node: OnnxNode):
    x, scale, bias, mean, var = (e.t(i) for i in node.inputs[:5])
    eps = float(node.attrs.get("epsilon", 1e-5))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = torch.rsqrt(var.float() + eps).to(x.dtype)
    return (x - mean.reshape(shape)) * (scale * inv).reshape(shape) + bias.reshape(shape)


def _layernorm(e: _Env, node: OnnxNode):
    x = e.t(node.inputs[0])
    axis = int(node.attrs.get("axis", -1))
    eps = float(node.attrs.get("epsilon", 1e-5))
    xf = x.float()
    mu = xf.mean(axis, keepdim=True)
    var = ((xf - mu) ** 2).mean(axis, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * e.t(node.inputs[1])
    if len(node.inputs) > 2 and node.inputs[2]:
        out = out + e.t(node.inputs[2])
    return out.to(x.dtype)


def _reduce(e: _Env, node: OnnxNode, fn: Callable):
    x = e.t(node.inputs[0])
    if len(node.inputs) > 1 and node.inputs[1]:
        axes = _static_int_list(e.get(node.inputs[1]), "Reduce axes")
    else:
        axes = node.attrs.get("axes")
    keep = bool(node.attrs.get("keepdims", 1))
    dims = tuple(axes) if axes is not None else tuple(range(x.ndim))
    return fn(x, dim=dims, keepdim=keep)


def _slice(e: _Env, node: OnnxNode):
    x = e.get(node.inputs[0])
    if len(node.inputs) > 1:
        starts = _static_int_list(e.get(node.inputs[1]), "Slice starts")
        ends = _static_int_list(e.get(node.inputs[2]), "Slice ends")
        axes = (_static_int_list(e.get(node.inputs[3]), "Slice axes")
                if len(node.inputs) > 3 and node.inputs[3]
                else list(range(len(starts))))
        steps = (_static_int_list(e.get(node.inputs[4]), "Slice steps")
                 if len(node.inputs) > 4 and node.inputs[4]
                 else [1] * len(starts))
    else:   # opset<10 attribute form
        starts = node.attrs["starts"]
        ends = node.attrs["ends"]
        axes = node.attrs.get("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    for s, end, a, st in zip(starts, ends, axes, steps):
        dim = x.shape[a]
        end = min(end, dim) if end >= 0 else end
        sl = slice(s, end, st)
        if st > 0 or _is_static(x):
            idx: List[Any] = [slice(None)] * x.ndim
            idx[a] = sl
            x = x[tuple(idx)]
        else:   # torch slicing takes no negative step
            keep = torch.as_tensor(list(range(dim))[sl], dtype=torch.long, device=x.device)
            x = x.index_select(a, keep)
    return x


def _unsqueeze_axes(e: _Env, node: OnnxNode) -> List[int]:
    if len(node.inputs) > 1 and node.inputs[1]:
        return _static_int_list(e.get(node.inputs[1]), "axes")
    return list(node.attrs["axes"])


def _expand_dims(x: torch.Tensor, axes) -> torch.Tensor:
    rank = x.ndim + len(axes)
    for a in sorted(a % rank for a in axes):
        x = x.unsqueeze(a)
    return x


def _squeeze(e: _Env, n: OnnxNode):
    x = e.t(n.inputs[0])
    if (len(n.inputs) > 1 and n.inputs[1]) or "axes" in n.attrs:
        axes = tuple(a % x.ndim for a in _unsqueeze_axes(e, n))
        bad = [a for a in axes if x.shape[a] != 1]
        if bad:
            raise ValueError(f"Squeeze: axes {bad} of shape {tuple(x.shape)} are not 1")
        return x.squeeze(axes)
    return x.squeeze()


_DTYPE_OF_ONNX = {
    1: torch.float32, 6: torch.int32, 7: torch.int64, 9: torch.bool,
    10: torch.float16, 11: torch.float32, 2: torch.uint8, 3: torch.int8,
}
_NP_DTYPE_OF_ONNX = {
    1: np.float32, 6: np.int32, 7: np.int64, 9: np.bool_,
    10: np.float16, 11: np.float64, 2: np.uint8, 3: np.int8,
}


def _softmax(x: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.softmax(x.float(), dim=axis).to(x.dtype)


def _clip(e: _Env, n: OnnxNode):
    lo = (e.t(n.inputs[1]) if len(n.inputs) > 1 and n.inputs[1] else n.attrs.get("min"))
    hi = (e.t(n.inputs[2]) if len(n.inputs) > 2 and n.inputs[2] else n.attrs.get("max"))
    x = e.t(n.inputs[0])
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype, device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype, device=x.device))
    return x


def _where(e: _Env, n: OnnxNode):
    c, a, b = e.t(n.inputs[0]), e.t(n.inputs[1]), e.t(n.inputs[2])
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.where(c.bool(), a.to(dt), b.to(dt))


# op -> (env, node) -> value (or tuple of values for multi-output ops)
OPS: Dict[str, Callable] = {
    "Add": _arith(operator.add),
    "Sub": _arith(operator.sub),
    "Mul": _arith(operator.mul),
    "Div": _arith(operator.truediv),
    "Pow": _arith(operator.pow),
    "Sqrt": _unary(torch.sqrt),
    "Exp": _unary(torch.exp),
    "Log": _unary(torch.log),
    "Neg": _unary(torch.neg),
    "Abs": _unary(torch.abs),
    "Erf": lambda e, n: torch.erf(e.t(n.inputs[0]).float()),
    "Tanh": _unary(torch.tanh),
    "Sigmoid": _unary(torch.sigmoid),
    "Relu": _unary(torch.relu),
    "LeakyRelu": lambda e, n: F.leaky_relu(
        e.t(n.inputs[0]), float(n.attrs.get("alpha", 0.01))),
    "PRelu": lambda e, n: _prelu(e.t(n.inputs[0]), e.t(n.inputs[1])),
    "Elu": lambda e, n: F.elu(e.t(n.inputs[0]), float(n.attrs.get("alpha", 1.0))),
    "Gelu": lambda e, n: F.gelu(
        e.t(n.inputs[0]),
        approximate="tanh" if n.attrs.get("approximate", "none") == "tanh" else "none"),
    "Clip": _clip,
    "Softmax": lambda e, n: _softmax(e.t(n.inputs[0]), int(n.attrs.get("axis", -1))),
    "MatMul": lambda e, n: torch.matmul(e.t(n.inputs[0]), e.t(n.inputs[1])),
    "Gemm": _gemm,
    "Conv": _conv,
    "BatchNormalization": _batchnorm,
    "LayerNormalization": _layernorm,
    "InstanceNormalization": lambda e, n: _instancenorm(e, n),
    "MaxPool": lambda e, n: _pool_window(e.t(n.inputs[0]), n, "max"),
    "AveragePool": lambda e, n: _pool_window(e.t(n.inputs[0]), n, "avg"),
    "GlobalAveragePool": lambda e, n: e.t(n.inputs[0]).mean(
        dim=tuple(range(2, e.t(n.inputs[0]).ndim)), keepdim=True),
    "ReduceMean": lambda e, n: _reduce(e, n, torch.mean),
    "ReduceSum": lambda e, n: _reduce(e, n, torch.sum),
    "ReduceMax": lambda e, n: _reduce(e, n, torch.amax),
    "ReduceMin": lambda e, n: _reduce(e, n, torch.amin),
    "Concat": lambda e, n: torch.cat(
        [e.t(i) for i in n.inputs], dim=int(n.attrs["axis"])),
    "Transpose": lambda e, n: _transpose(e.t(n.inputs[0]), n.attrs.get("perm")),
    "Reshape": lambda e, n: torch.reshape(
        e.t(n.inputs[0]),
        tuple(_static_int_list(e.get(n.inputs[1]), "Reshape shape"))),
    "Flatten": lambda e, n: e.t(n.inputs[0]).reshape(
        (int(np.prod(e.get(n.inputs[0]).shape[: int(n.attrs.get("axis", 1))]) or 1),
         -1)),
    "Unsqueeze": lambda e, n: _expand_dims(e.t(n.inputs[0]), _unsqueeze_axes(e, n)),
    "Squeeze": _squeeze,
    "Gather": lambda e, n: _gather(
        e.t(n.inputs[0]), e.t(n.inputs[1]), int(n.attrs.get("axis", 0))),
    "Cast": lambda e, n: e.t(n.inputs[0]).to(_DTYPE_OF_ONNX[int(n.attrs["to"])]),
    "Identity": lambda e, n: e.get(n.inputs[0]),
    "Dropout": lambda e, n: e.get(n.inputs[0]),     # inference
    "Constant": lambda e, n: np.asarray(
        n.attrs.get("value", n.attrs.get("value_float",
                                         n.attrs.get("value_int")))),
    "Shape": lambda e, n: np.asarray(tuple(e.get(n.inputs[0]).shape), np.int64),
    "ConstantOfShape": lambda e, n: np.full(
        _static_int_list(e.get(n.inputs[0]), "ConstantOfShape shape"),
        n.attrs["value"].reshape(-1)[0] if "value" in n.attrs
        else np.float32(0),
    ),   # np.full keeps the fill value's dtype (spec: f32 when no value)
    "Expand": lambda e, n: torch.broadcast_to(
        e.t(n.inputs[0]),
        np.broadcast_shapes(
            tuple(e.get(n.inputs[0]).shape),
            tuple(_static_int_list(e.get(n.inputs[1]), "Expand shape")))),
    "Range": lambda e, n: np.arange(
        _static_int_list(e.get(n.inputs[0]), "Range start")[0],
        _static_int_list(e.get(n.inputs[1]), "Range limit")[0],
        _static_int_list(e.get(n.inputs[2]), "Range delta")[0]),
    "Where": _where,
    "Equal": _arith(operator.eq),
    "Less": _arith(operator.lt),
    "Greater": _arith(operator.gt),
    "LessOrEqual": _arith(operator.le),
    "GreaterOrEqual": _arith(operator.ge),
    "Not": lambda e, n: torch.logical_not(e.t(n.inputs[0])),
    "And": lambda e, n: torch.logical_and(e.t(n.inputs[0]), e.t(n.inputs[1])),
    "Or": lambda e, n: torch.logical_or(e.t(n.inputs[0]), e.t(n.inputs[1])),
    "Min": lambda e, n: _variadic(e, n, torch.minimum),
    "Max": lambda e, n: _variadic(e, n, torch.maximum),
    # the real speech-tokenizer export's VQ is a nearest-codebook ArgMin
    "ArgMax": lambda e, n: _arg_reduce(e, n, torch.argmax),
    "ArgMin": lambda e, n: _arg_reduce(e, n, torch.argmin),
    "Pad": lambda e, n: _pad(e, n),
    # transformer-export staples: attention einsums, in-graph positional
    # tables, Trilu causal masks
    "Einsum": lambda e, n: torch.einsum(
        n.attrs["equation"], *(e.t(i) for i in n.inputs)),
    "Sin": _unary(torch.sin),
    "Cos": _unary(torch.cos),
    "Trilu": lambda e, n: (
        torch.triu if int(n.attrs.get("upper", 1)) else torch.tril
    )(
        e.t(n.inputs[0]),
        _static_int_list(e.get(n.inputs[1]), "Trilu k")[0]
        if len(n.inputs) > 1 and n.inputs[1] else 0,
    ),
    "Split": None,      # handled in run() (multi-output)
}


def _transpose(x: torch.Tensor, perm) -> torch.Tensor:
    return x.permute(*(perm if perm is not None else reversed(range(x.ndim))))


def _prelu(x: torch.Tensor, slope: torch.Tensor) -> torch.Tensor:
    """ONNX PRelu: a [C] slope broadcasts against the CHANNEL dim of an
    NC* tensor (unidirectional broadcast), not numpy's trailing-dim rule."""
    if slope.ndim == 1 and x.ndim > 2 and slope.shape[0] == x.shape[1]:
        slope = slope.reshape((1, -1) + (1,) * (x.ndim - 2))
    return torch.where(x >= 0, x, slope * x)


def _gather(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """ONNX Gather allows negative indices (python-style): normalize them."""
    axis = axis % x.ndim
    idx = idx.long()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


def _variadic(e: _Env, n: OnnxNode, fn: Callable):
    out = e.t(n.inputs[0])
    for i in n.inputs[1:]:
        out = fn(out, e.t(i))
    return out


def _arg_reduce(e: _Env, n: OnnxNode, fn: Callable):
    x = e.t(n.inputs[0])
    axis = int(n.attrs.get("axis", 0))
    if int(n.attrs.get("select_last_index", 0)):
        raise ValueError("Arg{Max,Min} select_last_index is not supported")
    out = fn(x, dim=axis).to(torch.int32)
    if int(n.attrs.get("keepdims", 1)):
        out = out.unsqueeze(axis % x.ndim)
    return out


def _pad(e: _Env, n: OnnxNode):
    x = e.t(n.inputs[0])
    mode = n.attrs.get("mode", "constant")
    if len(n.inputs) > 3 and n.inputs[3]:
        raise ValueError("Pad with an explicit `axes` input is not "
                         "supported; export with full-rank pads")
    if len(n.inputs) > 1 and n.inputs[1]:
        pads = _static_int_list(e.get(n.inputs[1]), "Pad pads")
    else:
        pads = list(n.attrs["pads"])
    value = 0.0
    if len(n.inputs) > 2 and n.inputs[2]:
        v = e.get(n.inputs[2])
        if not _is_static(v):
            raise ValueError("Pad constant_value must be statically known (initializer/Constant)")
        value = float(np.asarray(v).reshape(-1)[0])
    nd = x.ndim
    widths = [(pads[i], pads[i + nd]) for i in range(nd)]
    if any(lo < 0 or hi < 0 for lo, hi in widths):
        raise ValueError(f"Pad: negative pads {pads} are not supported")
    if mode == "constant":
        return _pad_nd(x, widths, value)
    if mode in ("reflect", "edge"):
        for a, (lo, hi) in enumerate(widths):
            if lo or hi:
                src = np.pad(np.arange(x.shape[a]), (lo, hi), mode="reflect" if mode == "reflect" else "edge")
                x = x.index_select(a, torch.as_tensor(src, dtype=torch.long, device=x.device))
        return x
    raise ValueError(f"Pad mode {mode!r} is not supported")


def _instancenorm(e: _Env, n: OnnxNode):
    x = e.t(n.inputs[0])
    eps = float(n.attrs.get("epsilon", 1e-5))
    axes = tuple(range(2, x.ndim))
    xf = x.float()
    mu = xf.mean(axes, keepdim=True)
    var = ((xf - mu) ** 2).mean(axes, keepdim=True)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * e.t(n.inputs[1]).reshape(shape) + e.t(n.inputs[2]).reshape(shape)).to(x.dtype)


# ops computed in NUMPY when every input is host-static, so shape plumbing
# (Shape -> Gather -> Unsqueeze -> Concat -> Reshape chains) stays static
# (arithmetic ops fold through _arith)
_NP_FOLD: Dict[str, Callable] = {
    "Gather": lambda e, n: np.take(
        np.asarray(e.get(n.inputs[0])), np.asarray(e.get(n.inputs[1])),
        axis=int(n.attrs.get("axis", 0))),
    "Concat": lambda e, n: np.concatenate(
        [np.asarray(e.get(i)) for i in n.inputs], axis=int(n.attrs["axis"])),
    "Unsqueeze": lambda e, n: np.expand_dims(
        np.asarray(e.get(n.inputs[0])), tuple(_unsqueeze_axes(e, n))),
    "Squeeze": lambda e, n: np.squeeze(
        np.asarray(e.get(n.inputs[0])),
        tuple(_unsqueeze_axes(e, n)) if (
            len(n.inputs) > 1 and n.inputs[1]) or "axes" in n.attrs
        else None),
    "Cast": lambda e, n: np.asarray(e.get(n.inputs[0])).astype(
        _NP_DTYPE_OF_ONNX[int(n.attrs["to"])]),
}


def unsupported_ops(graph: OnnxGraph) -> List[str]:
    """Sorted op configurations this executor cannot run (empty =
    runnable). Includes attribute-gated cases (e.g. pool ceil_mode) so a
    converter pre-screening an artifact sees every blocker up front, not an
    error on the first call."""
    supported = set(OPS) | {"Slice"}
    bad = {n.op_type for n in graph.nodes if n.op_type not in supported}
    for n in graph.nodes:
        if n.op_type in ("Conv", "MaxPool", "AveragePool"):
            if n.attrs.get("auto_pad", "NOTSET") not in ("NOTSET", ""):
                bad.add(f"{n.op_type}(auto_pad)")
            if int(n.attrs.get("ceil_mode", 0)):
                bad.add(f"{n.op_type}(ceil_mode=1)")
        elif n.op_type == "Pad":
            if len(n.inputs) > 3 and n.inputs[3]:
                bad.add("Pad(axes input)")
            if n.attrs.get("mode", "constant") not in (
                    "constant", "reflect", "edge"):
                bad.add(f"Pad(mode={n.attrs.get('mode')})")
        elif n.op_type in ("ArgMax", "ArgMin") and int(
                n.attrs.get("select_last_index", 0)):
            bad.add(f"{n.op_type}(select_last_index)")
    return sorted(bad)


def op_histogram(graph: OnnxGraph) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for n in graph.nodes:
        out[n.op_type] = out.get(n.op_type, 0) + 1
    return out


def run(
    graph: OnnxGraph,
    feeds: Dict[str, Any],
    params: Optional[Dict[str, Any]] = None,
    device=None,
) -> List[Any]:
    """Execute the graph on the given feeds; returns graph.outputs values.

    `params` overrides initializers (``OnnxRunner`` passes the large
    initializers as tensors on its device; None = the graph's numpy
    initializers, all static). Numpy feeds stay static, tensor feeds do
    not. Values turn into tensors on ``device`` (default: the first tensor
    feed's or param's, else the CPU)."""
    if device is None:
        device = next((v.device for v in [*feeds.values(), *(params or {}).values()]
                       if isinstance(v, torch.Tensor)), torch.device("cpu"))
    e = _Env(torch.device(device))
    e.values.update(graph.initializers)
    if params:
        e.values.update(params)
    e.values.update(feeds)

    for node in graph.nodes:
        if node.op_type == "Slice":
            vals: Any = _slice(e, node)
        elif node.op_type == "Split":
            x = e.t(node.inputs[0])
            axis = int(node.attrs.get("axis", 0))
            if len(node.inputs) > 1 and node.inputs[1]:
                sizes = _static_int_list(e.get(node.inputs[1]), "Split sizes")
            elif "split" in node.attrs:
                sizes = list(node.attrs["split"])
            else:
                k = len(node.outputs)
                sizes = [x.shape[axis] // k] * k
            for name, part in zip(node.outputs, torch.split(x, sizes, dim=axis)):
                e.values[name] = part
            continue
        elif node.op_type in _NP_FOLD and all(
            _is_static(e.values.get(i)) for i in node.inputs if i
        ):
            vals = _NP_FOLD[node.op_type](e, node)
        else:
            fn = OPS.get(node.op_type)
            if fn is None:
                raise NotImplementedError(
                    f"onnx_exec: op {node.op_type!r} (node {node.name!r}) — "
                    f"extend ops/onnx_exec.OPS"
                )
            vals = fn(e, node)
        e.values[node.outputs[0]] = vals
    return [e.get(o) for o in graph.outputs]


class OnnxRunner:
    """Graph execution on one device. Large initializers are moved there
    once as tensors; shape-carrying int initializers stay static. Feeds are
    moved to the device, and every output is a tensor there."""

    def __init__(self, graph: OnnxGraph, device="cpu"):
        bad = unsupported_ops(graph)
        if bad:
            raise NotImplementedError(
                f"onnx_exec: graph uses unsupported ops {bad}"
            )
        self.graph = graph
        self.device = torch.device(device)
        env = _Env(self.device)
        self.params = {
            k: env.as_t(v)
            for k, v in graph.initializers.items()
            if not (np.issubdtype(v.dtype, np.integer)
                    and v.size <= _STATIC_INT_MAX)
        }

    def __call__(self, feeds: Dict[str, Any]) -> List[torch.Tensor]:
        env = _Env(self.device)
        outs = run(self.graph, {k: env.as_t(v).to(self.device) for k, v in feeds.items()},
                   self.params, self.device)
        return [env.as_t(v) for v in outs]
