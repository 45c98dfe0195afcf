"""Tensor-parallel rules for the port's parameter trees, and the slicing
they imply.

Counterpart of the JAX ``parallel/sharding.py``. The rule table is the
same, matched on a leaf's path (an int8 ``QTensor``'s ``q`` / ``s`` and an
int4 ``Q4Tensor``'s ``packed`` / ``s`` take their weight's name):

- attention wq/wk/wv/wqkv and MLP w_gate/w_up/w_gate_up: column-parallel,
  spec (None, ..., MODEL);
- attention wo and MLP w_down: row-parallel, (..., MODEL, None);
- tok_emb / text_emb / speech_emb vocab-sharded (..., MODEL, None),
  lm_head / speech_head (..., MODEL);
- a LoRA ``A`` follows its base's input dim, ``B`` its output dim: for a
  column-parallel base ``A`` is replicated and ``B`` sharded, for a
  row-parallel base ``A`` sharded and ``B`` replicated;
- norms, biases, scalars, every other leaf: replicated, spec ();
- a dimension that does not divide the model axis falls back to
  replication, leaf by leaf (a size-1 scale dimension stays replicated).

``param_shardings`` returns these specs as the JAX function does (by flat
key here, the keys of the checkpoint format). XLA may then split a leaf
anywhere and reshard behind it; a rank that computes on its own slice
cannot, so ``shard_params`` deviates where the local computation needs it:

- a fused ``wqkv`` [D, (H + 2K) hd] is sliced per block (this rank's q
  heads, k heads and v heads), ``w_gate_up`` [D, 2F] per half, and their
  LoRA ``B`` the same way; ``q`` and ``s`` of a quantized leaf together;
- where H or K (``heads``) does not divide the model axis, or no ``heads``
  are given, a net's attention leaves stay whole (the JAX fallback applied
  per head block), and its MLP where F does not;
- a packed int4 row-parallel leaf (``wo`` / ``w_down`` as ``Q4Tensor``)
  stays whole: a byte holds contraction rows r and r + D/2, so a slice of
  its rows would need two ranges of the input; the model code gathers the
  input for it instead.

``gather_params`` inverts ``shard_params`` exactly, given a tree with the
full shapes (``like``: the unsharded tree or its ``abstract`` copy on the
meta device), since a local slice alone does not say whether it was cut.
``batch_sharding`` is the row range of this data rank.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..weights import Q4Tensor, is_quantized, tree_map
from . import comm
from .mesh import DATA_AXIS, MODEL_AXIS

Spec = Tuple[Optional[str], ...]
# a cut leaf: (axis, block proportions); each block is cut in model-axis pieces
Layout = Tuple[int, Tuple[int, ...]]

_COL = re.compile(r"(wqkv|wq|wk|wv|w_gate_up|w_gate|w_up)$")
_ROW = re.compile(r"(wo|w_down)$")


def _axis_spec(ndim: int, shard_axis: int) -> Spec:
    """The spec sharding ``shard_axis`` (negative = from the end) on MODEL;
    a layer-stacked leaf's leading dim stays replicated."""
    spec: List[Optional[str]] = [None] * ndim
    spec[shard_axis % ndim] = MODEL_AXIS
    return tuple(spec)


def _split_lora(leaf: str) -> Tuple[str, Optional[str]]:
    if leaf.endswith("_lora_a") or leaf.endswith("_lora_b"):
        return leaf[:-7], leaf[-1]
    return leaf, None


def spec_for_path(path: str, ndim: int) -> Spec:
    base, lora = _split_lora(path.rsplit("/", 1)[-1])
    if ndim < 2:
        return ()
    if _COL.search(base):
        if lora == "a":  # [..., D, r]: r too small to shard
            return ()
        return _axis_spec(ndim, -1)  # base [..., D, F] / lora_b [..., r, F]
    if _ROW.search(base):
        if lora == "b":  # [..., r, D]
            return ()
        return _axis_spec(ndim, -2)  # base [..., F, D] / lora_a [..., F, r]
    if base in ("tok_emb", "text_emb", "speech_emb"):
        return _axis_spec(ndim, -2)  # vocab-sharded
    if base in ("lm_head", "speech_head"):
        return _axis_spec(ndim, -1)
    return ()


def _leaves(tree: Any, prefix: str = "", logical: str = "") -> List[Tuple[str, str, Any, Any]]:
    """(flat key, the weight's path, leaf, its quantized parent or None):
    a quantized tensor's fields are keyed ``<path>/<field>``, as the
    checkpoint format keys them, and ruled by ``<path>``."""
    if is_quantized(tree):
        return [(f"{prefix}/{f}", prefix, t, tree) for f, t in tree._asdict().items()]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, prefix, tree, None)]
    out = []
    for k, v in items:
        key = f"{prefix}/{k}" if prefix else str(k)
        out += _leaves(v, key)
    return out


def _model(mesh) -> int:
    return int(mesh.shape.get(MODEL_AXIS, 1))


def _spec(path: str, leaf, model: int) -> Spec:
    spec = spec_for_path(path, getattr(leaf, "ndim", 0))
    for dim, axis in enumerate(spec):
        if axis == MODEL_AXIS and leaf.shape[dim] % model:
            return ()
    return spec


def param_shardings(mesh, tree: Any) -> Dict[str, Spec]:
    """Flat key -> spec of every leaf of ``tree`` under the rules, with
    the JAX fallback to replication where a dimension does not divide the
    model axis. ``mesh`` is a ``Mesh`` or anything with its ``shape``."""
    model = _model(mesh)
    return {key: _spec(path, leaf, model) for key, path, leaf, _ in _leaves(tree)}


def _layout(path: str, leaf, parent, model: int, heads: Optional[Tuple[int, int]]) -> Optional[Layout]:
    """How ``shard_params`` cuts a leaf (None: it stays whole)."""
    spec = _spec(path, leaf, model)
    if model == 1 or MODEL_AXIS not in spec:
        return None
    axis = spec.index(MODEL_AXIS)
    base, _ = _split_lora(path.rsplit("/", 1)[-1])
    attn = base in ("wqkv", "wq", "wk", "wv", "wo")
    if attn and (heads is None or heads[0] % model or heads[1] % model):
        return None
    if isinstance(parent, Q4Tensor) and _ROW.search(base):
        return None
    if base == "wqkv":
        return axis, (heads[0], heads[1], heads[1])
    if base == "w_gate_up":
        return (axis, (1, 1)) if (leaf.shape[axis] // 2) % model == 0 else None
    return axis, (1,)


def layouts(mesh, tree: Any, heads: Optional[Tuple[int, int]] = None) -> Dict[str, Optional[Layout]]:
    """Flat key -> how ``shard_params`` cuts each leaf of the full ``tree``
    (None: whole). ``heads``: the net's (query heads, key/value heads)."""
    model = _model(mesh)
    return {key: _layout(path, leaf, parent, model, heads) for key, path, leaf, parent in _leaves(tree)}


def cut(t: torch.Tensor, layout: Optional[Layout], model: int, rank: int) -> torch.Tensor:
    """Piece ``rank`` of ``model`` of a full leaf under ``layout``."""
    if layout is None:
        return t
    axis, props = layout
    unit = t.shape[axis] // sum(props)
    parts, off = [], 0
    for p in props:
        piece = unit * p // model
        parts.append(t.narrow(axis, off + rank * piece, piece))
        off += unit * p
    return torch.cat(parts, dim=axis).contiguous()


def join(pieces: Sequence[torch.Tensor], layout: Optional[Layout]) -> torch.Tensor:
    """The full leaf from every model rank's piece (the inverse of ``cut``)."""
    if layout is None:
        return pieces[0]
    axis, props = layout
    unit = pieces[0].shape[axis] // sum(props)
    blocks, off = [], 0
    for p in props:
        blocks += [x.narrow(axis, off, unit * p) for x in pieces]
        off += unit * p
    return torch.cat(blocks, dim=axis)


def sources(n_from: int, n_to: int, rank: int) -> range:
    """The pieces of an ``n_from``-way cut that hold piece ``rank`` of an
    ``n_to``-way cut of the same layout."""
    return range(rank * n_from // n_to, -(-(rank + 1) * n_from // n_to))


def recut(pieces: Dict[int, torch.Tensor], layout: Layout, n_from: int, n_to: int, rank: int) -> torch.Tensor:
    """Piece ``rank`` of an ``n_to``-way cut from the pieces ``sources(n_from,
    n_to, rank)`` of an ``n_from``-way cut (``pieces`` by their rank): each
    block's part joined from them, then narrowed to this rank's share."""
    axis, props = layout
    have = sources(n_from, n_to, rank)
    first = pieces[have[0]]
    unit = first.shape[axis] * n_from // sum(props)      # the full leaf's size of one proportion
    parts, off = [], 0
    for p in props:
        full, step = unit * p, unit * p // n_from
        span = torch.cat([pieces[s].narrow(axis, off, step) for s in have], dim=axis)
        parts.append(span.narrow(axis, rank * full // n_to - have[0] * step, full // n_to))
        off += step
    return torch.cat(parts, dim=axis).contiguous()


def _map_keys(fn, tree: Any, prefix: str = "") -> Any:
    """``fn(flat key, leaf)`` over every leaf, the structure kept."""
    if is_quantized(tree):
        return type(tree)(*(fn(f"{prefix}/{f}", t) for f, t in tree._asdict().items()))
    if isinstance(tree, dict):
        return {k: _map_keys(fn, v, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_keys(fn, v, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def shard_params(mesh, tree: Any, heads: Optional[Tuple[int, int]] = None) -> Any:
    """This rank's slices of a full tree (copies; whole leaves are the
    caller's tensors), on the mesh's device."""
    lay = layouts(mesh, tree, heads)
    model, rank = _model(mesh), mesh.model_rank
    return _map_keys(lambda k, t: cut(t, lay[k], model, rank).to(mesh.device), tree)


def gather_params(mesh, tree: Any, like: Any, heads: Optional[Tuple[int, int]] = None) -> Any:
    """The full tree from every model rank's slices (``tree``, this rank's);
    ``like`` has the full shapes. Whole leaves are returned as they are."""
    lay = layouts(mesh, like, heads)

    def one(key, t):
        if lay[key] is None:
            return t
        return join(comm._all_gather(t, mesh.model_group, mesh.model), lay[key])

    return _map_keys(one, tree)


def abstract(tree: Any) -> Any:
    """The tree's shapes and dtypes on the meta device (no storage)."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def batch_sharding(mesh, n_rows: int) -> slice:
    """The rows of a batch of ``n_rows`` this data rank computes: its
    contiguous share where the batch divides the data axis (and holds at
    least one row a rank), else every row (the batch stays replicated)."""
    dp = 1 if mesh is None else int(mesh.shape.get(DATA_AXIS, 1))
    if dp == 1 or n_rows < dp or n_rows % dp:
        return slice(0, n_rows)
    n = n_rows // dp
    return slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)


def replicated(mesh) -> Spec:
    return ()
