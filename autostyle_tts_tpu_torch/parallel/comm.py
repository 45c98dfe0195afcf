"""The collectives of the port's tensor and data parallelism.

The JAX package has no counterpart: there XLA inserts the collectives from
the shardings (GSPMD). PyTorch runs the hand-written kernels on plain
tensors, so the model code says where each collective goes, Megatron's
conjugate pair and two gathers, as ``torch.autograd.Function``\\ s:

- ``copy_to_model``: identity forward, all-reduce over the model group
  backward (at the input of column-parallel projections, and on a
  replicated weight that feeds a column-parallel product, a LoRA ``A``);
- ``reduce_from_model``: all-reduce forward, identity backward (after a
  row-parallel projection, ``wo`` / ``w_down``, and a vocab-sharded
  lookup);
- ``gather_from_model(dim)``: all-gather forward, this rank's slice
  backward (a column-sharded head's logits);
- ``gather_rows``: all-gather of rows over the data group, their widths
  first, so ranks may hold rows of different widths.

Only ``all_reduce`` and ``all_gather`` are called; gloo takes CUDA
tensors for both. bf16 / f16 tensors are reduced in f32. At a
model axis of 1 (no active mesh, or ``model == 1``) every function is the
identity and never reaches ``torch.distributed``.

The active mesh is the one of the innermost ``with mesh:`` block. Each
collective adds to counters of the innermost open span of the process
(``utils/timing.py``): ``collectives``, one a call, and
``collective_ms``, the host milliseconds inside it (a gloo call returns
when its data is back on the device, an NCCL call once it is enqueued).
"""

from __future__ import annotations

import time
from typing import List, Optional

import torch
import torch.distributed as dist

from ..utils import timing

_ACTIVE: Optional[object] = None


def activate(mesh) -> Optional[object]:
    """Make ``mesh`` the active one; returns the one it replaces."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    return prev


def restore(prev) -> None:
    global _ACTIVE
    _ACTIVE = prev


def active():
    return _ACTIVE


def model_size() -> int:
    return 1 if _ACTIVE is None else _ACTIVE.model


def model_rank() -> int:
    return 0 if _ACTIVE is None else _ACTIVE.model_rank


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    wide = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x.clone()
    t0 = time.perf_counter()
    dist.all_reduce(wide, group=group)
    timing.tally(collectives=1, collective_ms=(time.perf_counter() - t0) * 1e3)
    return wide.to(x.dtype)


def _all_gather(x: torch.Tensor, group, size: int) -> List[torch.Tensor]:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    t0 = time.perf_counter()
    dist.all_gather(parts, x, group=group)
    timing.tally(collectives=1, collective_ms=(time.perf_counter() - t0) * 1e3)
    return parts


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh.model_group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.rank, ctx.n = dim, mesh.model_rank, x.shape[dim]
        return torch.cat(_all_gather(x, mesh.model_group, mesh.model), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), None, None


def _tp_mesh():
    """The active mesh where its model axis is wider than 1, else None."""
    return _ACTIVE if _ACTIVE is not None and _ACTIVE.model > 1 else None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    mesh = _tp_mesh()
    return x if mesh is None else _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    mesh = _tp_mesh()
    return x if mesh is None else _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    mesh = _tp_mesh()
    return x if mesh is None else _GatherFromModel.apply(x, dim % x.ndim, mesh)


def reduce_data(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Sum over the data group (no autograd: gradients and loss terms)."""
    mesh = mesh or _ACTIVE
    if mesh is None or mesh.data == 1:
        return x
    return _all_reduce(x, mesh.data_group)


def reduce_model(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Sum over the model group (no autograd)."""
    mesh = mesh or _ACTIVE
    if mesh is None or mesh.model == 1:
        return x
    return _all_reduce(x, mesh.model_group)


def gather_rows(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """[n, W, ...] rows of this data rank -> the rows of every data rank in
    rank order, [sum n, max W, ...]: the row counts and widths are
    gathered first, each rank's rows padded to the widest with zeros and
    gathered, the padding kept (a caller that needs each row's own width
    carries it in the rows)."""
    mesh = mesh or _ACTIVE
    if mesh is None or mesh.data == 1:
        return x
    dims = torch.tensor([x.shape[0], x.shape[1]], dtype=torch.int64, device=x.device)
    sizes = _all_gather(dims, mesh.data_group, mesh.data)
    n_max = max(int(s[0]) for s in sizes)
    w_max = max(int(s[1]) for s in sizes)
    pad = x.new_zeros((n_max, w_max, *x.shape[2:]))
    pad[: x.shape[0], : x.shape[1]] = x
    parts = _all_gather(pad, mesh.data_group, mesh.data)
    return torch.cat([p[: int(s[0])] for p, s in zip(parts, sizes)], dim=0)

