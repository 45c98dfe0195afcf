"""Device mesh (data x model axes) over ``torch.distributed``.

Counterpart of the JAX ``parallel/mesh.py``. There one program sees every
device of a 2-D mesh and XLA inserts the collectives; here each device rank
is a process (``torchrun`` or ``parallel.launch``) and a ``Mesh`` holds the
process groups its collectives run on: the world, this rank's data group
(the ranks that hold the same model shard, one per data row) and its model
group (the ranks that share one batch row range). Ranks are laid out with
the model axis varying fastest, ``rank = d * model + m``, as JAX's
``reshape(data, model)`` lays out its devices.

``make_mesh`` starts the default process group where none is running: from
``torchrun``'s environment (``env://``) when it is set, else as a world of
one process (an in-process store). The backend is ``nccl`` on a CUDA
device and ``gloo`` on the CPU unless the caller names one; ``gloo`` on
CUDA tensors is how several ranks share one card (NCCL refuses two ranks on
one device). Nothing falls back: a failed init raises. ``with mesh:``
makes the mesh the active one for the model code (``parallel.comm``), as
``with mesh:`` does in JAX.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
INIT_TIMEOUT_S = 300.0


def best_mesh_shape(n_devices: int, model_parallel: Optional[int] = None) -> Tuple[int, int]:
    """Pick (data, model). Models here are <=7B and fit one device, so
    default model=1 and scale throughput on data; an explicit model_parallel
    overrides."""
    if model_parallel is None:
        return (n_devices, 1)
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices not divisible by model={model_parallel}")
    return (n_devices // model_parallel, model_parallel)


@dataclass(eq=False)
class Mesh:
    """One rank's view of a (data, model) mesh. ``data_group`` /
    ``model_group`` are None where their axis has size 1 (the collectives
    of a size-1 axis are the identity and never reach ``torch.distributed``)."""

    data: int
    model: int
    rank: int
    device: torch.device
    backend: str
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None
    _entered: List[object] = field(default_factory=list, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def __enter__(self) -> "Mesh":
        from . import comm

        self._entered.append(comm.activate(self))
        return self

    def __exit__(self, *exc) -> None:
        from . import comm

        comm.restore(self._entered.pop())


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' for a mesh of CPU ranks")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())


def _init_world(backend: str) -> None:
    timeout = datetime.timedelta(seconds=INIT_TIMEOUT_S)
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, timeout=timeout)


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    *,
    device=None,
    backend: Optional[str] = None,
) -> Optional[Mesh]:
    """The (data, model) mesh over the first ``data * model`` ranks of the
    world (``data`` defaults to world // model). More ranks than the world
    raise, as the JAX ``make_mesh`` does with devices; a rank past the
    mesh's last gets None (it holds no device of the mesh). Every rank of
    the world must call it, with the same arguments: the groups are made
    collectively."""
    dev = torch.device(device) if device is not None else _default_device()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        _init_world(backend)
    world, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        data = world // model
    n = data * model
    if n > world:
        raise ValueError(f"need {n} devices, have {world}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = Mesh(data=data, model=model, rank=rank, device=dev, backend=backend) if rank < n else None
    # every rank takes part in every new_group call, in one order
    if data > 1:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)], backend=backend)
            if mesh is not None and mesh.model_rank == m:
                mesh.data_group = g
    if model > 1:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)], backend=backend)
            if mesh is not None and mesh.data_rank == d:
                mesh.model_group = g
    return mesh


def single_device_mesh(device=None, backend: Optional[str] = None) -> Mesh:
    return make_mesh(data=1, model=1, device=device, backend=backend)
