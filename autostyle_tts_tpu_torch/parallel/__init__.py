"""Device mesh, sharding rules and collectives (``torch.distributed``):
the counterpart of the JAX ``parallel`` package, one process per rank."""

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, best_mesh_shape, make_mesh, single_device_mesh  # noqa: F401
from .sharding import (  # noqa: F401
    batch_sharding,
    gather_params,
    param_shardings,
    replicated,
    shard_params,
)
