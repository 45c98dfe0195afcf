"""Checkpoints of parameter trees and training state.

Counterpart of the JAX ``utils/checkpoint.py``, in its file format:

- ``save_pytree`` / ``load_pytree``: one flat-key ``.npz`` (keys such as
  ``layers/wqkv``, list indices as path segments, an int8 tensor as its
  ``q`` / ``s`` pair) and a ``<path>.meta.json`` sidecar holding the
  metadata and the sorted keys. A tree of parameters either package writes
  loads into the other.
- ``CheckpointManager``: step-numbered ``checkpoint-<step>/`` directories
  under one root, the oldest removed beyond ``save_total_limit``,
  ``latest_step`` and ``restore``. ``backend="npz"`` writes
  ``state.npz``; ``backend="dcp"``, the counterpart of the JAX package's
  orbax backend for sharded and multi-process state, writes
  ``state.dcp/`` through ``torch.distributed.checkpoint`` from every rank
  (each model rank's slices once, whole leaves once) and a
  ``metadata.json`` as the JAX manager writes one, plus how each leaf was
  cut; ``restore`` reads on each rank only the pieces that hold its slice
  for the mesh of the tree it restores into (its own piece where the model
  axis is unchanged), so a tp = 2 save restores at tp = 1 or 4. The
  orbax format needs a JAX library: ``backend="orbax"`` and a directory
  holding ``state.orbax`` raise.

Optimizer state is a tree like any other (``train/optim.py`` documents its
layout), so it resumes within this package; the JAX package's optax state
has another layout and does not load here.
"""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path
from typing import Any, Optional, Tuple, Union

import torch

from ..weights import load_tree, save_tree

PathLike = Union[str, Path]


def save_pytree(path: PathLike, tree: Any, metadata: Optional[dict] = None) -> None:
    """Save a tree of tensors (dicts, lists, ``QTensor``) as a flat-key
    ``.npz`` plus its ``.meta.json`` sidecar (``weights.save_tree``)."""
    save_tree(str(path), tree, metadata)


def load_pytree(path: PathLike, like: Any) -> Any:
    """Load into the structure of ``like``: every key of ``like`` must be in
    the file with ``like``'s shape; keys the file has beyond them are left,
    as the JAX loader leaves them (``weights.load_tree``)."""
    return load_tree(str(path), like, extra_ok=True)


class CheckpointManager:
    """Step-numbered checkpoints with ``save_total_limit`` and discovery of
    the latest one (the reference trainer's ``save_steps`` /
    ``save_total_limit`` / ``resume_from_checkpoint``)."""

    def __init__(self, directory: PathLike, save_total_limit: int = 1, backend: str = "npz"):
        if backend == "orbax":
            raise ValueError("backend 'orbax' is a JAX-only format; backend='dcp' "
                             "(torch.distributed.checkpoint) holds sharded and multi-process state")
        if backend not in ("npz", "dcp"):
            raise ValueError(f"backend {backend!r}: 'npz' or 'dcp'")
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.limit = save_total_limit
        self.backend = backend

    def _ckpts(self):
        out = []
        for p in self.dir.glob("checkpoint-*"):
            m = re.fullmatch(r"checkpoint-(\d+)", p.name)
            if m:
                out.append((int(m.group(1)), p))
        return sorted(out)

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None, *, mesh=None, like: Any = None,
             heads: Optional[Tuple[int, int]] = None) -> Path:
        """Write ``tree``. ``dcp``: every rank of the world calls it with its
        slices; ``mesh`` (default the active one) and, where its model axis
        cuts the tree, ``like`` (the full shapes, ``sharding.abstract``) and
        the net's ``heads`` say how each leaf was cut."""
        d = self.dir / f"checkpoint-{step}"
        d.mkdir(parents=True, exist_ok=True)
        meta = {"step": step, **(metadata or {})}
        if self.backend == "dcp":
            _save_dcp(d, tree, meta, mesh, like, heads)
        elif _rank() == 0:      # every rank of a process group holds the same whole tree
            save_pytree(d / "state.npz", tree, metadata=meta)
        if _rank() == 0:
            for _, old in self._ckpts()[: -self.limit] if self.limit else []:
                shutil.rmtree(old, ignore_errors=True)
        return d

    def latest_step(self) -> Optional[int]:
        ck = self._ckpts()
        return ck[-1][0] if ck else None

    def restore(self, like: Any, step: Optional[int] = None, *, mesh=None,
                heads: Optional[Tuple[int, int]] = None) -> Any:
        """Load into the structure of ``like``. A ``dcp`` checkpoint is
        resharded for ``mesh`` (default the active one, or none): ``like``
        holds this rank's slices, cut for the net's ``heads``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"checkpoint-{step}"
        if (d / "state.orbax").exists():
            raise ValueError(f"{d} holds an orbax checkpoint, a JAX-only format; the port's sharded "
                             "checkpoints are backend='dcp'")
        if (d / "state.dcp").exists():
            return _restore_dcp(d, like, mesh, heads)
        return load_pytree(d / "state.npz", like)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _mesh_or_active(mesh):
    from ..parallel import comm

    return mesh if mesh is not None else comm.active()


def _save_dcp(d: Path, tree: Any, meta: dict, mesh, like, heads) -> None:
    """Each leaf under its flat key, a cut one as ``<key>#<model rank>``
    (the data ranks' copies of a key are written once), and
    ``metadata.json`` with each leaf's cut and full shape."""
    import torch.distributed.checkpoint as dcp

    from ..parallel import sharding
    from ..weights import _flat_keys

    mesh = _mesh_or_active(mesh)
    model = 1 if mesh is None else mesh.model
    if model > 1 and like is None:
        raise ValueError("a dcp save under a model axis needs like= (the tree's full shapes)")
    full = _flat_keys(tree if model == 1 else like)
    lay = {k: None for k in full} if model == 1 else sharding.layouts(mesh, like, heads)
    state = {}
    for key, t in _flat_keys(tree).items():
        state[key if lay[key] is None else f"{key}#{mesh.model_rank}"] = t.detach()
    dcp.save(state, storage_writer=dcp.FileSystemWriter(str(d / "state.dcp")))
    if _rank() == 0:
        meta = dict(meta, model=model, cuts={k: lay[k] for k in full},
                    shapes={k: list(v.shape) for k, v in full.items()})
        (d / "metadata.json").write_text(json.dumps(meta, indent=2))


def _restore_dcp(d: Path, like: Any, mesh, heads) -> Any:
    """Each leaf of this rank's slice, read from the pieces that hold it:
    a whole saved leaf whole; a cut one, for a target cut the same way,
    from ``sharding.sources`` (this rank's own piece at an unchanged model
    axis), for a whole target from every piece."""
    import torch.distributed.checkpoint as dcp

    from ..parallel import sharding
    from ..weights import _flat_keys

    meta = json.loads((d / "metadata.json").read_text())
    want = _flat_keys(like)
    missing = sorted(set(want) - set(meta["cuts"]))
    if missing:
        raise ValueError(f"{d}: missing keys {missing}")
    mesh = _mesh_or_active(mesh)
    model, rank = (1, 0) if mesh is None else (mesh.model, mesh.model_rank)
    full_like = sharding._map_keys(lambda k, t: torch.empty(meta["shapes"][k], dtype=t.dtype, device="meta"), like)
    lay = {k: None for k in want} if model == 1 else sharding.layouts(mesh, full_like, heads)
    reader = dcp.FileSystemReader(str(d / "state.dcp"))
    saved = reader.read_metadata().state_dict_metadata
    plan = {}
    for key in want:
        cut = meta["cuts"][key]
        if cut is None:
            plan[key] = (None, 1, 0, [key])
            continue
        cut = (cut[0], tuple(cut[1]))
        if lay[key] not in (None, cut):
            raise ValueError(f"{d}: {key} was cut as {cut}, this mesh cuts it as {lay[key]}")
        n_to, r = (model, rank) if lay[key] else (1, 0)
        plan[key] = (cut, n_to, r, [f"{key}#{s}" for s in sharding.sources(meta["model"], n_to, r)])
    state = {n: torch.empty(tuple(saved[n].size), dtype=saved[n].properties.dtype)
             for _, _, _, names in plan.values() for n in names}
    dcp.load(state, storage_reader=reader)

    def one(key, leaf):
        cut, n_to, r, names = plan[key]
        if cut is None:
            t = sharding.cut(state[names[0]], lay[key], model, rank)
        else:
            t = sharding.recut({int(n.rsplit("#", 1)[1]): state[n] for n in names}, cut, meta["model"], n_to, r)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{d}: {key} restores as {tuple(t.shape)} here, expected {tuple(leaf.shape)}")
        return t.to(dtype=leaf.dtype, device=leaf.device)

    return sharding._map_keys(one, like)
