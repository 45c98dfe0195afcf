"""Checkpoints of parameter trees and training state.

Counterpart of the JAX ``utils/checkpoint.py``, in its file format:

- ``save_pytree`` / ``load_pytree``: one flat-key ``.npz`` (keys such as
  ``layers/wqkv``, list indices as path segments, an int8 tensor as its
  ``q`` / ``s`` pair) and a ``<path>.meta.json`` sidecar holding the
  metadata and the sorted keys. A tree of parameters either package writes
  loads into the other.
- ``CheckpointManager``: step-numbered ``checkpoint-<step>/state.npz``
  directories under one root, the oldest removed beyond
  ``save_total_limit``, ``latest_step`` and ``restore``. Only the npz
  backend exists here: orbax is a JAX format.

Optimizer state is a tree like any other (``train/optim.py`` documents its
layout), so it resumes within this package; the JAX package's optax state
has another layout and does not load here.
"""

from __future__ import annotations

import re
import shutil
from pathlib import Path
from typing import Any, Optional, Union

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
        if backend != "npz":
            raise ValueError(f"backend {backend!r}: only 'npz' here; orbax checkpoints are a JAX-only format")
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.limit = save_total_limit

    def _ckpts(self):
        out = []
        for p in self.dir.glob("checkpoint-*"):
            m = re.fullmatch(r"checkpoint-(\d+)", p.name)
            if m:
                out.append((int(m.group(1)), p))
        return sorted(out)

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None) -> Path:
        d = self.dir / f"checkpoint-{step}"
        d.mkdir(parents=True, exist_ok=True)
        save_pytree(d / "state.npz", tree, metadata={"step": step, **(metadata or {})})
        for _, old in self._ckpts()[: -self.limit] if self.limit else []:
            shutil.rmtree(old, ignore_errors=True)
        return d

    def latest_step(self) -> Optional[int]:
        ck = self._ckpts()
        return ck[-1][0] if ck else None

    def restore(self, like: Any, step: Optional[int] = None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"checkpoint-{step}"
        if (d / "state.orbax").exists():
            raise ValueError(f"{d} holds an orbax checkpoint, a JAX-only format")
        return load_pytree(d / "state.npz", like)
