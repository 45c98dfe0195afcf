"""StyleStore: the on-device style vector database.

Counterpart of the JAX ``retrieval/store.py``: a [capacity, dim] f32 matrix
of L2-normalized rows on the device, a ``valid`` row mask, host-side
metadata per row, and optional precomputed per-row prompt ``artifacts``
(speech tokens, prompt mel, speaker embedding) so that serving never loads
a wav. Snapshots use the same ``.npz`` + ``.meta.json`` format, so a store
saved by either package loads in the other.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.topk import cosine_topk, l2_normalize
from ..utils.device import DeviceLike, resolve_device
from ..utils.timing import Stopwatch

PathLike = Union[str, Path]


@dataclass
class SearchHit:
    index: int
    distance: float
    file_id: str
    text: str
    extras: Dict[str, Any]


class StyleStore:
    def __init__(self, dim: int, capacity: int = 4096, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.dim = int(dim)
        self.capacity = int(capacity)
        self.db = torch.zeros((self.capacity, self.dim), dtype=torch.float32, device=self.device)
        self.valid = torch.zeros((self.capacity,), dtype=torch.bool, device=self.device)
        self.meta: List[Dict[str, Any]] = []
        self.artifacts: Dict[str, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.meta)

    def _write_rows(self, rows: np.ndarray, start: int) -> None:
        t = torch.tensor(np.asarray(rows, np.float32), device=self.device)
        self.db[start : start + t.shape[0]] = l2_normalize(t)
        self.valid[start : start + t.shape[0]] = True

    def insert(self, vectors: np.ndarray, metadata: Sequence[Dict[str, Any]]) -> List[int]:
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        n = vectors.shape[0]
        if vectors.shape[1] != self.dim:
            raise ValueError(f"dim mismatch: {vectors.shape[1]} != {self.dim}")
        if len(metadata) != n:
            raise ValueError("metadata length mismatch")
        start = len(self.meta)
        if start + n > self.capacity:
            self._grow(max(self.capacity * 2, start + n))
        self._write_rows(vectors, start)
        self.meta.extend(dict(m) for m in metadata)
        return list(range(start, start + n))

    def drop(self) -> None:
        """Empty the store, its prompt artifacts with it."""
        self.db.zero_()
        self.valid.zero_()
        self.meta = []
        self.artifacts = {}

    def _grow(self, new_capacity: int) -> None:
        db = torch.zeros((new_capacity, self.dim), dtype=torch.float32, device=self.device)
        valid = torch.zeros((new_capacity,), dtype=torch.bool, device=self.device)
        db[: self.capacity] = self.db
        valid[: self.capacity] = self.valid
        self.capacity, self.db, self.valid = new_capacity, db, valid

    def _fetch_topk(self, queries: np.ndarray, k: int, mask: Optional[np.ndarray]):
        """A callable that fetches the top-k of [Q, dim] ``queries`` (already
        enqueued on the device) as numpy (scores [Q, k], row indices [Q, k])."""
        q = torch.tensor(np.atleast_2d(np.asarray(queries, np.float32)), device=self.device)
        m = None if mask is None else torch.tensor(np.asarray(mask), device=self.device)
        scores, idx = cosine_topk(q, self.db, self.valid, k, m)
        return lambda: (scores.cpu().numpy(), idx.cpu().numpy().astype(np.int32))

    def search_arrays(
        self, queries: np.ndarray, k: int, mask: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """[Q, dim] -> (scores [Q, k], row indices [Q, k]) as numpy."""
        return self._fetch_topk(queries, k, mask)()

    def search(
        self, queries: np.ndarray, k: int = 1, speaker: Optional[str] = None
    ) -> List[List[SearchHit]]:
        """Search with the metadata join and an optional speaker filter, as
        a trace of its own: span ``db_search`` with counters ``rows`` (rows
        scanned, the store's capacity), ``k`` and ``queries`` (``--profile``
        prints the last one); its wait is the top-k fetch."""
        clock = Stopwatch(self.device)
        with clock.open("db_search"):
            queries = np.atleast_2d(np.asarray(queries, np.float32))
            clock.count("rows", self.capacity)
            clock.count("k", k)
            clock.count("queries", queries.shape[0])
            mask = None
            if speaker is not None:
                mask = np.zeros((self.capacity,), bool)
                for i, m in enumerate(self.meta):
                    mask[i] = m.get("speaker") == speaker
            scores, idx = clock.read(self._fetch_topk(queries, k, mask))
            out: List[List[SearchHit]] = []
            for qi in range(scores.shape[0]):
                hits = []
                for ki in range(k):
                    row, sc = int(idx[qi, ki]), float(scores[qi, ki])
                    if row >= len(self.meta) or sc <= -1e29:
                        continue
                    m = self.meta[row]
                    hits.append(SearchHit(
                        index=row, distance=sc, file_id=str(m.get("file_id", "")),
                        text=str(m.get("text", m.get("zh_text", ""))),
                        extras={k2: v for k2, v in m.items() if k2 not in ("file_id", "text")},
                    ))
                out.append(hits)
            return out

    def save(self, path: PathLike) -> None:
        base = str(path).removesuffix(".npz")
        Path(base).parent.mkdir(parents=True, exist_ok=True)
        n = len(self.meta)
        arrays = {f"artifact_{k}": v for k, v in self.artifacts.items()}
        np.savez(base + ".npz", db=self.db[:n].cpu().numpy(), dim=np.int64(self.dim),
                 capacity=np.int64(self.capacity), **arrays)
        with open(base + ".meta.json", "w", encoding="utf-8") as f:
            json.dump(self.meta, f, ensure_ascii=False)

    @classmethod
    def load(cls, path: PathLike, device: DeviceLike = None) -> "StyleStore":
        base = str(path).removesuffix(".npz")
        with np.load(base + ".npz") as data:
            store = cls(int(data["dim"]), int(data["capacity"]), device=device)
            rows = data["db"]
            if rows.shape[0]:
                store._write_rows(rows, 0)
            store.artifacts = {
                k[len("artifact_"):]: data[k] for k in data.files if k.startswith("artifact_")
            }
        with open(base + ".meta.json", encoding="utf-8") as f:
            store.meta = json.load(f)
        return store

    def self_verify(self, sample: Optional[int] = None, tol: float = 1e-4, chunk: int = 1024) -> bool:
        """Searching each stored row must return it as the top hit (cosine
        1). ``sample=None`` checks every row, ``chunk`` at a time; an int
        checks the last ``sample`` rows (the batch just inserted). Ties are
        allowed: two rows may hold the same vector (the same speaker and
        emotion label give the same combined embedding)."""
        n = len(self.meta)
        lo = 0 if sample is None else max(0, n - min(sample, n))
        for s0 in range(lo, n, chunk):
            s1 = min(s0 + chunk, n)
            scores, idx = self.search_arrays(self.db[s0:s1].cpu().numpy(), k=1)
            if not ((idx[:, 0] == np.arange(s0, s1)) | (scores[:, 0] >= 1.0 - tol)).all():
                return False
        return True
