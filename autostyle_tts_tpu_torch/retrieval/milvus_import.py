"""Milvus Lite .db -> StyleStore migration.

Counterpart of the JAX ``retrieval/milvus_import.py``: reads the
reference's vector database file directly (Milvus Lite stores each
collection as an SQLite table of protobuf-encoded insert records) and
imports the vectors and their ``{file_id, text}`` metadata into the port's
on-device ``StyleStore``, so an existing deployment switches without
re-embedding its style corpus.

Record layout (stable across Milvus Lite 2.x): each row's ``data`` blob
holds a FieldData protobuf for the ``vector`` column -- the ``"vector"``
tag, then ``0x22`` and a varint length (field 4, vectors), ``0x08`` and a
varint dim, ``0x12`` and a varint length (the float_vector message),
``0x0A`` and a varint byte count, then ``dim`` little-endian f32 -- and a
JSON object ``{"file_id": ..., "text": ...}`` for the dynamic metadata
columns. A row without a parseable vector (no tag, another field, a byte
count that is not dim x 4) is skipped.
"""

from __future__ import annotations

import json
import sqlite3
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.device import DeviceLike
from .store import StyleStore


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        out |= (b & 0x7F) << shift
        shift += 7
        pos += 1
        if not b & 0x80:
            return out, pos


def _extract_vector(blob: bytes) -> Optional[np.ndarray]:
    i = blob.find(b"vector")
    if i < 0:
        return None
    pos = i + len(b"vector")
    if blob[pos] != 0x22:                    # length-delimited field 4 (vectors)
        return None
    _, pos = _read_varint(blob, pos + 1)     # vectors message length
    if blob[pos] != 0x08:                    # field 1: dim (varint)
        return None
    dim, pos = _read_varint(blob, pos + 1)
    if blob[pos] != 0x12:                    # field 2: float_vector message
        return None
    _, pos = _read_varint(blob, pos + 1)
    if blob[pos] != 0x0A:                    # field 1: packed floats
        return None
    nbytes, pos = _read_varint(blob, pos + 1)
    if nbytes != dim * 4:
        return None
    return np.frombuffer(blob, dtype="<f4", count=dim, offset=pos).copy()


def _extract_meta(blob: bytes) -> Dict:
    """The dynamic-field JSON object, parsed with a real decoder
    (``raw_decode``) so that a '}' inside a string value does not cut it."""
    i = blob.find(b'{"file_id"')
    if i < 0:
        return {}
    text = blob[i:].decode("utf-8", errors="replace")
    try:
        obj, _ = json.JSONDecoder().raw_decode(text)
        return obj if isinstance(obj, dict) else {}
    except json.JSONDecodeError:
        return {}


def list_collections(db_path: str) -> List[str]:
    con = sqlite3.connect(f"file:{db_path}?mode=ro", uri=True)
    try:
        cur = con.cursor()
        names = [r[0] for r in cur.execute("SELECT name FROM sqlite_master WHERE type='table'")]
        return [n for n in names if n != "collection_meta"]
    finally:
        con.close()


def read_collection(db_path: str, collection: str) -> Tuple[np.ndarray, List[Dict]]:
    """-> (vectors [N, dim] f32, metadata dicts). Rows without a parseable
    vector are skipped; a collection with none raises ``ValueError``."""
    con = sqlite3.connect(f"file:{db_path}?mode=ro", uri=True)
    con.text_factory = bytes
    try:
        cur = con.cursor()
        vecs: List[np.ndarray] = []
        meta: List[Dict] = []
        for _id, _mid, blob in cur.execute(f'SELECT id, milvus_id, data FROM "{collection}"'):
            if blob is None:
                continue
            v = _extract_vector(bytes(blob))
            if v is None:
                continue
            vecs.append(v)
            meta.append(_extract_meta(bytes(blob)))
        if not vecs:
            raise ValueError(f"no vectors found in collection {collection!r}")
        return np.stack(vecs), meta
    finally:
        con.close()


def import_milvus_db(db_path: str, collection: Optional[str] = None, capacity: Optional[int] = None,
                     device: DeviceLike = None) -> StyleStore:
    """A ``StyleStore`` on ``device`` (default the card) holding one
    collection's vectors and metadata; ``collection=None`` takes the largest
    non-empty one."""
    if collection is None:
        nonempty = []
        for c in list_collections(db_path):
            try:
                v, _ = read_collection(db_path, c)
                nonempty.append((c, v.shape[0]))
            except ValueError:
                continue
        if not nonempty:
            raise ValueError(f"no non-empty collections in {db_path}")
        collection = max(nonempty, key=lambda x: x[1])[0]
    vectors, meta = read_collection(db_path, collection)
    store = StyleStore(dim=vectors.shape[1], capacity=capacity or max(64, 2 * vectors.shape[0]), device=device)
    store.insert(vectors, meta)
    return store
