"""The port's Milvus Lite import (``retrieval/milvus_import.py``,
``cli/import_milvus.py``) against the JAX package's, on synthetic SQLite
files in the record layout the parser reads (``milvus_import.py``'s
docstring): a ``collection_meta`` table and one ``(id, milvus_id, data)``
table a collection, each blob holding the ``vector`` FieldData and then the
``{"file_id": ..., "text": ...}`` object. The files hold the rows the parser
skips (no blob, no vector tag, another field tag, a byte count that is not
dim x 4) and a ``}`` inside a string value. Both packages must return the
same vectors, metadata and chosen collection. The reference's real
``milvus_demo.db`` is not in the repository (``tests/test_milvus_import.py``
skips without it, in the JAX package too)."""

import json
import sqlite3

import numpy as np
import pytest

from autostyle_tts_tpu.cli import import_milvus as jcli
from autostyle_tts_tpu.retrieval import milvus_import as jmi
from autostyle_tts_tpu.retrieval.store import StyleStore as JStyleStore
from autostyle_tts_tpu_torch.cli import import_milvus as tcli
from autostyle_tts_tpu_torch.retrieval import milvus_import as tmi
from autostyle_tts_tpu_torch.retrieval.store import StyleStore


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _blob(vec=None, meta=None, tag=0x22, nbytes=None) -> bytes:
    """One insert record: filler, the vector FieldData, the metadata JSON."""
    out = b"\x0a\x05hdr\x12\x01" + b"\x00" * 3
    if vec is not None:
        fv = vec.astype("<f4").tobytes()
        floats = b"\x0a" + _varint(len(fv) if nbytes is None else nbytes) + fv
        msg = b"\x08" + _varint(vec.size) + b"\x12" + _varint(len(floats)) + floats
        out += b"vector" + bytes([tag]) + _varint(len(msg)) + msg
    if meta is not None:
        out += b"\x1a" + json.dumps(meta, ensure_ascii=False).encode() + b"\x00tail"
    return out


def write_db(path, collections):
    """collections: {name: [blob or None]}."""
    con = sqlite3.connect(path)
    con.execute("CREATE TABLE collection_meta (name TEXT, schema BLOB)")
    for name, blobs in collections.items():
        con.execute("INSERT INTO collection_meta VALUES (?, ?)", (name, b"schema"))
        con.execute(f'CREATE TABLE "{name}" (id INTEGER PRIMARY KEY, milvus_id INTEGER, data BLOB)')
        con.executemany(f'INSERT INTO "{name}" (milvus_id, data) VALUES (?, ?)',
                        [(1000 + i, b) for i, b in enumerate(blobs)])
    con.commit()
    con.close()


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    rng = np.random.default_rng(0)
    dim = 24

    def rows(n, prefix):
        return [_blob(rng.standard_normal(dim).astype(np.float32),
                      {"file_id": f"{prefix}_{i}.wav", "text": f"line {i}" + (" {a} } brace" if i == 1 else ""),
                       "speaker": "w1"}) for i in range(n)]

    big = rows(9, "big")
    big += [None, _blob(meta={"file_id": "novec", "text": "x"}),                       # no blob, no vector
            _blob(rng.standard_normal(dim).astype(np.float32), {"file_id": "bad", "text": "y"}, nbytes=dim * 4 - 4),
            _blob(rng.standard_normal(dim).astype(np.float32), {"file_id": "tag", "text": "z"}, tag=0x2A),
            _blob(rng.standard_normal(dim).astype(np.float32), None)]                   # vector, no metadata
    path = tmp_path_factory.mktemp("milvus") / "milvus_demo.db"
    write_db(path, {"small": rows(4, "small"), "big_coll": big, "empty": [None, _blob(meta={"file_id": "e"})]})
    return str(path)


def _store_rows(store):
    n = len(store.meta)
    db = store.db[:n]
    return np.asarray(db.cpu().numpy() if hasattr(db, "cpu") else db), store.meta


def test_read_collection_and_list_match_jax(db):
    assert tmi.list_collections(db) == jmi.list_collections(db) == ["small", "big_coll", "empty"]
    for name in ("small", "big_coll"):
        tv, tm = tmi.read_collection(db, name)
        jv, jm = jmi.read_collection(db, name)
        np.testing.assert_array_equal(tv, jv)
        assert tm == jm
    tv, tm = tmi.read_collection(db, "big_coll")
    assert tv.shape == (10, 24)                      # 9 rows + the one without metadata
    assert tm[1]["text"] == "line 1 {a} } brace" and tm[-1] == {}
    for mod in (tmi, jmi):
        with pytest.raises(ValueError, match="no vectors"):
            mod.read_collection(db, "empty")


@pytest.mark.parametrize("collection", [None, "small"])
def test_import_matches_jax(db, collection):
    t = tmi.import_milvus_db(db, collection, device="cpu")
    j = jmi.import_milvus_db(db, collection)
    assert isinstance(t, StyleStore) and isinstance(j, JStyleStore)
    tv, tm = _store_rows(t)
    jv, jm = _store_rows(j)
    np.testing.assert_allclose(tv, jv, atol=1e-6)
    assert tm == jm and len(tm) == (10 if collection is None else 4)
    assert t.capacity == j.capacity and t.self_verify()


def test_import_without_vectors_raises(tmp_path):
    path = str(tmp_path / "none.db")
    write_db(path, {"a": [None], "b": [_blob(meta={"file_id": "x"})]})
    with pytest.raises(ValueError, match="no non-empty collections"):
        tmi.import_milvus_db(path, device="cpu")
    with pytest.raises(ValueError, match="no non-empty collections"):
        jmi.import_milvus_db(path)


def test_cli_list_and_import(db, tmp_path, capsys):
    tcli.main(["--milvus_db", db, "--out", str(tmp_path / "unused"), "--list"])
    t_out = capsys.readouterr().out
    jcli.main(["--milvus_db", db, "--out", str(tmp_path / "unused"), "--list"])
    assert t_out == capsys.readouterr().out == "small\nbig_coll\nempty\n"
    tcli.main(["--milvus_db", db, "--out", str(tmp_path / "t" / "store"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "imported 10 vectors (dim 24)" in out and "self-verify ok" in out
    jcli.main(["--milvus_db", db, "--out", str(tmp_path / "j" / "store")])
    t = np.load(tmp_path / "t" / "store.npz")
    j = np.load(tmp_path / "j" / "store.npz")
    np.testing.assert_allclose(t["db"], j["db"], atol=1e-6)
    assert json.loads((tmp_path / "t" / "store.meta.json").read_text()) == \
        json.loads((tmp_path / "j" / "store.meta.json").read_text())
    # each snapshot loads in the other package
    assert len(StyleStore.load(tmp_path / "j" / "store", device="cpu")) == len(JStyleStore.load(tmp_path / "t" / "store"))


def test_varint_round_trip():
    for n in (0, 1, 127, 128, 300, 24576, 2**21 + 5):
        enc = _varint(n) + b"\xff"
        assert tmi._read_varint(enc, 0) == jmi._read_varint(enc, 0) == (n, len(enc) - 1)
