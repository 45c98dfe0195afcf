"""The port's retrieval CLIs against the JAX package's: insert_embeddings
-> search_json -> tts_with_rag --style_db on both packages from one saved
``--embedder_checkpoint`` (the JAX package's flat-key ``.npz``), with the
biography sampler set to greedy on both sides (the random streams differ).
Mirrors ``tests/test_cli.py::test_cli_insert_then_search_json_then_rag_tts``
and ``::test_cli_search_embeddings_and_search``.

The embedder runs at the tiny geometry in f32 (``--set
embedder.dtype=float32``: XLA and torch round bf16 activations after sums
taken in another order), so the DB vectors and the distances agree to 1e-5
and the rows are the same; the engines' weights differ (each package draws
its own), so of the synthesis only the number of wavs and their format are
compared. Every port CLI runs with ``--device cpu``; without it, it asks
for the card.
"""

import argparse
import json
import wave
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from autostyle_tts_tpu.cli import insert_embeddings as jinsert
from autostyle_tts_tpu.cli import search_json as jsearch_json
from autostyle_tts_tpu.cli import tts_with_rag as jtts
from autostyle_tts_tpu.models import transformer as jcore
from autostyle_tts_tpu.ops import sampling as jsampling
from autostyle_tts_tpu.utils.checkpoint import save_pytree
from autostyle_tts_tpu.utils.config import tiny_config
from autostyle_tts_tpu_torch.cli import insert_embeddings, search, search_embeddings, search_json, tts_with_rag
from autostyle_tts_tpu_torch.cli.common import add_common_args, build_engine
from autostyle_tts_tpu_torch.ops import sampling as tsampling
from autostyle_tts_tpu_torch.utils.audio_io import write_wav
from autostyle_tts_tpu_torch.utils.config import tiny_config as ttiny_config

SR = 1600  # the tiny config's prompt rate
CPU = ["--device", "cpu"]


def _make_wav(path, seconds=1.0, f=220.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    write_wav(path, (0.4 * np.sin(2 * np.pi * f * t) + 0.02 * rng.standard_normal(len(t))).astype(np.float32), SR)
    return str(path)


def _wav_rate(path):
    with wave.open(str(path), "rb") as w:
        assert w.getnframes() > 0
        return w.getframerate()


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    styles = d / "styles"
    styles.mkdir()
    manifest = []
    for i in range(4):
        fid = f"denoise_s{i}.wav"
        _make_wav(styles / fid, f=180 + 30 * i, seed=10 + i)
        manifest.append({"speaker": "w1" if i % 2 else "m1",
                         "zh_text": f"style sample {i} {'glad' if i % 3 else 'angry'}", "file_id": fid})
    (d / "styles.json").write_text(json.dumps(manifest))
    (d / "turns.jsonl").write_text('{"zh_text": "hello there", "speaker": "w1"}\n'
                                   '{"zh_text": "reply text", "speaker": "m1"}\n')
    ckpt = str(d / "embedder.npz")
    save_pytree(ckpt, jax.tree_util.tree_map(
        np.asarray, jcore.init_params(jax.random.PRNGKey(7), tiny_config().embedder)))
    return {"dir": d, "styles": styles, "ckpt": ckpt,
            "timbre": _make_wav(d / "timbre.wav", f=300, seed=2), "style": _make_wav(d / "style.wav", f=200, seed=1)}


def _trio(fx, out: Path, insert, search_json_mod, tts, extra):
    emb = ["--tiny", "--embedder_checkpoint", fx["ckpt"], "--set", "embedder.dtype=float32"] + extra
    db = out / "store"
    insert.main(emb + ["--input_json", str(fx["dir"] / "styles.json"), "--db_path", str(db),
                       "--capacity", "64", "--style_wav_dir", str(fx["styles"])])
    results = out / "search_results.jsonl"
    search_json_mod.main(emb + ["--input_json", str(fx["dir"] / "turns.jsonl"), "--db_path", str(db),
                                "--output_file", str(results), "--file_prefix_path", str(fx["styles"])])
    tts.main(["--tiny"] + extra + ["--corresponding_json", str(results), "--result_dir", str(out / "rag_out"),
                                   "--timbre_map", f"w1={fx['timbre']},m1={fx['style']}", "--style_db", str(db)])
    rows = [json.loads(l) for l in results.read_text().splitlines()]
    return rows, np.load(out / "store.npz"), json.loads((out / "store.meta.json").read_text()), \
        sorted((out / "rag_out").glob("*/*.wav"))


def test_cli_insert_then_search_json_then_rag_tts_match_jax(fixtures, tmp_path, monkeypatch):
    """The full workflow on both packages: the same DB (vectors, metadata,
    artifact shapes), the same JSONL rows, as many wavs."""
    for mod in (jsampling, tsampling):
        monkeypatch.setattr(mod.SamplerConfig, "biography", classmethod(lambda cls: cls(greedy=True)))
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = _trio(fixtures, tmp_path / "jax", jinsert, jsearch_json, jtts, [])
    got = _trio(fixtures, tmp_path / "torch", insert_embeddings, search_json, tts_with_rag, CPU)
    (rows, npz, meta, wavs), (jrows, jnpz, jmeta, jwavs) = got, want
    assert meta == jmeta and len(meta) == 4
    np.testing.assert_allclose(npz["db"], jnpz["db"], atol=1e-5)
    assert {k: npz[k].shape for k in npz.files if k.startswith("artifact_")} == \
           {k: jnpz[k].shape for k in jnpz.files if k.startswith("artifact_")}
    assert len(rows) == len(jrows) == 2
    for r, w in zip(rows, jrows):
        assert set(r) == set(w) >= {"zh_text", "speaker", "retrieved_file_id", "retrieved_text", "distance",
                                    "retrieved_index"}
        assert {k: v for k, v in r.items() if k != "distance"} == {k: v for k, v in w.items() if k != "distance"}
        assert abs(r["distance"] - w["distance"]) <= 1e-5
        assert Path(r["retrieved_file_id"]).exists()
    assert len(wavs) == len(jwavs) == 2
    assert [p.name for p in wavs] == [p.name for p in jwavs]
    assert _wav_rate(wavs[0]) == 2400  # the tiny config's output rate


def test_cli_search_embeddings_and_search(fixtures, tmp_path, capsys):
    """The two other query entry points on an inserted DB: a vector-only
    query finds its own row at distance 1, a text query prints a hit."""
    manifest = [{"speaker": "w1", "zh_text": f"t{i}", "file_id": f"f{i}"} for i in range(3)]
    mpath = tmp_path / "m.json"
    mpath.write_text(json.dumps(manifest))
    db = tmp_path / "db"
    insert_embeddings.main(["--tiny", "--input_json", str(mpath), "--db_path", str(db),
                            "--dump_embeddings", str(tmp_path / "dump.json")] + CPU)
    dump = json.loads((tmp_path / "dump.json").read_text())
    assert len(dump) == 3 and dump[0]["combined_embedding_shape"] == [2 * ttiny_config().embedder.dim]
    qpath = tmp_path / "q.json"
    qpath.write_text(json.dumps(dump[:1]))
    search_embeddings.main(["--query_json", str(qpath), "--db_path", str(db), "--top_k", "2"] + CPU)
    out = capsys.readouterr().out
    assert "distance=1.0000" in out and "file_id='f0'" in out
    search.main(["--tiny", "--db_path", str(db), "--query_text", "hello", "--top_k", "1"] + CPU)
    assert "file_id=" in capsys.readouterr().out


def test_cli_entry_points_ask_for_the_card(fixtures, tmp_path):
    """Without ``--device`` the CLIs run on the card and, where there is
    none, raise; a mesh and the Hugging Face loader raise naming their
    ROADMAP.md item."""
    p = argparse.ArgumentParser()
    add_common_args(p)
    insert_embeddings.add_embedder_args(p)
    args = p.parse_args(["--tiny"])
    cfg = ttiny_config()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            insert_embeddings.build_embedder(args, cfg)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_engine(args)
    for argv, item in ((["--tiny", "--dp", "2"], "item 11"), (["--tiny", "--tp", "2"], "item 11"),
                       (["--tiny", "--embedder_hf_dir", str(tmp_path)], "item 9")):
        with pytest.raises(NotImplementedError, match=item):
            insert_embeddings.build_embedder(p.parse_args(argv + CPU), cfg)


def test_parse_timbre_map(tmp_path):
    assert tts_with_rag.parse_timbre_map("w1=/a.wav, m1=/b.wav,") == {"w1": "/a.wav", "m1": "/b.wav"}
    spec = tmp_path / "t.json"
    spec.write_text(json.dumps({"w2": "/c.wav"}))
    assert tts_with_rag.parse_timbre_map(str(spec)) == {"w2": "/c.wav"}
