"""The port's CLIs against the JAX package's.

The retrieval CLIs: insert_embeddings -> search_json -> tts_with_rag
--style_db on both packages from one saved ``--embedder_checkpoint`` (the
JAX package's flat-key ``.npz``), with the biography sampler set to greedy
on both sides (the random streams differ). Mirrors
``tests/test_cli.py::test_cli_insert_then_search_json_then_rag_tts`` and
``::test_cli_search_embeddings_and_search``.

The engine CLIs (``tests/test_cli.py``'s basic, both modes of
tts_with_style_and_timbre, tts_from_lines, vc_from_dir, vc_from_dir_seed,
tts_for_dialog) run on both packages on the same fixtures and must write
the same files (names, counts, ``meta.lst`` rows) at the same rate.
``export_engine`` is held to a round trip: a JAX-exported snapshot loads
through the port's ``--checkpoint`` to the same weights (the dense token
LM's projections and speech head as the bf16 values the port serves them
with), the port's export loads back equal through either package.
``score_similarity`` on one ``meta.lst`` with one JAX-exported snapshot on
both sides gives the same rows and scores within 1e-4 (f32 log-mel and
speaker encoder on both; summation order differs).

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

from autostyle_tts_tpu.cli import basic as jbasic
from autostyle_tts_tpu.cli import export_engine as jexport_engine
from autostyle_tts_tpu.cli import insert_embeddings as jinsert
from autostyle_tts_tpu.cli import score_similarity as jscore_similarity
from autostyle_tts_tpu.cli import search_json as jsearch_json
from autostyle_tts_tpu.cli import tts_for_dialog as jtts_for_dialog
from autostyle_tts_tpu.cli import tts_from_lines as jtts_from_lines
from autostyle_tts_tpu.cli import tts_with_rag as jtts
from autostyle_tts_tpu.cli import tts_with_style_and_timbre as jstyle_timbre
from autostyle_tts_tpu.cli import vc_from_dir as jvc_from_dir
from autostyle_tts_tpu.cli import vc_from_dir_seed as jvc_from_dir_seed
from autostyle_tts_tpu.models import transformer as jcore
from autostyle_tts_tpu.ops import sampling as jsampling
from autostyle_tts_tpu.utils.checkpoint import load_pytree, save_pytree
from autostyle_tts_tpu.utils.config import tiny_config
from autostyle_tts_tpu_torch.cli import (basic, export_engine, insert_embeddings, score_similarity, search,
                                         search_embeddings, search_json, serve, tts_for_dialog, tts_from_lines,
                                         tts_with_rag, tts_with_style_and_timbre, vc_from_dir, vc_from_dir_seed)
from autostyle_tts_tpu_torch.cli import common as tcommon
from autostyle_tts_tpu_torch.cli.common import add_common_args, build_engine
from autostyle_tts_tpu_torch.ops import sampling as tsampling
from autostyle_tts_tpu_torch.pipeline.engine import EngineParams
from autostyle_tts_tpu_torch.retrieval.store import StyleStore
from autostyle_tts_tpu_torch.utils.audio_io import write_wav
from autostyle_tts_tpu_torch.utils.config import tiny_config as ttiny_config
from autostyle_tts_tpu_torch.weights import _flat_keys, load_npz, load_tree
from torch_one_thread import one_thread  # noqa: F401  (autouse)

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
    (d / "lines.txt").write_text("hello world\nsecond line\n")
    return {"dir": d, "styles": styles, "ckpt": ckpt, "txt": str(d / "lines.txt"),
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
    none, raise; a mesh raises naming its ROADMAP.md item, the Hugging
    Face loader an empty checkpoint directory, ``export_engine
    --stage_ckpt`` a directory without checkpoints."""
    p = argparse.ArgumentParser()
    add_common_args(p)
    insert_embeddings.add_embedder_args(p)
    args = p.parse_args(["--tiny"])
    cfg = ttiny_config()
    x = str(tmp_path / "unused")
    engine_clis = (
        (serve, ["--requests", x, "--result_dir", x]),
        (basic, ["--prompt_wav", x]),
        (tts_from_lines, ["--txt_path", x, "--prompt_wav", x, "--prompt_text", "p", "--result_dir", x]),
        (tts_with_style_and_timbre, ["--style_wav_path", x, "--timbre_wav_path", x, "--style_wav_text", "s",
                                     "--txt_path", x, "--result_dir", x]),
        (tts_for_dialog, ["--corresponding_json", x, "--dialogue_json", x, "--style_wav_json", x,
                          "--style_wav_dir", x, "--result_dir", x, "--timbre_map", "a=b"]),
        (vc_from_dir, ["--txt_path", x, "--style_dir", x, "--result_dir", x, "--style_json", x, "--timbre_dir", x]),
        (vc_from_dir_seed, ["--txt_path", x, "--style_dir", x, "--result_dir", x, "--style_json", x,
                            "--seed_meta_lst", x]),
        (export_engine, ["--output", x]),
        (score_similarity, ["--meta_lst", x, "--wav_dir", x, "--output_json", x]),
    )
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            insert_embeddings.build_embedder(args, cfg)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_engine(args)
        for mod, argv in engine_clis:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                mod.main(["--tiny"] + argv)
    for argv, item in ((["--tiny", "--dp", "2"], "one device"), (["--tiny", "--tp", "2"], "one device")):
        with pytest.raises(ValueError, match=item):
            insert_embeddings.build_embedder(p.parse_args(argv + CPU), cfg)
    # the Hugging Face loader is ported: a directory without a checkpoint is an error of its own
    with pytest.raises(FileNotFoundError, match="config.json"):
        insert_embeddings.build_embedder(p.parse_args(["--tiny", "--embedder_hf_dir", str(tmp_path)] + CPU), cfg)
    # --stage_ckpt is ported (the training slice): a directory without checkpoints is an error of its own
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        export_engine.main(["--tiny", "--output", x, "--stage_ckpt", f"cfm={x}"] + CPU)


# ----------------------------------------------------------------------- engine CLIs


def _names(d: Path, pattern: str = "*.wav"):
    return sorted(p.name for p in d.glob(pattern))


def _rates(d: Path, pattern: str = "*.wav"):
    return {_wav_rate(p) for p in d.glob(pattern)}


def _pair(tmp_path, jmain, tmain, argv_of):
    """Run the JAX CLI and the port's, each into its own result dir
    (``argv_of(result_dir)``): -> (the port's dir, the JAX one's)."""
    jd, td = tmp_path / "jax", tmp_path / "torch"
    jmain(["--tiny"] + argv_of(jd))
    tmain(["--tiny"] + argv_of(td) + CPU)
    return td, jd


def test_cli_basic_matches_jax(fixtures, tmp_path):
    td, jd = _pair(tmp_path, jbasic.main, basic.main, lambda d: [
        "--prompt_wav", fixtures["style"], "--tts_text", "hi", "--prompt_text", "p", "--result_dir", str(d)])
    assert _names(td) == _names(jd) == ["zero_shot_0.wav"]
    assert _rates(td) == _rates(jd) == {2400}


@pytest.mark.parametrize("mode,pattern", [("false", "*_st_0.wav"), ("true", "*_exp_0_0.wav")])
def test_cli_tts_with_style_and_timbre_matches_jax(fixtures, tmp_path, mode, pattern):
    td, jd = _pair(tmp_path, jstyle_timbre.main, tts_with_style_and_timbre.main, lambda d: [
        "--style_wav_path", fixtures["style"], "--timbre_wav_path", fixtures["timbre"],
        "--style_wav_text", "style text", "--txt_path", fixtures["txt"], "--result_dir", str(d), "--is_exp", mode])
    assert _names(td) == _names(jd) == _names(jd, pattern) and len(_names(td)) == 2
    assert _rates(td) == _rates(jd) == {2400}


def test_cli_tts_from_lines_matches_jax(fixtures, tmp_path):
    td, jd = _pair(tmp_path, jtts_from_lines.main, tts_from_lines.main, lambda d: [
        "--txt_path", fixtures["txt"], "--prompt_wav", fixtures["style"], "--prompt_text", "p",
        "--result_dir", str(d)])
    assert _names(td) == _names(jd) == ["line_1.wav", "line_2.wav"]
    assert _rates(td) == _rates(jd) == {2400}


def _matrix_fixtures(d: Path):
    style_dir, timbre_dir = d / "styles", d / "timbres"
    style_dir.mkdir()
    timbre_dir.mkdir()
    manifest = []
    for i in range(3):
        _make_wav(style_dir / f"sty{i}.wav", f=200 + i * 20, seed=20 + i)
        manifest.append({"file_id": f"denoise_sty{i}", "zh_text": f"style text {i}"})
        _make_wav(timbre_dir / f"tim{i}.wav", f=260 + i * 20, seed=30 + i)
    (d / "style.json").write_text(json.dumps(manifest))
    return style_dir, timbre_dir, str(d / "style.json")


def test_cli_vc_from_dir_matches_jax(fixtures, tmp_path):
    """The same sampled styles and timbres (``random.Random(seed)`` on both
    sides), the same wav names and ``meta.lst`` rows; the port's
    ``--cal_sim`` report scores every row."""
    style_dir, timbre_dir, sj = _matrix_fixtures(tmp_path)
    td, jd = _pair(tmp_path, jvc_from_dir.main, vc_from_dir.main, lambda d: [
        "--txt_path", fixtures["txt"], "--style_dir", str(style_dir), "--timbre_dir", str(timbre_dir),
        "--result_dir", str(d), "--style_num", "2", "--timbre_num", "1", "--style_json", sj, "--seed", "0"]
        + (["--cal_sim"] if d.name == "torch" else []))
    rows = (td / "meta.lst").read_text().splitlines()
    assert rows == (jd / "meta.lst").read_text().splitlines() and len(rows) == 2 * 1 * 2
    assert all(len(r.split("|")) == 4 and r.split("|")[0].endswith("_new") for r in rows)
    assert _names(td) == _names(jd) == sorted(r.split("|")[0] + ".wav" for r in rows)
    assert _rates(td) == _rates(jd) == {2400}
    report = json.loads((td / "similarity.json").read_text())
    assert [r["name"] for r in report["rows"]] == [r.split("|")[0] for r in rows]
    assert report["summary"]["n"] == 4 and all(-1.0 <= r["similarity"] <= 1.0 for r in report["rows"])


def test_cli_vc_from_dir_seed_matches_jax(fixtures, tmp_path):
    style_dir = tmp_path / "styles"
    style_dir.mkdir()
    _make_wav(style_dir / "sty0.wav", f=210, seed=40)
    sj = tmp_path / "style.json"
    sj.write_text(json.dumps([{"file_id": "denoise_sty0", "zh_text": "st"}]))
    tw = _make_wav(tmp_path / "seed-wavs-a.wav", f=240, seed=41)
    # the rewrite rules map '-wavs' -> '_temp' and '.wav' -> '_16k.wav': the rewritten file is the timbre
    _make_wav(Path(tw.replace("-wavs", "_temp").replace(".wav", "_16k.wav")), f=240, seed=41)
    lst = tmp_path / "seed_meta.lst"
    lst.write_text(f"name0|seed text|{tw}|target text\n")
    td, jd = _pair(tmp_path, jvc_from_dir_seed.main, vc_from_dir_seed.main, lambda d: [
        "--txt_path", fixtures["txt"], "--style_dir", str(style_dir), "--result_dir", str(d),
        "--style_num", "1", "--timbre_num", "1", "--style_json", str(sj), "--seed_meta_lst", str(lst), "--seed", "0"])
    assert (td / "meta.lst").read_text() == (jd / "meta.lst").read_text()
    assert _names(td) == _names(jd) and len(_names(td)) == 2
    assert _rates(td) == _rates(jd) == {2400}


def test_cli_tts_for_dialog_matches_jax(fixtures, tmp_path):
    (tmp_path / "dialog.jsonl").write_text('{"zh_text": "turn one"}\n{"zh_text": "turn two"}\n'
                                           '{"zh_text": "turn three"}\n')
    styles_dir = tmp_path / "swav"
    styles_dir.mkdir()
    _make_wav(styles_dir / "s1.wav", f=200, seed=50)
    _make_wav(styles_dir / "s2.wav", f=230, seed=51)
    (tmp_path / "styledb.jsonl").write_text('{"file_id": "s1", "zh_text": "style one"}\n'
                                            '{"file_id": "s2", "zh_text": "style two"}\n')
    (tmp_path / "correspond.json").write_text(json.dumps({
        "1": {"value": 1, "speaker": "jinjing", "emotion": "happy"}, "2": "null",
        "3": {"value": 2, "speaker": "lijiaqi", "emotion": "sad"},
        "4": {"value": 1, "speaker": "nobody", "emotion": "sad"}}))
    td, jd = _pair(tmp_path, jtts_for_dialog.main, tts_for_dialog.main, lambda d: [
        "--corresponding_json", str(tmp_path / "correspond.json"), "--dialogue_json", str(tmp_path / "dialog.jsonl"),
        "--style_wav_json", str(tmp_path / "styledb.jsonl"), "--style_wav_dir", str(styles_dir),
        "--result_dir", str(d), "--timbre_map", f"jinjing={fixtures['timbre']},lijiaqi={fixtures['style']}"])
    # the null turn and the unknown speaker are skipped; names in a timestamped dir
    assert _names(td, "*/*.wav") == _names(jd, "*/*.wav") == ["1_s1_to_jinjing_0.wav", "2_s2_to_lijiaqi_0.wav"]
    assert _rates(td, "*/*.wav") == _rates(jd, "*/*.wav") == {2400}


def _like_tree(cfg):
    return EngineParams.init(torch.Generator().manual_seed(0), cfg).tree()


def test_cli_export_engine_round_trip(tmp_path):
    """JAX export -> the port's ``--checkpoint``: the same weights (the
    dense token LM's projections and speech head as their bf16 values);
    the port's export -> its ``--checkpoint`` and the JAX ``load_pytree``:
    equal."""
    jax_npz, port_npz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jexport_engine.main(["--tiny", "--output", jax_npz, "--seed", "3"])
    export_engine.main(["--tiny", "--checkpoint", jax_npz, "--output", port_npz] + CPU)
    p = argparse.ArgumentParser()
    add_common_args(p)
    served = build_engine(p.parse_args(["--tiny", "--checkpoint", port_npz] + CPU))
    cfg = ttiny_config()
    src, out = load_tree(jax_npz, _like_tree(cfg)), load_tree(port_npz, _like_tree(cfg))
    flat_src, flat_out = _flat_keys(src), _flat_keys(out)
    assert set(flat_src) == set(flat_out) and len(flat_src) > 50
    bf16 = {f"token_lm/layers/{n}" for n in ("wqkv", "wo", "w_gate_up", "w_down")} | {"token_lm/speech_head"}
    for key, v in flat_src.items():
        want = v.to(torch.bfloat16).float() if key in bf16 else v
        assert torch.equal(flat_out[key], want), key
    for key, v in _flat_keys(served.params.tree()).items():
        assert torch.equal(v.float(), flat_out[key].to(v.device).float()), key
    jtree = load_pytree(port_npz, jax.tree_util.tree_map(np.asarray, load_npz(jax_npz)))
    for key, v in _flat_keys(jtree).items():
        np.testing.assert_array_equal(np.asarray(v), flat_out[key].numpy(), err_msg=key)
    assert json.loads(Path(port_npz + ".meta.json").read_text())["keys"] == sorted(flat_out)


def test_cli_score_similarity_matches_jax(fixtures, tmp_path):
    """One ``meta.lst`` over wavs on disk, one JAX-exported snapshot on both
    sides: the same rows, scores within 1e-4."""
    ckpt = str(tmp_path / "engine.npz")
    jexport_engine.main(["--tiny", "--output", ckpt, "--seed", "5"])
    wav_dir = tmp_path / "wavs"
    rows = []
    for i in range(3):
        _make_wav(wav_dir / f"row{i}_new.wav", f=180 + 40 * i, seed=60 + i, seconds=1.5)
        rows.append(f"row{i}_new|style {i}|{fixtures['timbre'] if i % 2 else fixtures['style']}|text {i}")
    (tmp_path / "meta.lst").write_text("\n".join(rows) + "\n")
    argv = ["--tiny", "--checkpoint", ckpt, "--meta_lst", str(tmp_path / "meta.lst"), "--wav_dir", str(wav_dir),
            "--batch", "2"]
    jscore_similarity.main(argv + ["--output_json", str(tmp_path / "jax.json")])
    score_similarity.main(argv + ["--output_json", str(tmp_path / "torch.json")] + CPU)
    got, want = (json.loads((tmp_path / f"{s}.json").read_text()) for s in ("torch", "jax"))
    assert [{k: v for k, v in r.items() if k != "similarity"} for r in got["rows"]] == \
           [{k: v for k, v in r.items() if k != "similarity"} for r in want["rows"]]
    np.testing.assert_allclose([r["similarity"] for r in got["rows"]], [r["similarity"] for r in want["rows"]],
                               atol=1e-4)
    assert got["summary"]["n"] == want["summary"]["n"] == 3


def test_parse_timbre_map(tmp_path):
    assert tts_with_rag.parse_timbre_map("w1=/a.wav, m1=/b.wav,") == {"w1": "/a.wav", "m1": "/b.wav"}
    spec = tmp_path / "t.json"
    spec.write_text(json.dumps({"w2": "/c.wav"}))
    assert tts_with_rag.parse_timbre_map(str(spec)) == {"w2": "/c.wav"}


def test_cli_profile_prints_the_last_request_span_tree(monkeypatch, capsys):
    """``--profile`` registers an exit hook that prints the last request's
    stage milliseconds and its span tree: each span's ms, self, host and
    wait ms, counters and the decode path; then the last DB search with
    its counters."""
    hooks = []
    monkeypatch.setattr(tcommon.atexit, "register", lambda fn, *a: hooks.append((fn, a)))
    p = argparse.ArgumentParser()
    add_common_args(p)
    eng = build_engine(p.parse_args(["--tiny", "--profile"] + CPU))
    t = np.arange(SR) / SR
    wav = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    store = StyleStore(dim=4, capacity=8, device="cpu")
    store.insert(np.eye(4, dtype=np.float32), [{"file_id": str(i)} for i in range(4)])
    store.search(np.eye(4, dtype=np.float32)[:3], k=2)
    next(eng.inference_zero_shot("hello there", "", wav, max_seconds=1))
    (fn, args), = hooks
    fn(*args)
    out = capsys.readouterr().out
    out, search = out.split("-- last DB search (ms) --\n")
    assert search.splitlines()[1].split()[0] == "db_search"
    assert "rows=8 k=2 queries=3" in search.splitlines()[1]
    timings, tree = out.split("-- last request's spans (ms) --\n")
    assert json.loads(timings.strip().splitlines()[-1]) == eng.last_timings
    rows = tree.strip().splitlines()
    assert rows[0].split() == ["span", "ms", "self", "host", "wait"]
    names = [r.split()[0] for r in rows[1:]]
    assert names == ["request", "featurize", "prefill", "decode", "cfm", "cfm.cond", "cfm.solve", "vocoder"]
    decode = rows[1 + names.index("decode")]
    assert f"steps={eng.last_decode_steps}" in decode and "path=scanned" in decode and "token_reads=" in decode
    assert all(len(r.split()) >= 5 for r in rows[1:])
