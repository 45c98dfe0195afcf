"""The port's ``cli/serve.py`` against the JAX package's, on the same
request files: the batched loop (wav, DB-row and registered-timbre prompts,
a bad path), ``--continuous`` (a prefix over ``--p_max`` rejected) and
``--continuous --stream``. Mirrors ``tests/test_serve.py``,
``tests/test_continuous.py::test_serve_continuous_cli`` and
``tests/test_stream_serve.py::test_serve_cli_continuous_stream``.

Both sides must answer with the same response ids, the same keys on each
line, the same error lines, the same wav file names (chunk files included)
and the same sample rates, and serve as many requests. The engines' weights
and random streams differ (each package draws its own), so the samples
are compared by rate, count (> 0, the chunks summing to the whole) and
finiteness only, as ``tests/test_torch_cli.py`` does. The port runs with
``--device cpu``; ``--dp`` above 1 outside ``torchrun`` raises and names the
``torchrun`` line.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from autostyle_tts_tpu.cli import serve as jserve
from autostyle_tts_tpu_torch.cli import serve
from autostyle_tts_tpu_torch.retrieval.store import StyleStore
from autostyle_tts_tpu_torch.utils.audio_io import read_wav, write_wav
from autostyle_tts_tpu_torch.utils.config import tiny_config
from torch_one_thread import one_thread  # noqa: F401  (autouse)

SR = 1600   # the tiny config's prompt rate
CPU = ["--device", "cpu"]


def _make_wav(path, f=220.0, seed=0, seconds=1.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    write_wav(path, (0.4 * np.sin(2 * np.pi * f * t) + 0.02 * rng.standard_normal(len(t))).astype(np.float32), SR)
    return str(path)


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    """Prompt wavs and a 2-row style DB with prompt artifacts (saved by the
    port's ``StyleStore``; both packages load the same file)."""
    d = tmp_path_factory.mktemp("serve")
    cfg = tiny_config()
    rng = np.random.default_rng(4)
    store = StyleStore(dim=cfg.retrieval.dim, capacity=8, device="cpu")
    store.insert(rng.standard_normal((2, cfg.retrieval.dim)).astype(np.float32),
                 [{"file_id": f"s{i}", "text": f"style line {i}"} for i in range(2)])
    store.artifacts = {
        "speech_tokens": rng.integers(0, cfg.speech_tokenizer.codebook_size, (2, 30)).astype(np.int32),
        "speech_token_lens": np.asarray([30, 21], np.int64),
        "prompt_mel": (rng.standard_normal((2, 60, cfg.cfm.n_mels)) * 0.5).astype(np.float32),
        "prompt_mel_lens": np.asarray([60, 42], np.int64),
        "spk": rng.standard_normal((2, cfg.speaker.emb_dim)).astype(np.float32),
    }
    store.save(d / "db")
    return {"dir": d, "style": _make_wav(d / "s.wav", f=200, seed=1), "timbre": _make_wav(d / "t.wav", f=300, seed=2),
            "db": str(d / "db")}


def _requests(path: Path, reqs) -> str:
    path.write_text("\n".join(json.dumps(r) for r in reqs) + "\n")
    return str(path)


def _serve(module, argv, capsys):
    capsys.readouterr()
    module.main(argv)
    return [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]


def _both(fx, tmp_path, capsys, name, reqs, flags):
    """Each package's response lines and result dir on one request file."""
    rq = _requests(tmp_path / f"{name}.jsonl", reqs)
    out = {}
    for side, module, extra in (("jax", jserve, []), ("torch", serve, CPU)):
        rd = tmp_path / f"{name}_{side}"
        lines = _serve(module, ["--tiny", "--requests", rq, "--result_dir", str(rd)] + flags + extra, capsys)
        out[side] = (lines, rd)
    return out["torch"], out["jax"]


def _shape(lines):
    """What must agree between the packages: each line's id and keys, in order."""
    return [(l.get("id"), l.get("chunk"), sorted(l)) for l in lines]


def _check_wavs(lines, rd):
    for l in lines:
        if "wav" in l:
            x, sr = read_wav(l["wav"])
            assert Path(l["wav"]).parent == rd and sr == 2400
            assert x.size == l["samples"] > 0 and np.isfinite(x).all()


def test_serve_batched_matches_jax(fx, tmp_path, capsys):
    reqs = [
        {"id": "a", "text": "first request", "style_text": "st", "style_wav": fx["style"], "timbre_wav": fx["timbre"]},
        {"id": "b", "text": "second request", "style_text": "st", "style_wav": fx["style"], "timbre_id": "w1"},
        {"id": "c", "text": "from the db", "style_text": "st", "style_index": 1, "timbre_wav": fx["timbre"]},
        {"id": "d", "text": "db and id", "style_index": 0, "timbre_id": "w1"},
        {"id": "bad", "text": "broken", "style_wav": "/nonexistent.wav", "timbre_wav": fx["timbre"]},
    ]
    flags = ["--batch", "4", "--timbre_map", f"w1={fx['timbre']}", "--max_seconds", "2", "--style_db", fx["db"]]
    (lines, rd), (jlines, jrd) = _both(fx, tmp_path, capsys, "batched", reqs, flags)
    assert _shape(lines) == _shape(jlines)
    by_id = {l.get("id"): l for l in lines}
    assert set(by_id["bad"]) == {"id", "error"}
    for rid in "abcd":
        assert set(by_id[rid]) == {"id", "wav", "samples", "audio_s", "latency_ms"}
        assert by_id[rid]["audio_s"] == round(by_id[rid]["samples"] / 2400, 3)
    assert sorted(p.name for p in rd.iterdir()) == sorted(p.name for p in jrd.iterdir()) \
        == ["a.wav", "b.wav", "c.wav", "d.wav"]
    _check_wavs(lines, rd)
    assert lines[-1] == jlines[-1] == {"served": 4, "done": True}


def _long_and_short(fx):
    return [
        {"id": "a", "text": "first continuous request", "style_text": "st", "style_wav": fx["style"],
         "timbre_wav": fx["timbre"]},
        {"id": "too_long", "text": "x" * 4000, "style_text": "st", "style_wav": fx["style"],
         "timbre_wav": fx["timbre"]},
        {"id": "b", "text": "second one", "style_text": "st", "style_wav": fx["style"], "timbre_wav": fx["timbre"]},
    ]


def test_serve_continuous_matches_jax(fx, tmp_path, capsys):
    flags = ["--continuous", "--slots", "2", "--chunk", "6", "--max_seconds", "2", "--p_max", "128"]
    (lines, rd), (jlines, jrd) = _both(fx, tmp_path, capsys, "continuous", _long_and_short(fx), flags)
    errs, jerrs = [l for l in lines if "error" in l], [l for l in jlines if "error" in l]
    assert [l["id"] for l in errs] == [l["id"] for l in jerrs] == ["too_long"]
    assert sorted(_shape(lines), key=repr) == sorted(_shape(jlines), key=repr)
    assert sorted(p.name for p in rd.iterdir()) == sorted(p.name for p in jrd.iterdir()) == ["a.wav", "b.wav"]
    _check_wavs(lines, rd)
    assert lines[-1] == jlines[-1] == {"served": 2, "done": True}


def test_serve_continuous_stream_matches_jax(fx, tmp_path, capsys):
    flags = ["--continuous", "--stream", "--slots", "2", "--max_seconds", "2", "--p_max", "128"]
    (lines, rd), (jlines, jrd) = _both(fx, tmp_path, capsys, "stream", _long_and_short(fx), flags)
    finals = {l["id"]: l for l in lines if "chunks" in l}
    jfinals = {l["id"]: l for l in jlines if "chunks" in l}
    assert set(finals) == set(jfinals) == {"a", "b"}
    assert {l.get("id") for l in lines if "error" in l} == {l.get("id") for l in jlines if "error" in l} \
        == {"too_long"}
    for rid in ("a", "b"):
        chunks = [l for l in lines if l.get("id") == rid and "chunk" in l]
        assert len(chunks) == finals[rid]["chunks"] >= 1
        assert "ttfb_ms" in chunks[0] and all("ttfb_ms" not in c for c in chunks[1:])
        assert sum(c["samples"] for c in chunks) == finals[rid]["samples"]
        assert sorted(chunks[0]) == sorted(next(l for l in jlines if l.get("id") == rid and "chunk" in l))
        assert set(finals[rid]) == set(jfinals[rid])
    # each request's chunk files and its stitched wav, named as the JAX server names them
    for side_lines, side_rd in ((lines, rd), (jlines, jrd)):
        want = {f"{r}.chunk{n:03d}.wav" for r in ("a", "b")
                for n in range(next(l["chunks"] for l in side_lines if l.get("id") == r and "chunks" in l))}
        assert {p.name for p in side_rd.iterdir()} == want | {"a.wav", "b.wav"}
    _check_wavs(lines, rd)
    assert lines[-1] == jlines[-1] == {"served": 2, "done": True}


def test_serve_dp_raises(fx, tmp_path):
    rq = _requests(tmp_path / "r.jsonl", [{"id": "a", "text": "x", "style_wav": fx["style"],
                                           "timbre_wav": fx["timbre"]}])
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        serve.main(["--tiny", "--requests", rq, "--result_dir", str(tmp_path / "o"), "--dp", "2"] + CPU)
