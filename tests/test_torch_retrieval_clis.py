"""The port's last two retrieval CLIs against the JAX package's.

- ``simeval.retrieval_report`` on the seeded store of
  ``tests/test_simeval.py::test_retrieval_report_healthy_store`` (30 x 16)
  equals JAX's (recall exactly, the cosine statistics to 1e-6);
  ``cli.retrieval_report`` prints and writes the same report and exits
  non-zero below ``--fail_below_recall``.
- ``cli.llm_bio_extract``: the output file ``{conv_id: [bio per
  utterance]}``, the items each conversation is prompted with (speaker
  names in English and Chinese), resume with the ``_backup.json`` copy, all
  equal between the packages through a recording embedder; the batch
  ladder steps down only on ``torch.cuda.OutOfMemoryError`` (any other
  error raises, and so does a conversation for which every size ran out of
  memory); greedy biographies at a tiny f32 embedder equal JAX's.
"""

import json

import jax
import numpy as np
import pytest
import torch

from autostyle_tts_tpu.cli import llm_bio_extract as jbio
from autostyle_tts_tpu.cli import retrieval_report as jreport_cli
from autostyle_tts_tpu.models import transformer as jcore
from autostyle_tts_tpu.ops import sampling as jsampling
from autostyle_tts_tpu.pipeline import simeval as jsimeval
from autostyle_tts_tpu.retrieval import StyleStore as JStyleStore
from autostyle_tts_tpu.utils.checkpoint import save_pytree
from autostyle_tts_tpu.utils.config import tiny_config
from autostyle_tts_tpu_torch.cli import llm_bio_extract as tbio
from autostyle_tts_tpu_torch.cli import retrieval_report as treport_cli
from autostyle_tts_tpu_torch.ops import sampling as tsampling
from autostyle_tts_tpu_torch.pipeline import simeval as tsimeval
from autostyle_tts_tpu_torch.retrieval.store import StyleStore
from torch_one_thread import one_thread  # noqa: F401  (autouse)


def _stores():
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((30, 16)).astype(np.float32)
    meta = [{"file_id": str(i), "text": ""} for i in range(30)]
    t, j = StyleStore(dim=16, capacity=64, device="cpu"), JStyleStore(dim=16, capacity=64)
    t.insert(vecs, meta)
    j.insert(vecs, meta)
    return t, j


def _assert_reports_equal(got, want):
    assert {k: v for k, v in got.items() if k != "cross_top1"} == \
           {k: v for k, v in want.items() if k != "cross_top1"}
    assert set(got["cross_top1"]) == set(want["cross_top1"])
    for k, v in want["cross_top1"].items():
        assert abs(got["cross_top1"][k] - v) <= 1e-6, k


@pytest.mark.parametrize("k", [1, 5, 40])
def test_retrieval_report_matches_jax(k):
    t, j = _stores()
    got = tsimeval.retrieval_report(t, k=k)
    _assert_reports_equal(got, jsimeval.retrieval_report(j, k=k))
    assert got["n"] == 30 and got["recall_at_k"] == 1.0
    c = got["cross_top1"]
    assert -1.0 <= c["min"] <= c["p50"] <= c["max"] <= 1.0
    empty = tsimeval.retrieval_report(StyleStore(dim=4, device="cpu"))
    assert empty == jsimeval.retrieval_report(JStyleStore(dim=4)) == {"n": 0, "recall_at_k": 1.0,
                                                                     "cross_top1": {}, "k": 5}


def test_retrieval_report_cli_and_exit_code(tmp_path, capsys):
    t, _ = _stores()
    t.save(tmp_path / "db")
    treport_cli.main(["--db_path", str(tmp_path / "db"), "--k", "5", "--output_json", str(tmp_path / "t.json"),
                      "--fail_below_recall", "1.0", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    jreport_cli.main(["--db_path", str(tmp_path / "db"), "--k", "5", "--output_json", str(tmp_path / "j.json"),
                      "--band", "0.83", "0.88"])
    want = json.loads((tmp_path / "j.json").read_text())
    _assert_reports_equal(json.loads((tmp_path / "t.json").read_text()), want)
    _assert_reports_equal(printed, want)
    with pytest.raises(SystemExit, match=r"recall@5=1.0000 < 1.01"):
        treport_cli.main(["--db_path", str(tmp_path / "db"), "--fail_below_recall", "1.01", "--device", "cpu"])


# ------------------------------------------------------------------- llm_bio_extract

DATA = {
    "Ses01_a": {"sentences": ["hi there", "hello, how are you?", "fine."], "genders": ["F", "M", "F"],
                "labels": [0, 2, 1]},
    "Ses02_b": {"sentences": ["that was awful", "I know"], "genders": ["M", "F"], "labels": [3, 1]},
    "Ses03_c": {"sentences": ["ok"], "genders": ["F"], "labels": [2], "speakers": ["Ann"]},
}


class Recorder:
    """An embedder whose biography of (conversation, speaker) is a string
    of both; ``fail(batch_size)`` -> an exception to raise for that size."""

    def __init__(self, fail=lambda bs: None):
        self.calls, self.fail = [], fail

    def biographies(self, items):
        self.calls.append(list(items))
        err = self.fail(len(items))
        if err is not None:
            raise err
        return [f"{s} in <{c}>" for c, s in items]


def _run(mod, monkeypatch, rec, data_path, out, extra=()):
    monkeypatch.setattr(mod, "build_embedder", lambda args, cfg: rec)
    mod.main(["--tiny", "--data_json", str(data_path), "--output_json", str(out), *extra])


@pytest.mark.parametrize("language", ["en", "zh"])
def test_bio_extract_file_contract_and_resume_match_jax(tmp_path, monkeypatch, language):
    first = {k: DATA[k] for k in ("Ses01_a", "Ses02_b")}
    (tmp_path / "first.json").write_text(json.dumps(first))
    (tmp_path / "all.json").write_text(json.dumps(DATA))
    outs = {}
    for name, mod in (("t", tbio), ("j", jbio)):
        out = tmp_path / name / "bios.json"
        rec = Recorder()
        _run(mod, monkeypatch, rec, tmp_path / "first.json", out, ("--language", language))
        after_first = json.loads(out.read_text())
        assert not (tmp_path / name / "bios.json_backup.json").exists()
        _run(mod, monkeypatch, rec, tmp_path / "all.json", out, ("--language", language))
        assert json.loads((tmp_path / name / "bios.json_backup.json").read_text()) == after_first
        outs[name] = (rec.calls, json.loads(out.read_text()))
    assert outs["t"] == outs["j"]
    calls, res = outs["t"]
    assert list(res) == list(DATA) and [len(v) for v in res.values()] == [3, 2, 1]
    assert len(calls) == 3                      # the resumed run prompts only the new conversation
    assert calls[2] == [("Ann: ok", "Ann")]


def test_bio_extract_ladder_steps_down_only_on_out_of_memory(tmp_path, monkeypatch, capsys):
    (tmp_path / "d.json").write_text(json.dumps({"Ses01_a": DATA["Ses01_a"]}))
    oom = Recorder(lambda bs: torch.cuda.OutOfMemoryError("CUDA out of memory") if bs > 1 else None)
    _run(tbio, monkeypatch, oom, tmp_path / "d.json", tmp_path / "o.json", ("--batch_ladder", "4", "2", "1"))
    assert [len(c) for c in oom.calls] == [3, 2, 1, 1, 1]
    assert "batch 4 ran out of memory" in capsys.readouterr().out
    assert len(json.loads((tmp_path / "o.json").read_text())["Ses01_a"]) == 3

    broken = Recorder(lambda bs: RuntimeError("flash_attention: kernel failed to launch"))
    with pytest.raises(RuntimeError, match="failed to launch"):
        _run(tbio, monkeypatch, broken, tmp_path / "d.json", tmp_path / "b.json")
    assert len(broken.calls) == 1 and not (tmp_path / "b.json").exists()

    always = Recorder(lambda bs: torch.cuda.OutOfMemoryError("CUDA out of memory"))
    with pytest.raises(RuntimeError, match="every batch size of \\[8, 4\\] ran out of device memory"):
        _run(tbio, monkeypatch, always, tmp_path / "d.json", tmp_path / "a.json", ("--batch_ladder", "8", "4"))
    assert not (tmp_path / "a.json").exists()


def test_bio_extract_greedy_bios_match_jax(tmp_path, monkeypatch):
    for mod in (jsampling, tsampling):
        monkeypatch.setattr(mod.SamplerConfig, "biography", classmethod(lambda cls: cls(greedy=True)))
    ckpt = str(tmp_path / "embedder.npz")
    save_pytree(ckpt, jax.tree_util.tree_map(np.asarray, jcore.init_params(jax.random.PRNGKey(7),
                                                                           tiny_config().embedder)))
    (tmp_path / "d.json").write_text(json.dumps({"Ses02_b": DATA["Ses02_b"]}))
    args = ["--tiny", "--embedder_checkpoint", ckpt, "--set", "embedder.dtype=float32",
            "--data_json", str(tmp_path / "d.json")]
    tbio.main(args + ["--output_json", str(tmp_path / "t.json"), "--device", "cpu"])
    jbio.main(args + ["--output_json", str(tmp_path / "j.json")])
    got, want = json.loads((tmp_path / "t.json").read_text()), json.loads((tmp_path / "j.json").read_text())
    assert got == want and len(got["Ses02_b"]) == 2 and all(isinstance(b, str) for b in got["Ses02_b"])
