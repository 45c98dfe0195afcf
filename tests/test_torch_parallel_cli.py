"""An engine CLI on a mesh: ``tts_from_lines --tiny --device cpu --dp 2``
under ``torchrun --standalone --nproc_per_node 2`` writes the wavs of the
single-process run (rank 0 alone writes and prints), and ``--dp 2``
outside ``torchrun`` raises and names the ``torchrun`` line. The wavs are
PCM16: they are compared within two steps of it (6.2e-5)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from autostyle_tts_tpu_torch.cli import tts_from_lines
from autostyle_tts_tpu_torch.utils.audio_io import read_wav, write_wav

from torch_one_thread import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def inputs(tmp_path):
    sr = 1600
    t = np.arange(sr) / sr
    write_wav(tmp_path / "p.wav", (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), sr)
    (tmp_path / "lines.txt").write_text("the first line here\nand a second one\n")
    return ["--tiny", "--device", "cpu", "--txt_path", str(tmp_path / "lines.txt"),
            "--prompt_wav", str(tmp_path / "p.wav"), "--prompt_text", "a prompt"]


def test_tts_from_lines_dp2_under_torchrun_writes_the_single_process_wavs(tmp_path, inputs):
    tts_from_lines.main(inputs + ["--result_dir", str(tmp_path / "one")])
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR")}
    env["PYTHONPATH"] = str(REPO)
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "autostyle_tts_tpu_torch.cli.tts_from_lines", *inputs, "--result_dir", str(tmp_path / "mesh"),
         "--dp", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-4000:]
    assert run.stdout.count("saved ") == 2          # rank 0's lines only
    names = sorted(p.name for p in (tmp_path / "one").iterdir())
    assert names == ["line_1.wav", "line_2.wav"]
    assert sorted(p.name for p in (tmp_path / "mesh").iterdir()) == names
    for name in names:
        want, sr = read_wav(tmp_path / "one" / name)
        got, sr2 = read_wav(tmp_path / "mesh" / name)
        assert sr == sr2 and got.shape == want.shape and want.size > 0
        np.testing.assert_allclose(got, want, atol=2 / 32767)


def test_dp2_outside_torchrun_raises_naming_torchrun(tmp_path, inputs, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        tts_from_lines.main(inputs + ["--result_dir", str(tmp_path / "o"), "--dp", "2"])
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        tts_from_lines.main(inputs + ["--result_dir", str(tmp_path / "o"), "--dp", "2", "--tp", "2"])
