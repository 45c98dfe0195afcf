"""The port's training CLIs at ``--tiny --device cpu``, and their files
across the packages.

- ``make_corpus`` writes the JAX CLI's bytes; ``train_acoustic`` trains
  every stage from it (checkpoints, resume from the latest); ``export_engine
  --stage_ckpt`` merges all four mergeable stages and ``basic`` synthesizes
  from the snapshot;
- stage checkpoints merge across the packages both ways: the JAX
  ``CheckpointManager``'s files through the port's ``export_engine``, the
  port's through the JAX one; each gives the tree the other package's export
  gives (equal; the dense token LM's projections at bf16, as the port
  exports a dense LM);
- ``distill_cfm``, ``ft_llm`` (``--re_gen_data --do_train --do_eval_dev``,
  the int8 base), ``evaluate_base_model`` and ``train_bpe`` (the JAX CLI's
  merges file, byte for byte);
- an entry point asked for the card on a machine without one raises.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest

from autostyle_tts_tpu.cli import export_engine as jexport
from autostyle_tts_tpu.cli import make_corpus as jmake_corpus
from autostyle_tts_tpu.cli import train_bpe as jtrain_bpe
from autostyle_tts_tpu.pipeline.engine import EngineParams as JParams
from autostyle_tts_tpu.utils.checkpoint import CheckpointManager as JManager
from autostyle_tts_tpu.utils.config import tiny_config as jtiny
from autostyle_tts_tpu_torch.cli import (basic, distill_cfm, evaluate_base_model, export_engine, ft_llm,
                                         make_corpus, train_acoustic, train_bpe)
from autostyle_tts_tpu_torch.utils.audio_io import read_wav
from autostyle_tts_tpu_torch.utils.checkpoint import CheckpointManager as TManager
from autostyle_tts_tpu_torch.weights import load_npz

from torch_one_thread import one_thread  # noqa: F401

CPU = ["--tiny", "--device", "cpu", "--seed", "0"]
STAGES = ("tokenizer", "token_lm", "cfm", "vocoder", "vocoder_gan", "phn_head")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_cli")
    make_corpus.main(["--out_dir", str(d / "corpus"), "--n_utts", "8", "--n_speakers", "2", "--seed", "1"])
    return d


def _train(d: Path, stage: str, *extra) -> Path:
    out = d / f"ck_{stage}"
    train_acoustic.main(CPU + ["--manifest", str(d / "corpus" / "manifest.json"), "--wav_dir", str(d / "corpus"),
                               "--stage", stage, "--out_dir", str(out), "--batch_size", "4", "--prompt_seconds",
                               "0.4", "--log_every", "1", *extra])
    return out


def test_make_corpus_bytes_equal_jax(corpus, tmp_path):
    jmake_corpus.main(["--out_dir", str(tmp_path / "j"), "--n_utts", "8", "--n_speakers", "2", "--seed", "1"])
    for p in sorted((tmp_path / "j").rglob("*")):
        if p.is_file():
            assert p.read_bytes() == (corpus / "corpus" / p.relative_to(tmp_path / "j")).read_bytes(), p


@pytest.mark.parametrize("stage", STAGES)
def test_train_acoustic_stage_checkpoints_and_resume(corpus, stage, capsys):
    out = _train(corpus, stage)
    assert TManager(out).latest_step() == 2                      # 8 items at batch 4: 2 steps an epoch
    text = capsys.readouterr().out
    assert "step 2:" in text and "done: 2 steps" in text
    if stage == "vocoder_gan":      # the discriminator's CPU steps are the slowest; its resume is the vocoder's
        return
    _train(corpus, stage, "--epochs", "2")                       # resumes at step 2: one epoch more
    assert TManager(out).latest_step() == 4
    assert "done: 4 steps" in capsys.readouterr().out


def test_export_merges_every_stage_and_serves(corpus):
    for stage in ("tokenizer", "token_lm", "cfm", "vocoder"):
        if not (corpus / f"ck_{stage}").exists():
            _train(corpus, stage)
    snap = corpus / "engine.npz"
    export_engine.main(CPU + ["--output", str(snap)] + [a for s in ("tokenizer", "token_lm", "cfm", "vocoder")
                                                        for a in ("--stage_ckpt", f"{s}={corpus / f'ck_{s}'}")])
    tree = load_npz(str(snap))
    for stage, key in (("cfm", "cfm/in_proj"), ("vocoder", "vocoder/pre/w"),
                       ("tokenizer", "speech_tokenizer/codebook")):
        ck_dir = corpus / f"ck_{stage}"
        ck = np.load(ck_dir / f"checkpoint-{TManager(ck_dir).latest_step()}" / "state.npz")
        node = tree
        for part in key.split("/"):
            node = node[part]
        np.testing.assert_array_equal(node, ck[("tok/" if stage == "tokenizer" else "") + key.split("/", 1)[1]])
    basic.main(CPU + ["--checkpoint", str(snap), "--prompt_wav", str(corpus / "corpus" / "wavs" / "utt00000.wav"),
                      "--result_dir", str(corpus / "out")])
    wav, sr = read_wav(corpus / "out" / "zero_shot_0.wav")
    assert sr == 2400 and len(wav) > 0 and np.isfinite(wav).all()


def _jax_stage_ckpts(d: Path):
    """Stage checkpoints as the JAX trainer writes them (its
    CheckpointManager over its parameter trees), drawn from another seed."""
    jp = JParams.init(jax.random.PRNGKey(9), jtiny())
    rng = np.random.default_rng(0)
    trees = {"token_lm": jp.token_lm, "cfm": jp.cfm, "vocoder": jp.vocoder,
             "tokenizer": {"tok": jp.speech_tokenizer, "head": rng.standard_normal((32, 19)).astype(np.float32)}}
    for stage, tree in trees.items():
        JManager(d / f"jck_{stage}").save(3, tree)
    return [a for s in trees for a in ("--stage_ckpt", f"{s}={d / f'jck_{s}'}")]


def _port_stage_ckpts(d: Path):
    return [a for s in ("tokenizer", "token_lm", "cfm", "vocoder") for a in ("--stage_ckpt", f"{s}={d / f'ck_{s}'}")]


@pytest.mark.parametrize("source", ["jax", "port"])
def test_stage_checkpoints_merge_across_packages(corpus, tmp_path, source):
    for stage in ("tokenizer", "token_lm", "cfm", "vocoder"):
        if not (corpus / f"ck_{stage}").exists():
            _train(corpus, stage)
    specs = _jax_stage_ckpts(tmp_path) if source == "jax" else _port_stage_ckpts(corpus)
    export_engine.main(CPU + ["--output", str(tmp_path / "t.npz")] + specs)
    jexport.main(["--tiny", "--seed", "0", "--output", str(tmp_path / "j.npz")] + specs)
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert set(t.files) == set(j.files)
        proj = ("token_lm/layers/wqkv", "token_lm/layers/wo", "token_lm/layers/w_gate_up", "token_lm/layers/w_down",
                "token_lm/speech_head")
        # the merged modules; the rest each package draws from its own stream
        for k in (k for k in j.files if k.split("/")[0] in ("token_lm", "cfm", "vocoder", "speech_tokenizer")):
            want = j[k]
            if k in proj:      # the port exports a dense LM's projections at the bf16 values it serves
                import torch

                want = torch.from_numpy(want).to(torch.bfloat16).float().numpy()
            np.testing.assert_array_equal(t[k], want, err_msg=k)


def test_distill_cfm_cli(corpus):
    out = corpus / "distilled.npz"
    distill_cfm.main(CPU + ["--manifest", str(corpus / "corpus" / "manifest.json"), "--wav_dir",
                            str(corpus / "corpus"), "--output", str(out), "--output_cfm", str(corpus / "cfm.npz"),
                            "--schedule", "2", "--steps_per_phase", "2", "--batch_size", "2", "--prompt_seconds",
                            "0.4", "--eval_batches", "1"])
    cfm = load_npz(str(corpus / "cfm.npz"))
    np.testing.assert_array_equal(load_npz(str(out))["cfm"]["in_proj"], cfm["in_proj"])
    assert json.loads((corpus / "cfm.npz.meta.json").read_text())["n_steps"] == 2


ERC_FLAGS = ["--set", "embedder.vocab_size=272", "--set", "train.max_seq_len=256", "--set", "train.epochs=1",
             "--set", "train.eval_every=1", "--set", "train.save_every=1", "--set", "train.lora.r=4",
             "--set", "train.batch_size=2", "--set", "train.grad_accum=2"]


def _erc_folder(d: Path) -> Path:
    folder = d / "erc"
    folder.mkdir(exist_ok=True)
    conv = {"labels": [0, 2, 5, 1], "sentences": ["I love this!", "Okay.", "This is hopeless.", "Oh no."],
            "genders": ["F", "M", "F", "M"]}
    for split, conv_ids in (("train", ("Ses01_a", "Ses02_b")), ("valid", ("Ses03_c",))):
        (folder / f"iemocap.{split}.json").write_text(json.dumps({c: conv for c in conv_ids}))
    return folder


@pytest.mark.parametrize("quantize", [False, True])
def test_ft_llm_train_and_eval(tmp_path, quantize, capsys):
    folder = _erc_folder(tmp_path)
    out = tmp_path / "ft"
    ft_llm.main(CPU + ERC_FLAGS + ["--data_folder", str(folder), "--re_gen_data", "--do_train", "--do_eval_dev",
                                   "--window", "1", "--out_dir", str(out)] + (["--quantize_base"] if quantize else []))
    summary = json.loads((out / "summary.json").read_text())
    assert summary["0"]["steps"] == 2 and 0.0 <= summary["0"]["valid_f1"] <= 1.0
    run = out / "seed0"
    assert (run / "best.npz").exists() and (run / "history.json").exists() and list((run / "tb").iterdir())
    assert (folder / "iemocap.train.0shot_w1_default.jsonl").exists()
    assert "reformatted train: 8 samples" in capsys.readouterr().out


def test_evaluate_base_model(tmp_path):
    folder = _erc_folder(tmp_path)
    ft_llm.main(CPU + ERC_FLAGS + ["--data_folder", str(folder), "--re_gen_data", "--window", "1",
                                   "--out_dir", str(tmp_path / "ft")])
    out = tmp_path / "eval.json"
    evaluate_base_model.main(CPU + ERC_FLAGS + ["--test_jsonl", str(folder / "iemocap.valid.0shot_w1_default.jsonl"),
                                                "--output_file", str(out), "--batch_size", "4"])
    res = json.loads(out.read_text())
    assert len(res["predictions"]) == len(res["references"]) == 4 and 0.0 <= res["weighted_f1"] <= 1.0


def test_train_bpe_bytes_equal_jax(tmp_path):
    (tmp_path / "t.txt").write_text("\n".join(["the cat sat on the mat", "the dog sat", "cats and dogs"] * 4))
    (tmp_path / "c.json").write_text(json.dumps({"a": {"sentences": ["hello there", "the cat"]}}))
    args = ["--input", str(tmp_path / "t.txt"), str(tmp_path / "c.json"), "--merges", "24"]
    train_bpe.main(args + ["--output", str(tmp_path / "t.json")])
    jtrain_bpe.main(args + ["--output", str(tmp_path / "j.json")])
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()


def test_training_entry_points_need_the_card_unless_asked_for_the_cpu(corpus):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_acoustic.main(["--tiny", "--manifest", str(corpus / "corpus" / "manifest.json"), "--stage", "cfm",
                             "--out_dir", str(corpus / "nocard")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ft_llm.main(["--tiny", "--data_folder", str(corpus), "--do_train"])
