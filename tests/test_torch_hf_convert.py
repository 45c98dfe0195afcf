"""The port's Hugging Face checkpoint loader (``utils/hf_convert.py``)
against the JAX package's (``tests/test_hf_convert.py``) and against
``transformers`` itself, on the CPU, on tiny random Llama / Qwen2 models
saved with ``save_pretrained``.

Tolerances:
- the port's ``load_hf_checkpoint`` (its own safetensors reader, or
  ``torch.load`` of a ``.bin``) gives params bitwise equal to the JAX
  ``load_hf_checkpoint``'s (through ``transformers``), Qwen2's q/k/v
  biases included;
- the port's f32 logits within 2e-3 of the Hugging Face model's, the JAX
  file's bound;
- ``read_safetensors`` / ``write_safetensors`` bitwise against the
  ``safetensors`` package, bf16 included;
- the embedder served from the loaded checkpoint at f32: embeddings within
  1e-4 of the JAX service's; ``insert_embeddings --embedder_hf_dir`` runs on
  both packages with the checkpoint's own tokenizer.
"""

import dataclasses
import json
import os

# local directories only: the hub is never asked
os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import transformers  # noqa: E402

from autostyle_tts_tpu.pipeline.rag import EmbedderService as JEmbedderService  # noqa: E402
from autostyle_tts_tpu.utils import hf_convert as jhf
from autostyle_tts_tpu_torch.models import transformer as core
from autostyle_tts_tpu_torch.pipeline.rag import EmbedderService
from autostyle_tts_tpu_torch.utils import hf_convert as hf
from autostyle_tts_tpu_torch.utils.config import llama32_3b_config
from torch_one_thread import one_thread  # noqa: F401

WORDS = ("hello world the a is and of to in it you that he was for on are with as I his they be at one have "
         "this from or had by hot word but what some we can out other were all there when up use your how "
         "said an each she which do their time if will way about many then them write would like so these "
         "her long make thing see him two has look more day could go come did number sound no most people "
         "my over know water than call first who may down side been now find").split()


def _tiny(kind: str):
    common = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=2048,
                  rope_theta=10000.0, tie_word_embeddings=False)
    if kind == "llama":
        torch.manual_seed(0)
        return transformers.LlamaForCausalLM(transformers.LlamaConfig(rms_norm_eps=1e-5, **common)).eval()
    torch.manual_seed(1)
    return transformers.Qwen2ForCausalLM(transformers.Qwen2Config(rms_norm_eps=1e-6, **common)).eval()


def _tokenizer():
    """A word-level tokenizer over WORDS (ids below the tiny vocab), with
    pad / eos / unk, in the Hugging Face format."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"[PAD]": 0, "[UNK]": 1, "[EOS]": 2}
    for w in WORDS:
        vocab.setdefault(w.lower(), len(vocab))
    assert len(vocab) <= 128
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    return transformers.PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]", pad_token="[PAD]",
                                                eos_token="[EOS]")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{kind: (dir, model)}: safetensors checkpoints with a tokenizer, and
    the Llama one again as a pytorch_model.bin."""
    out = {}
    for kind in ("llama", "qwen2"):
        d = tmp_path_factory.mktemp(kind)
        model = _tiny(kind)
        model.save_pretrained(d)
        _tokenizer().save_pretrained(d)
        out[kind] = (d, model)
    d = tmp_path_factory.mktemp("llama_bin")
    out["llama"][1].save_pretrained(d, safe_serialization=False)
    out["llama_bin"] = (d, out["llama"][1])
    return out


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, p)
        else:
            yield p, v


@pytest.mark.parametrize("kind", ["llama", "qwen2", "llama_bin"])
def test_loader_params_bitwise_equal_to_jax(checkpoints, kind):
    d, _ = checkpoints[kind]
    assert any(d.glob("*.safetensors")) == (kind != "llama_bin")
    cfg, params = hf.load_hf_checkpoint(str(d), device="cpu")
    jcfg, jparams = jhf.load_hf_checkpoint(str(d))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    got, want = dict(_leaves(params)), dict(_leaves(jparams))
    assert sorted(got) == sorted(want)
    assert ("layers/bqkv" in got) == (kind == "qwen2")
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("kind", ["llama", "qwen2"])
def test_logits_match_transformers(checkpoints, kind):
    d, model = checkpoints[kind]
    cfg, params = hf.load_hf_checkpoint(str(d), device="cpu")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    tokens = np.random.default_rng(0).integers(0, 128, (2, 10))
    with torch.no_grad():
        ref = model(torch.tensor(tokens)).logits.float().numpy()
        h = core.forward(params, cfg32, torch.tensor(tokens), offset=torch.zeros(2, dtype=torch.int32))
        got = core.matmul_any(h, core._head(params)).numpy()
    assert np.abs(got - ref).max() < 2e-3


def test_convert_state_dict_takes_numpy_and_tensors(checkpoints):
    """The same tree from the model's state dict as tensors, as numpy
    arrays and in bf16 (rounded as stored: the f32 of each bf16 value)."""
    _, model = checkpoints["qwen2"]
    cfg = hf.config_from_hf(model.config)
    sd = model.state_dict()
    a = hf.convert_state_dict(sd, cfg)
    b = hf.convert_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    c = hf.convert_state_dict({k: v.to(torch.bfloat16) for k, v in sd.items()}, cfg)
    for (k, x), (_, y), (_, z) in zip(_leaves(a), _leaves(b), _leaves(c)):
        assert torch.equal(x, y), k
        assert torch.equal(z, x.to(torch.bfloat16).float()), k


def test_safetensors_reader_and_writer_match_the_package(tmp_path):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(3, 5, generator=g), "b": torch.randn(7, generator=g).to(torch.bfloat16),
               "c": torch.arange(6, dtype=torch.int64).reshape(2, 3), "d": torch.randn(2, 2, generator=g).half(),
               "e": torch.tensor(1.5)}
    save_file(tensors, tmp_path / "pkg.safetensors", metadata={"format": "pt"})
    hf.write_safetensors(tmp_path / "own.safetensors", tensors)
    for path in ("pkg.safetensors", "own.safetensors"):
        ours, theirs = hf.read_safetensors(tmp_path / path), load_file(tmp_path / path)
        assert sorted(ours) == sorted(theirs) == sorted(tensors)
        for k in tensors:
            assert ours[k].dtype == theirs[k].dtype == tensors[k].dtype
            assert torch.equal(ours[k], theirs[k]) and torch.equal(ours[k], tensors[k]), (path, k)


def test_config_from_hf_3b_geometry():
    hfc = dict(vocab_size=128256, hidden_size=3072, num_hidden_layers=28, num_attention_heads=24,
               num_key_value_heads=8, intermediate_size=8192, max_position_embeddings=131072,
               rope_theta=500000.0, rms_norm_eps=1e-5)
    cfg, want = hf.config_from_hf(hfc), llama32_3b_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jhf.config_from_hf(hfc))
    assert (cfg.dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim, cfg.vocab_size) == (
        want.dim, want.n_layers, want.n_heads, want.n_kv_heads, want.ffn_dim, want.vocab_size)


def test_embedder_from_hf_checkpoint_matches_jax(checkpoints):
    """The embedder service on the loaded checkpoint and its own tokenizer,
    at f32: the port's embeddings against the JAX service's."""
    d, _ = checkpoints["llama"]
    tok = transformers.AutoTokenizer.from_pretrained(str(d))
    cfg, params = hf.load_hf_checkpoint(str(d), device="cpu")
    jcfg, jparams = jhf.load_hf_checkpoint(str(d))
    svc = EmbedderService(dataclasses.replace(cfg, dtype="float32"), params, tokenizer=tok, device="cpu")
    jsvc = JEmbedderService(dataclasses.replace(jcfg, dtype="float32"), jax.tree.map(np.asarray, jparams),
                            tokenizer=tok)
    texts = ["hello world this is one", "what time is it now", "the people were there"]
    got, want = svc.embed(texts, width=16), jsvc.embed(texts, width=16)
    assert got.shape == (3, cfg.dim) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_insert_embeddings_with_hf_dir_on_both_packages(checkpoints, tmp_path):
    from autostyle_tts_tpu.cli import insert_embeddings as jins
    from autostyle_tts_tpu_torch.cli import insert_embeddings as ins

    d, _ = checkpoints["llama"]
    manifest = [{"speaker": "w1", "zh_text": "hello world this is one", "file_id": "f0"},
                {"speaker": "m1", "zh_text": "what time is it now", "file_id": "f1"}]
    (tmp_path / "styles.json").write_text(json.dumps(manifest))
    dims = {}
    for name, mod, extra in (("port", ins, ["--device", "cpu"]), ("jax", jins, [])):
        db = tmp_path / name / "store"
        mod.main(["--tiny", "--embedder_hf_dir", str(d), "--input_json", str(tmp_path / "styles.json"),
                  "--db_path", str(db), "--capacity", "8", "--dump_embeddings", str(tmp_path / f"{name}.json")]
                 + extra)
        dump = json.loads((tmp_path / f"{name}.json").read_text())
        assert [r["file_id"] for r in dump] == ["f0", "f1"]
        vec = np.asarray([r["combined_embedding"] for r in dump])
        assert np.isfinite(vec).all()
        dims[name] = vec.shape
    assert dims["port"] == dims["jax"] == (2, 2 * 64)


def test_insert_embeddings_hf_dir_names_transformers_when_missing(checkpoints, monkeypatch):
    """Without ``transformers`` the CLI raises and names the package; it
    never substitutes another tokenizer."""
    import argparse
    import builtins

    from autostyle_tts_tpu_torch.cli import insert_embeddings as ins
    from autostyle_tts_tpu_torch.cli.common import add_common_args, build_config

    real_import = builtins.__import__

    def no_transformers(name, *a, **k):
        if name == "transformers" or name.startswith("transformers."):
            raise ImportError("No module named 'transformers'")
        return real_import(name, *a, **k)

    p = argparse.ArgumentParser()
    add_common_args(p)
    ins.add_embedder_args(p)
    args = p.parse_args(["--tiny", "--embedder_hf_dir", str(checkpoints["llama"][0]), "--device", "cpu"])
    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(RuntimeError, match="transformers"):
        ins.build_embedder(args, build_config(args))
