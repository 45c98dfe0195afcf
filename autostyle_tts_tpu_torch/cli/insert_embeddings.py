"""Style-DB build: load style-sample manifests ({speaker, zh_text,
file_id}), write one biography a speaker and an emotion label an utterance
with the embedder LLM, insert the 2*dim combined embeddings, self-verify,
save a snapshot (npz + meta sidecar).

Counterpart of the JAX ``cli/insert_embeddings.py``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..pipeline.rag import EmbedderService, build_style_db, labels_for_language
from ..utils import rng
from ..utils.device import resolve_device
from ..utils.manifest import load_style_manifests
from .common import add_common_args, build_config, build_engine, check_single_device


def build_embedder(args, cfg) -> EmbedderService:
    """The embedder on ``--device``: a local Hugging Face checkpoint
    (``--embedder_hf_dir``: its config, weights and tokenizer), or
    ``cfg.embedder`` with seeded random weights (int8 with
    ``--quantize_base``) or ``--embedder_checkpoint``; an optional
    ``--lora_checkpoint`` at scale alpha / r, an optional ``--bpe_path``
    tokenizer where no Hugging Face tokenizer is loaded."""
    from ..models import transformer as core
    from ..weights import load_lora, load_tree

    check_single_device(args)
    dev = resolve_device(args.device)
    tokenizer = None
    if getattr(args, "embedder_hf_dir", None):
        # the reference's Llama-3.2-3B / Qwen2.5-7B path; the tokenizer is
        # the checkpoint's own, read by transformers (never substituted)
        try:
            import transformers
        except ImportError as e:
            raise RuntimeError("--embedder_hf_dir loads the checkpoint's tokenizer with the "
                               "'transformers' package, which is not installed") from e
        from ..utils.hf_convert import load_hf_checkpoint

        ecfg, params = load_hf_checkpoint(args.embedder_hf_dir, device=dev)
        tokenizer = transformers.AutoTokenizer.from_pretrained(args.embedder_hf_dir)
    else:
        ecfg = cfg.embedder
        # drawn as the JAX package draws it from --seed, so an adapter trained
        # there (artifacts/ft3b: seed 42, int8) runs over its own base; int8
        # frozen base: a 3B base and its adapter fit beside the engine
        key = rng.PRNGKey(args.seed, dev)
        params = (core.init_params_quantized(ecfg, key, bits=8) if getattr(args, "quantize_base", False)
                  else core.init_params(ecfg, key))
        if getattr(args, "embedder_checkpoint", None):
            params = load_tree(args.embedder_checkpoint, params)
    lora, lora_scale = None, 0.0
    if getattr(args, "lora_checkpoint", None):
        lora = load_lora(args.lora_checkpoint, ecfg, cfg.train.lora.r, device=dev)
        lora_scale = cfg.train.lora.alpha / cfg.train.lora.r
    if tokenizer is None and getattr(args, "bpe_path", None):
        from ..models.bpe import BPETokenizer

        tokenizer = BPETokenizer.load(args.bpe_path)
    language = getattr(args, "language", "en")
    return EmbedderService(ecfg, params, lora=lora, lora_scale=lora_scale, tokenizer=tokenizer,
                           labels=labels_for_language(language), language=language, device=dev)


def add_embedder_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--embedder_checkpoint", type=str, default=None,
                   help="embedder weights (flat-key .npz)")
    p.add_argument("--embedder_hf_dir", type=str, default=None,
                   help="local Hugging Face checkpoint dir (Llama/Qwen2): converted on load, "
                        "its tokenizer read with transformers")
    p.add_argument("--lora_checkpoint", type=str, default=None,
                   help="LoRA adapter .npz (e.g. artifacts/ft3b/adapter_f16.npz)")
    p.add_argument("--quantize_base", action="store_true",
                   help="int8 frozen base, drawn and quantized a layer at a time")
    p.add_argument("--language", type=str, default="en", choices=("en", "zh"),
                   help="emotion label set of the classification prompts")
    p.add_argument("--bpe_path", type=str, default=None,
                   help="trained BPE vocab (models/bpe.py): the 512 embed truncation counts its tokens")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    add_embedder_args(p)
    p.add_argument("--input_json", type=str, nargs="+", required=True,
                   help="style-sample manifest JSON(s)")
    p.add_argument("--db_path", type=str, required=True, help="output snapshot path (npz + meta sidecar)")
    p.add_argument("--capacity", type=int, default=4096)
    p.add_argument("--style_wav_dir", type=str, default=None,
                   help="featurize wav_dir/file_id[.wav] at insert time and store speech tokens, "
                        "mel and speaker embedding as DB artifacts (tts_with_rag --style_db)")
    p.add_argument("--dump_embeddings", type=str, default=None,
                   help="also write an embedding dump JSON ([{file_id, text, combined_embedding, ...}])")
    args = p.parse_args(argv)

    cfg = build_config(args)
    embedder = build_embedder(args, cfg)
    samples = load_style_manifests(args.input_json)
    print(f"loaded {len(samples)} style samples from {len(args.input_json)} file(s)")
    engine = build_engine(args) if args.style_wav_dir else None
    store = build_style_db(embedder, samples, capacity=args.capacity, engine=engine,
                           wav_dir=args.style_wav_dir or "")
    store.save(args.db_path)
    print(f"inserted {len(store)} vectors (dim {store.dim}); self-verify ok; snapshot -> {args.db_path}")
    if args.dump_embeddings:
        vecs = store.db[: len(store)].cpu().numpy()
        dump = [{**store.meta[i], "combined_embedding": vecs[i].tolist(),
                 "combined_embedding_shape": [store.dim]} for i in range(len(store))]
        Path(args.dump_embeddings).parent.mkdir(parents=True, exist_ok=True)
        with open(args.dump_embeddings, "w", encoding="utf-8") as f:
            json.dump(dump, f, ensure_ascii=False)
        print(f"embedding dump -> {args.dump_embeddings}")


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
