"""Batch dialog retrieval: for each input turn {zh_text, speaker}, one
biography a speaker, an emotion label a turn, the combined query, top-k
search, and one JSONL row {zh_text, speaker, retrieved_file_id (with
--file_prefix_path), retrieved_text, distance, retrieved_index}.

--ablation emotion_only / bio_only zeroes one half of the query.
Counterpart of the JAX ``cli/search_json.py``.
"""

from __future__ import annotations

import argparse

from ..pipeline.rag import DialogTurn, search_dialog
from ..retrieval.store import StyleStore
from ..utils.manifest import read_jsonl, write_jsonl
from .common import add_common_args, build_config
from .insert_embeddings import add_embedder_args, build_embedder


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    add_embedder_args(p)
    p.add_argument("--input_json", type=str, required=True, help="dialog turns JSONL: {zh_text, speaker} a line")
    p.add_argument("--db_path", type=str, required=True, help="StyleStore snapshot from insert_embeddings")
    p.add_argument("--output_file", type=str, required=True)
    p.add_argument("--file_prefix_path", type=str, default="")
    p.add_argument("--top_k", type=int, default=1)
    p.add_argument("--ablation", type=str, default=None, choices=[None, "emotion_only", "bio_only"])
    p.add_argument("--context_window", type=int, default=0,
                   help="label each turn with the ±N surrounding turns as context (0: each utterance "
                        "alone; >0: the ERC fine-tune's training shape, use with --lora_checkpoint)")
    args = p.parse_args(argv)

    cfg = build_config(args)
    embedder = build_embedder(args, cfg)
    store = StyleStore.load(args.db_path, device=embedder.device)
    turns = [DialogTurn(zh_text=d.get("zh_text", d.get("text", "")), speaker=str(d.get("speaker", "")))
             for d in read_jsonl(args.input_json)]
    print(f"{len(turns)} turns, {len(store)} styles in DB")
    rows = search_dialog(embedder, store, turns, top_k=args.top_k, file_prefix_path=args.file_prefix_path,
                         ablation=args.ablation, context_window=args.context_window)
    write_jsonl(args.output_file, (r.to_dict() for r in rows))
    print(f"wrote {len(rows)} rows -> {args.output_file}")


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
