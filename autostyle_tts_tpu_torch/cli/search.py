"""One-shot or interactive text query: label the query text's emotion with
the embedder LLM, take the speaker's biography (--speaker_bios) or the
placeholder, concatenate the two embeddings and print the top-k rows.

Counterpart of the JAX ``cli/search.py``.
"""

from __future__ import annotations

import argparse
import json

from ..pipeline.rag import PLACEHOLDER_BIO
from ..retrieval.store import StyleStore
from .common import add_common_args, build_config
from .insert_embeddings import add_embedder_args, build_embedder


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    add_embedder_args(p)
    p.add_argument("--db_path", type=str, required=True)
    p.add_argument("--query_text", type=str, default=None, help="one-shot query; omit for interactive mode")
    p.add_argument("--speaker_bios", type=str, default=None, help="JSON {speaker: biography}")
    p.add_argument("--speaker", type=str, default=None)
    p.add_argument("--top_k", type=int, default=3)
    args = p.parse_args(argv)

    cfg = build_config(args)
    embedder = build_embedder(args, cfg)
    store = StyleStore.load(args.db_path, device=embedder.device)
    bios = {}
    if args.speaker_bios:
        with open(args.speaker_bios, encoding="utf-8") as f:
            bios = json.load(f)

    def one(text: str) -> None:
        q = embedder.combined_embedding([embedder.emotion_label(text)], [bios.get(args.speaker, PLACEHOLDER_BIO)])
        for rank, h in enumerate(store.search(q, k=args.top_k)[0]):
            print(f"  #{rank + 1} file_id={h.file_id!r} distance={h.distance:.4f} text={h.text[:60]!r}")

    if args.query_text is not None:
        one(args.query_text)
        return
    print("interactive search — empty line to quit")
    while True:
        try:
            text = input("query> ").strip()
        except EOFError:
            break
        if not text:
            break
        one(text)


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
