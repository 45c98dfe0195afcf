"""Vector-only search: load raw vectors from a JSON embedding dump
([{file_id, text, combined_embedding, ...}] or {"embedding": [...]}), top-k
cosine search, print file_id / text / distance. No LLM in the loop.

Counterpart of the JAX ``cli/search_embeddings.py``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..retrieval.store import StyleStore

_KEYS = ("combined_embedding", "embedding", "vector")


def load_query_vectors(path: str) -> np.ndarray:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if isinstance(data, dict):
        for key in _KEYS:
            if key in data:
                return np.asarray([data[key]], np.float32)
        data = list(data.values())
    vecs = [next(entry[k] for k in _KEYS if k in entry) for entry in data if any(k in entry for k in _KEYS)]
    if not vecs:
        raise ValueError(f"no embedding vectors found in {path}")
    return np.asarray(vecs, np.float32)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--query_json", type=str, required=True)
    p.add_argument("--db_path", type=str, required=True)
    p.add_argument("--top_k", type=int, default=5)
    p.add_argument("--max_queries", type=int, default=0, help="0 = all")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card (cpu: the plain PyTorch path)")
    args = p.parse_args(argv)

    store = StyleStore.load(args.db_path, device=args.device)
    q = load_query_vectors(args.query_json)
    if args.max_queries:
        q = q[: args.max_queries]
    print(f"{q.shape[0]} queries (dim {q.shape[1]}) against {len(store)} vectors")
    for qi, hl in enumerate(store.search(q, k=args.top_k)):
        print(f"query {qi}:")
        for rank, h in enumerate(hl):
            print(f"  #{rank + 1} file_id={h.file_id!r} distance={h.distance:.4f} text={h.text[:60]!r}")


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
