"""Migrate a Milvus Lite .db (the reference's vector store format,
milvus/milvus_demo.db) into a StyleStore snapshot: an existing deployment
switches without re-embedding its style corpus.

Counterpart of the JAX ``cli/import_milvus.py``; the store is built on
``--device`` (default the card), self-verified there, then saved.

  python -m autostyle_tts_tpu_torch.cli.import_milvus --milvus_db milvus_demo.db --out db/store
"""

from __future__ import annotations

import argparse

from ..retrieval.milvus_import import import_milvus_db, list_collections
from .common import add_device_arg


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--milvus_db", type=str, required=True)
    p.add_argument("--collection", type=str, default=None, help="default: the largest non-empty collection")
    p.add_argument("--out", type=str, required=True, help="StyleStore snapshot path")
    p.add_argument("--list", action="store_true", help="list collections and exit")
    add_device_arg(p)
    args = p.parse_args(argv)

    if args.list:
        for c in list_collections(args.milvus_db):
            print(c)
        return
    store = import_milvus_db(args.milvus_db, args.collection, device=args.device)
    ok = store.self_verify(sample=min(64, len(store)))
    store.save(args.out)
    print(f"imported {len(store)} vectors (dim {store.dim}) -> {args.out}; "
          f"self-verify {'ok' if ok else 'FAILED'}")


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
