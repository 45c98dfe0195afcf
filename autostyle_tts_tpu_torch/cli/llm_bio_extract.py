"""Speaker-biography extraction over ERC datasets: for every conversation
and speaker, prompt the embedder LLM for a 250-word characterization.

Counterpart of the JAX ``cli/llm_bio_extract.py``, with its file contract:
the output is ``{conv_id: [bio per utterance]}`` (the spdescV2 reformatter's
input); an existing output file is copied to ``<output>_backup.json`` and
its conversations are skipped (incremental resume); ``--language zh`` picks
the Chinese prompt and name maps; each conversation's biographies are
written in batches from the first size of ``--batch_ladder`` that fits.

The ladder steps down only on ``torch.cuda.OutOfMemoryError``: any other
error (a kernel that does not build or launch, a shape error) raises, and so
does a conversation for which every batch size ran out of memory. The JAX
CLI catches every exception and skips such a conversation; here a failure
on the card is never hidden behind a smaller batch or an exit code of 0.
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import torch

from ..train.reformat import _names  # the same speaker-name contract
from .common import add_common_args, build_config
from .insert_embeddings import add_embedder_args, build_embedder


def bios_down_ladder(embedder, items, ladder, cid: str = ""):
    """The biographies of ``items`` ([(conversation, speaker)]) in batches of
    the first size of ``ladder`` that does not run out of device memory."""
    for bs in ladder:
        try:
            bios = []
            for s0 in range(0, len(items), bs):
                bios.extend(embedder.biographies(items[s0 : s0 + bs]))
            return bios
        except torch.cuda.OutOfMemoryError as e:
            print(f"conv {cid}: batch {bs} ran out of memory ({e}); retrying smaller")
            torch.cuda.empty_cache()
    raise RuntimeError(f"conv {cid}: every batch size of {list(ladder)} ran out of device memory")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    add_embedder_args(p)
    p.add_argument("--data_json", type=str, required=True,
                   help="{conv_id: {sentences, genders, labels}} dataset JSON")
    p.add_argument("--output_json", type=str, required=True)
    # --language comes from add_embedder_args (the prompt and name maps here,
    # the emotion label set in the embedder service)
    p.add_argument("--batch_ladder", type=int, nargs="+", default=[8, 4, 2, 1],
                   help="batch sizes to step down through on out-of-memory")
    args = p.parse_args(argv)

    cfg = build_config(args)
    embedder = build_embedder(args, cfg)
    with open(args.data_json, encoding="utf-8") as f:
        data = json.load(f)

    out_path = Path(args.output_json)
    results = {}
    if out_path.exists():  # incremental resume
        shutil.copy(out_path, str(out_path) + "_backup.json")
        with open(out_path, encoding="utf-8") as f:
            results = json.load(f)
        print(f"resuming: {len(results)} conversations already processed")

    for cid, conv in data.items():
        if cid in results:
            continue
        names = _names(conv, cid, args.language)
        conv_text = "\n".join(f"{n}: {s}" for n, s in zip(names, conv["sentences"]))
        bios = bios_down_ladder(embedder, [(conv_text, n) for n in names], args.batch_ladder, cid)
        results[cid] = bios
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(results, f, ensure_ascii=False)
        print(f"conv {cid}: {len(bios)} bios ({len(results)}/{len(data)})")
    print(f"done -> {out_path}")


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
