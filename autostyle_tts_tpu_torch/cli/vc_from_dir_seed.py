"""The style x timbre matrix with timbres drawn from a seed-TTS test set's
meta.lst ('a|b|c|d' rows; the wav path is column 3), its paths rewritten
'-wavs' -> '_temp' and '.wav' -> '_16k.wav' (flags). Everything else is
``vc_from_dir``'s. Counterpart of the JAX ``cli/vc_from_dir_seed.py``; runs
on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import random
from typing import List, Tuple

from .common import build_engine
from .vc_from_dir import add_matrix_args, run_matrix


def read_seed_meta(lst_path: str, num: int, rng: random.Random, base_dir: str = "",
                   rewrite_from: str = "-wavs", rewrite_to: str = "_temp", suffix_from: str = ".wav",
                   suffix_to: str = "_16k.wav") -> List[Tuple[str, str]]:
    rows = []
    with open(lst_path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) >= 4:
                rows.append((parts[2], parts[1]))   # (wav path, text)
    picked = rng.sample(rows, num) if len(rows) >= num else rows
    out = []
    for path, text in picked:
        p = path.replace(rewrite_from, rewrite_to).replace(suffix_from, suffix_to)
        if base_dir:
            p = base_dir.rstrip("/") + "/" + p.lstrip("/")
        out.append((p, text))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_matrix_args(p)
    p.add_argument("--seed_meta_lst", type=str, required=True, help="the seed-TTS test set's meta.lst")
    p.add_argument("--seed_base_dir", type=str, default="")
    p.add_argument("--rewrite_from", type=str, default="-wavs")
    p.add_argument("--rewrite_to", type=str, default="_temp")
    args = p.parse_args(argv)
    rng = random.Random(args.seed)
    engine = build_engine(args)
    timbre_items = read_seed_meta(args.seed_meta_lst, args.timbre_num, rng, base_dir=args.seed_base_dir,
                                  rewrite_from=args.rewrite_from, rewrite_to=args.rewrite_to)
    run_matrix(engine, args, timbre_items, rng)


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
