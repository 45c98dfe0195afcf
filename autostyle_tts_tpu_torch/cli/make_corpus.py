"""Generate the formant-synthesis training corpus (train/synthcorpus.py):
the same files as the JAX ``cli/make_corpus.py`` for the same arguments.

  python -m autostyle_tts_tpu_torch.cli.make_corpus --out_dir /tmp/corpus \\
      --n_utts 1500 --n_speakers 24
"""

from __future__ import annotations

import argparse

from ..train.synthcorpus import generate_corpus


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--n_utts", type=int, default=1500)
    p.add_argument("--n_speakers", type=int, default=24)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--min_words", type=int, default=2)
    p.add_argument("--max_words", type=int, default=6)
    args = p.parse_args(argv)
    manifest = generate_corpus(
        args.out_dir, n_utts=args.n_utts, n_speakers=args.n_speakers,
        seed=args.seed, min_words=args.min_words, max_words=args.max_words,
    )
    print(f"manifest -> {manifest}")


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
