"""Speaker-similarity scorer over a ``vc_from_dir`` meta.lst: for every row
cosine(spk(synthesized wav), spk(timbre prompt wav)) on the engine's speaker
encoder, in batches, written as a JSON report (per-row scores and mean /
p50 / min / max). Counterpart of the JAX ``cli/score_similarity.py``; runs
on the card unless --device cpu.

  python -m autostyle_tts_tpu_torch.cli.score_similarity \\
      --meta_lst results/meta.lst --wav_dir results \\
      --output_json results/similarity.json [--checkpoint engine.npz]
"""

from __future__ import annotations

import argparse
import json

from ..pipeline.simeval import score_meta_lst, write_report
from .common import add_common_args, build_engine, run_cli


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--meta_lst", type=str, required=True)
    p.add_argument("--wav_dir", type=str, required=True, help="directory of the synthesized {name}.wav files")
    p.add_argument("--output_json", type=str, required=True)
    p.add_argument("--batch", type=int, default=64)
    args = p.parse_args(argv)

    engine = build_engine(args)
    report = score_meta_lst(engine, args.meta_lst, args.wav_dir, batch=args.batch)
    write_report(args.output_json, report)
    print(json.dumps({"similarity_summary": report["summary"]}, ensure_ascii=False))


if __name__ == "__main__":
    run_cli(main)
