"""Retrieval-quality report for a style DB snapshot.

Counterpart of the JAX ``cli/retrieval_report.py``: self-recall@k over
every stored row (1.0 on a healthy store) and the cross top-1 cosine
against the reference's observed band; ``--fail_below_recall`` makes the
exit code non-zero below a threshold (a CI gate). The store is loaded on
``--device`` (default the card).

  python -m autostyle_tts_tpu_torch.cli.retrieval_report \\
      --db_path style_db [--k 5] [--output_json report.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

from ..pipeline.simeval import retrieval_report, write_report
from ..retrieval.store import StyleStore
from .common import add_device_arg, run_cli


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--db_path", type=str, required=True, help="StyleStore snapshot (npz + meta sidecar)")
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--band", type=float, nargs=2, default=(0.83, 0.88),
                   help="reference cosine band to report coverage against")
    p.add_argument("--output_json", type=str, default=None)
    p.add_argument("--fail_below_recall", type=float, default=None,
                   help="exit nonzero if recall@k drops below this (CI gate)")
    add_device_arg(p)
    args = p.parse_args(argv)

    store = StyleStore.load(args.db_path, device=args.device)
    report = retrieval_report(store, k=args.k, reference_band=tuple(args.band))
    if args.output_json:
        write_report(args.output_json, report)
    print(json.dumps(report, ensure_ascii=False))
    if args.fail_below_recall is not None and report["recall_at_k"] < args.fail_below_recall:
        raise SystemExit(f"recall@{args.k}={report['recall_at_k']:.4f} < {args.fail_below_recall}")


if __name__ == "__main__":
    run_cli(main)
