"""Base-model ERC eval: generation-based weighted F1 of the embedder
without an adapter on a chat-format test JSONL (--language picks the label
set). Counterpart of the JAX ``cli/evaluate_base_model.py``; runs on the
card unless --device cpu. The base is drawn from --seed, or loaded from
--embedder_checkpoint (a flat-key .npz of either package)."""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..models import transformer as core
from ..train import lora_sft, reformat
from ..utils import rng
from ..utils.checkpoint import load_pytree
from ..utils.device import resolve_device
from ..utils.manifest import read_jsonl
from .common import add_common_args, build_config, check_single_device


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--test_jsonl", type=str, required=True)
    p.add_argument("--language", type=str, default="en", choices=["en", "zh"])
    p.add_argument("--embedder_checkpoint", type=str, default=None)
    p.add_argument("--output_file", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=8)
    args = p.parse_args(argv)

    check_single_device(args)
    ecfg = build_config(args).embedder
    dev = resolve_device(args.device)
    params = core.init_params(ecfg, rng.PRNGKey(args.seed, dev))
    if args.embedder_checkpoint:
        params = load_pytree(args.embedder_checkpoint, params)
    samples = read_jsonl(args.test_jsonl)
    labels = reformat.label_set(args.language)
    f1, preds = lora_sft.evaluate_generation(params, ecfg, samples, labels, batch_size=args.batch_size)
    print(f"weighted_f1={f1:.4f} over {len(samples)} samples")
    if args.output_file:
        Path(args.output_file).parent.mkdir(parents=True, exist_ok=True)
        with open(args.output_file, "w", encoding="utf-8") as f:
            json.dump({"weighted_f1": f1, "predictions": preds,
                       "references": [s["messages"][-1]["content"] for s in samples]},
                      f, ensure_ascii=False, indent=2)
        print(f"wrote predictions -> {args.output_file}")


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
