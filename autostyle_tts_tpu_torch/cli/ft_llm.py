"""LoRA ERC fine-tune of the style embedder (the reference's QLoRA recipe:
r=32 alpha=128 all-linear, bs 4 x grad-accum 4, lr 3e-4 linear, 3 epochs,
NEFTune 5, eval/save every 50 steps, the best adapter by generation-based
weighted F1, a multi-seed sweep; --language picks the label set).
Counterpart of the JAX ``cli/ft_llm.py``; runs on the card unless
--device cpu.

--re_gen_data reformats the raw conversation JSONs first
(``train/reformat.py``). --quantize_base draws the frozen base as int8
(layer at a time, ``transformer.init_params_quantized``) with f32 LoRA
pairs; the int4 base is not ported (ROADMAP.md: queue A item 11)."""

from __future__ import annotations

import argparse
import dataclasses
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
    p.add_argument("--data_folder", type=str, required=True)
    p.add_argument("--data_name", type=str, default="iemocap")
    p.add_argument("--language", type=str, default="en", choices=["en", "zh"])
    p.add_argument("--prompting_type", type=str, default="default", choices=["default", "spdescV2"])
    p.add_argument("--window", type=int, default=5)
    p.add_argument("--re_gen_data", action="store_true")
    p.add_argument("--out_dir", type=str, default="./finetuned_llm")
    p.add_argument("--seeds", type=int, nargs="+", default=None, help="multi-seed sweep")
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_eval_dev", action="store_true")
    p.add_argument("--do_eval_test", action="store_true")
    p.add_argument("--embedder_checkpoint", type=str, default=None)
    p.add_argument("--quantize_base", action="store_true",
                   help="int8 frozen base + f32 LoRA (the reference's QLoRA stance)")
    args = p.parse_args(argv)

    check_single_device(args)
    cfg = build_config(args)
    dev = resolve_device(args.device)
    folder = Path(args.data_folder)

    def jsonl_path(split: str) -> Path:
        return Path(reformat.default_output_path(str(folder / f"{args.data_name}.{split}.json"), args.window,
                                                 args.prompting_type))

    if args.re_gen_data:
        for split in ("train", "valid", "test"):
            src = folder / f"{args.data_name}.{split}.json"
            if not src.exists():
                print(f"skip {split}: {src} missing")
                continue
            bios = None
            if args.prompting_type == "spdescV2":
                cand = sorted(folder.glob(f"{args.data_name}.{split}_spdescV2_*.json"))
                bios = str(cand[0]) if cand else None
            n = reformat.process_dataset(str(src), str(jsonl_path(split)), window=args.window,
                                         mode=args.prompting_type, language=args.language, bios_json=bios)
            print(f"reformatted {split}: {n} samples -> {jsonl_path(split)}")

    ecfg = cfg.embedder
    key = rng.PRNGKey(args.seed, dev)
    params = (core.init_params_quantized(ecfg, key, bits=8) if args.quantize_base
              else core.init_params(ecfg, key))
    if args.embedder_checkpoint:
        params = load_pytree(args.embedder_checkpoint, params)
    labels = reformat.label_set(args.language)

    summary = {}
    for seed in args.seeds or [args.seed]:
        tcfg = dataclasses.replace(cfg.train, seed=seed)
        run_dir = f"{args.out_dir}/seed{seed}"
        if args.do_train:
            eval_path = jsonl_path("valid")
            res = lora_sft.train(params, ecfg, tcfg, read_jsonl(jsonl_path("train")),
                                 eval_samples=read_jsonl(eval_path) if eval_path.exists() else None,
                                 labels=labels, out_dir=run_dir)
            summary[seed] = {"best_f1": res["best_f1"], "steps": res["steps"]}
            print(f"seed {seed}: best_f1={res['best_f1']:.4f} steps={res['steps']}")
        for flag, split in ((args.do_eval_dev, "valid"), (args.do_eval_test, "test")):
            if not flag or not jsonl_path(split).exists():
                continue
            lora, lscale = None, 0.0
            best = Path(run_dir) / "best.npz"
            if best.exists():    # the best adapter by F1
                like = core.init_lora(ecfg, tcfg.lora.r, rng.PRNGKey(0, dev))
                lora, lscale = load_pytree(best, like), tcfg.lora.alpha / tcfg.lora.r
            f1, _ = lora_sft.evaluate_generation(params, ecfg, read_jsonl(jsonl_path(split)), labels, lora=lora,
                                                 lora_scale=lscale)
            print(f"seed {seed} {split} weighted_f1={f1:.4f}")
            summary.setdefault(seed, {})[f"{split}_f1"] = f1
    Path(args.out_dir).mkdir(parents=True, exist_ok=True)
    with open(f"{args.out_dir}/summary.json", "w") as f:
        json.dump(summary, f, indent=2)


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
