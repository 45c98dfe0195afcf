"""Export an engine weight snapshot (flat-key .npz, the JAX package's
format): from a fresh init drawn from --seed or from --checkpoint, for any
--config / --set geometry, with --stage_ckpt merging the latest checkpoint
of a ``train_acoustic`` stage (of either package) into it. Every synthesis
CLI of either package loads the snapshot through --checkpoint. Counterpart
of the JAX ``cli/export_engine.py``; runs on the card unless --device cpu."""

from __future__ import annotations

import argparse

from ..utils.device import resolve_device
from .common import add_common_args, build_config, build_mesh, engine_params, save_engine_checkpoint

MERGED_STAGES = ("tokenizer", "token_lm", "cfm", "vocoder")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--output", type=str, required=True, help="snapshot .npz path")
    p.add_argument("--stage_ckpt", action="append", default=[], metavar="STAGE=DIR",
                   help="merge a train_acoustic checkpoint dir into the engine snapshot; STAGE in "
                        + "|".join(MERGED_STAGES) + " (repeatable)")
    args = p.parse_args(argv)
    from ..pipeline.engine import Engine
    from ..utils.checkpoint import CheckpointManager

    cfg = build_config(args)
    dev = resolve_device(args.device)
    mesh = build_mesh(args, dev)
    dev = dev if mesh is None else mesh.device
    params = engine_params(args, cfg, dev)
    for spec in args.stage_ckpt:
        stage, _, ckpt_dir = spec.partition("=")
        if stage not in MERGED_STAGES:
            raise SystemExit(f"unknown stage in --stage_ckpt: {spec!r}")
        mgr = CheckpointManager(ckpt_dir)
        if stage == "tokenizer":    # the stage's phoneme head is left out of the engine
            params.speech_tokenizer = mgr.restore({"tok": params.speech_tokenizer})["tok"]
        else:
            setattr(params, stage, mgr.restore(getattr(params, stage)))
        print(f"merged {stage} <- {ckpt_dir} (step {mgr.latest_step()})")
    # the snapshot holds the merged weights as the engine built from them serves them
    save_engine_checkpoint(Engine(cfg, params=params, seed=args.seed, device=dev, mesh=mesh), args.output)
    print(f"engine params -> {args.output}")


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
