"""Export an engine weight snapshot (flat-key .npz, the JAX package's
format): from a fresh init drawn from --seed or from --checkpoint, for any
--config / --set geometry. Every synthesis CLI of either package loads it
through --checkpoint. Counterpart of the JAX ``cli/export_engine.py``;
runs on the card unless --device cpu. Its --stage_ckpt (merging a training
checkpoint) needs the training stack, not ported yet (ROADMAP.md: queue A
item 10)."""

from __future__ import annotations

import argparse

from .common import add_common_args, build_engine, save_engine_checkpoint


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--output", type=str, required=True, help="snapshot .npz path")
    p.add_argument("--stage_ckpt", action="append", default=[], metavar="STAGE=DIR",
                   help="merge a train_acoustic checkpoint (not ported yet: ROADMAP.md queue A item 10)")
    args = p.parse_args(argv)
    if args.stage_ckpt:
        raise NotImplementedError("--stage_ckpt needs the training stack, not ported yet "
                                  "(ROADMAP.md: queue A item 10)")
    engine = build_engine(args)
    save_engine_checkpoint(engine, args.output)
    print(f"engine params -> {args.output}")


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
