"""Shared CLI plumbing: config and override flags, the engine builder and
its weight snapshots, result-dir conventions.

Counterpart of the JAX ``cli/common.py``. Every CLI takes:
  --config cfg.json          load a Config tree
  --set section.field=value  dotted overrides (repeatable)
  --checkpoint FILE          engine weights (flat-key .npz, ``weights.load_tree``)
  --tiny / --demo            small geometries
  --device DEV               ``cuda`` by default; ``cpu`` runs the plain versions
"""

from __future__ import annotations

import argparse
import atexit
import datetime
import json
import os
import sys
from pathlib import Path
from typing import List

import numpy as np
import torch

from ..utils import config as config_lib
from ..utils.device import resolve_device


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", type=str, default=None, help="Config JSON path")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="dotted config override (repeatable)")
    p.add_argument("--checkpoint", type=str, default=None, help="engine weights (.npz)")
    p.add_argument("--tiny", action="store_true", help="tiny test geometry")
    p.add_argument("--demo", action="store_true", help="demo geometry (~15M-parameter stack)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--profile", action="store_true",
                   help="print the last request's per-stage milliseconds at exit")
    p.add_argument("--dp", type=int, default=0, help="data-parallel devices (one card: 0 or 1)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel degree (one card: 1)")
    add_device_arg(p)


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card (cpu: the plain PyTorch path)")


def build_config(args) -> config_lib.Config:
    cfg = (config_lib.tiny_config() if args.tiny
           else config_lib.demo_config() if getattr(args, "demo", False)
           else config_lib.load(args.config) if args.config
           else config_lib.Config())
    if args.overrides:
        config_lib.apply_overrides(cfg, args.overrides)
    return cfg


def check_single_device(args) -> None:
    if int(getattr(args, "dp", 0) or 0) > 1 or int(getattr(args, "tp", 1) or 1) > 1:
        raise NotImplementedError("--dp / --tp above 1 need a device mesh, which the port does not have "
                                  "(ROADMAP.md: queue A item 11)")


def engine_params(args, cfg, dev):
    """The f32 weights an engine is built from: drawn from ``--seed`` (the
    draw ``Engine`` makes itself) or ``--checkpoint`` loaded into that
    structure."""
    from ..pipeline.engine import EngineParams
    from ..weights import load_tree

    init = EngineParams.init(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    return EngineParams.from_tree(load_tree(args.checkpoint, init.tree())) if args.checkpoint else init


def build_engine(args):
    """The port's Engine on ``--device``, with ``--checkpoint`` weights."""
    from ..pipeline.engine import Engine

    check_single_device(args)
    cfg = build_config(args)
    dev = resolve_device(args.device)
    params = engine_params(args, cfg, dev) if args.checkpoint else None
    engine = Engine(cfg, params=params, seed=args.seed, device=dev)
    if getattr(args, "profile", False):
        atexit.register(lambda: print("\n-- last request's stage timing (ms) --\n"
                                      + json.dumps(engine.last_timings)))
    return engine


def build_training_engine(args):
    """(Engine, its f32 ``EngineParams``) for the training CLIs: the engine
    featurizes the data; the trainers update the f32 weights (the token LM's
    masters, never the copy the engine serves, which is bf16 or int8)."""
    from ..pipeline.engine import Engine

    check_single_device(args)
    cfg = build_config(args)
    dev = resolve_device(args.device)
    params = engine_params(args, cfg, dev)
    return Engine(cfg, params=params, seed=args.seed, device=dev), params


def save_engine_checkpoint(engine, path: str) -> None:
    """The engine's weights as served, in the JAX package's flat-key
    ``.npz`` (``utils/checkpoint.py``), so a snapshot exported by either
    package loads into the other through ``--checkpoint``. A dense token
    LM's projections and speech head are written at the bf16 values the
    port serves them with (as f32); an int8 LM as ``q`` / ``s`` pairs."""
    from ..weights import save_tree

    save_tree(path, engine.params.tree())


def timestamped_dir(base: str) -> Path:
    """A fresh result directory under ``base``, named by the time."""
    d = Path(base) / datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    d.mkdir(parents=True, exist_ok=True)
    return d


def read_lines(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


def save_wav(path, wav: np.ndarray, engine) -> None:
    """Save at the engine's output rate."""
    from ..utils.audio_io import write_wav

    write_wav(path, wav, engine.cfg.audio.sample_rate)


def run_cli(main_fn) -> None:
    """``__main__`` wrapper: a failure prints one ``error:`` line and exits
    1 (``ASTTTS_DEBUG=1`` re-raises). Callers of ``main()`` get the
    exception itself."""
    try:
        main_fn()
    except KeyboardInterrupt:
        sys.exit(130)
    except Exception as e:  # noqa: BLE001 — terminal boundary
        if os.environ.get("ASTTTS_DEBUG") == "1":
            raise
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
