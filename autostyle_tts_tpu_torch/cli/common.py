"""Shared CLI plumbing: config and override flags, the engine builder and
its weight snapshots, result-dir conventions.

Counterpart of the JAX ``cli/common.py``. Every CLI takes:
  --config cfg.json          load a Config tree
  --set section.field=value  dotted overrides (repeatable)
  --checkpoint FILE          engine weights (flat-key .npz, ``weights.load_tree``)
  --tiny / --demo            small geometries
  --device DEV               ``cuda`` by default; ``cpu`` runs the plain versions
  --dp N / --tp M            an engine on a device mesh of N x M ranks, one
                             process each: ``torchrun --nproc_per_node N*M -m
                             autostyle_tts_tpu_torch.cli.<name> ... --dp N --tp M``
                             (rank r on card r, NCCL; on the CPU, or with more
                             ranks than cards, gloo); rank 0 alone writes the
                             result files and prints the result lines
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
                   help="print the last request's per-stage milliseconds and its span tree at exit")
    p.add_argument("--dp", type=int, default=0,
                   help="shard request batches over N ranks (data axis); 0 = one process")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree (model axis); ranks used = max(dp, 1) * tp")
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


def mesh_shape(args):
    return max(int(getattr(args, "dp", 0) or 0), 1), int(getattr(args, "tp", 1) or 1)


def refuse_mesh(args) -> None:
    """The CLIs that run on one device (the embedder's: their JAX
    counterparts take no mesh for it) refuse ``--dp`` / ``--tp``."""
    dp, tp = mesh_shape(args)
    if dp * tp > 1:
        raise ValueError("--dp / --tp: this CLI runs on one device (the embedder takes no mesh)")


def build_mesh(args, dev: torch.device):
    """The (dp, tp) mesh over ``torchrun``'s ranks, or None for one process.
    ``WORLD_SIZE`` must be ``max(dp, 1) * tp``; rank r takes card
    ``LOCAL_RANK`` modulo the cards (NCCL), or the CPU, or with more ranks
    than cards shares them (gloo). Every rank but 0 prints nothing."""
    from ..parallel.mesh import make_mesh

    dp, tp = mesh_shape(args)
    n = dp * tp
    if n == 1:
        return None
    world = os.environ.get("WORLD_SIZE")
    if world is None:
        raise ValueError(f"--dp {dp} --tp {tp} runs one process a rank: torchrun --nproc_per_node {n} "
                         f"-m autostyle_tts_tpu_torch.cli.<name> ... --dp {dp} --tp {tp}")
    if int(world) != n:
        raise ValueError(f"WORLD_SIZE={world}, but --dp {dp} --tp {tp} needs {n} ranks")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % cards)
        backend = "nccl" if n <= cards else "gloo"
    else:
        backend = "gloo"
    mesh = make_mesh(dp, tp, device=dev, backend=backend)
    if mesh.rank != 0:
        sys.stdout = open(os.devnull, "w")
    return mesh


def is_main() -> bool:
    """Rank 0 of a mesh, or the one process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


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

    cfg = build_config(args)
    dev = resolve_device(args.device)
    mesh = build_mesh(args, dev)
    params = engine_params(args, cfg, dev) if args.checkpoint else None
    engine = Engine(cfg, params=params, seed=args.seed, device=None if mesh else dev, mesh=mesh)
    if getattr(args, "profile", False):
        atexit.register(print_profile, engine)
    return engine


def print_profile(engine) -> None:
    """``--profile``: the last request's stage milliseconds, then its span
    tree (``utils/timing.py``: ms, self, host and wait ms, counters, the
    decode ``path``), then the process's last DB search (its ``rows``, ``k``
    and ``queries``) where it made one."""
    from ..utils.timing import format_tree, spans

    print("\n-- last request's stage timing (ms) --\n" + json.dumps(engine.last_timings))
    print("-- last request's spans (ms) --\n" + format_tree(engine.last_trace))
    searches = [s for s in spans() if s.name == "db_search"]
    if searches:
        print("-- last DB search (ms) --\n" + format_tree(searches[-1:]))


def build_training_engine(args):
    """(Engine, its f32 ``EngineParams``) for the training CLIs: the engine
    featurizes the data; the trainers update the f32 weights (the token LM's
    masters, never the copy the engine serves, which is bf16 or int8)."""
    from ..pipeline.engine import Engine

    cfg = build_config(args)
    dev = resolve_device(args.device)
    mesh = build_mesh(args, dev)
    params = engine_params(args, cfg, dev if mesh is None else mesh.device)
    return Engine(cfg, params=params, seed=args.seed, device=None if mesh else dev, mesh=mesh), params


def save_engine_checkpoint(engine, path: str) -> None:
    """The engine's weights as served, in the JAX package's flat-key
    ``.npz`` (``utils/checkpoint.py``), so a snapshot exported by either
    package loads into the other through ``--checkpoint``. A dense token
    LM's projections and speech head are written at the bf16 values the
    port serves them with (as f32); an int8 LM as ``q`` / ``s`` pairs.
    Under a mesh the cut weights are gathered and rank 0 writes."""
    from ..weights import save_tree

    tree = engine.full_tree()
    if is_main():
        save_tree(path, tree)


def timestamped_dir(base: str) -> Path:
    """A fresh result directory under ``base``, named by the time."""
    d = Path(base) / datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    d.mkdir(parents=True, exist_ok=True)
    return d


def read_lines(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


def save_wav(path, wav: np.ndarray, engine) -> None:
    """Save at the engine's output rate (rank 0 alone under a mesh)."""
    from ..utils.audio_io import write_wav

    if is_main():
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
