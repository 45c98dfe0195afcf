"""Run a function on ``n`` ranks of one machine: one spawned process each.

``launch(fn, n, *args)`` starts ``n`` processes (the ``spawn`` start
method: a fresh interpreter that imports torch and the module holding
``fn``, nothing of the caller's ``__main__`` state), each of which joins a
process group of ``n`` ranks through a rendezvous file
(``init_method="file://..."``, so concurrent launches never race on a TCP
port), runs ``fn(*args)`` and hands its return value back through a file.
Ranks may share one device: ``backend="gloo"`` takes CUDA tensors, so
every rank may build its mesh on the current card. ``fn`` builds its mesh
with ``parallel.make_mesh`` on the running process group, on the device
it names. A collective waits at most ``COLLECTIVE_TIMEOUT_S`` (the
process group's timeout).

Any rank that raises, exits or outlives ``join_s`` fails the launch: the
others are terminated and ``RuntimeError`` carries the first traceback.
``fn`` must be importable by name (a module-level function), and what it
returns picklable.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List

import torch
import torch.multiprocessing as mp

DEFAULT_JOIN_S = 600.0
COLLECTIVE_TIMEOUT_S = 120.0


def _worker(rank: int, n: int, rendezvous: str, out_dir: str, backend: str, threads: int, fn: Callable,
            args: tuple) -> None:
    import torch.distributed as dist

    torch.set_num_threads(threads)
    out = Path(out_dir) / f"rank{rank}.pkl"
    try:
        dist.init_process_group(backend, init_method=f"file://{rendezvous}", rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            result = ("ok", fn(*args))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - handed to the parent, which raises it
        result = ("error", traceback.format_exc())
    with open(out.with_suffix(".tmp"), "wb") as f:
        pickle.dump(result, f)
    os.replace(out.with_suffix(".tmp"), out)
    if result[0] == "error":
        raise SystemExit(1)


def launch(fn: Callable, n: int, *args, backend: str = "gloo", threads: int = 1,
           join_s: float = DEFAULT_JOIN_S) -> List[Any]:
    """``fn(*args)`` on ranks 0..n-1 -> their return values, in rank order;
    ``join_s`` bounds the whole launch."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="asttts_launch_") as tmp:
        rendezvous = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_worker, args=(r, n, rendezvous, tmp, backend, threads, fn, args),
                             daemon=False)
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + join_s
        timed_out = False
        try:
            while any(p.is_alive() for p in procs):
                if any(not p.is_alive() and p.exitcode != 0 for p in procs):
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        results, errors = [], []
        for r, p in enumerate(procs):
            path = Path(tmp) / f"rank{r}.pkl"
            if not path.exists():
                why = f"stopped at the {join_s:.0f} s limit" if timed_out else f"exit code {p.exitcode}"
                errors.append(f"rank {r}: {why}, no result")
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status == "error":
                errors.insert(0, f"rank {r}:\n{value}")
            results.append(value)
        if errors:
            raise RuntimeError(f"launch of {getattr(fn, '__name__', fn)} over {n} ranks failed:\n"
                               + "\n".join(errors))
        return results
