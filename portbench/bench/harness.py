"""One run of one cell: the program's set-up and warm-up, the window, the
metrics, then the correctness check once the program's state is freed.
The program (``programs/<kind>.py``) and the loop (``loops/<kind>.py``)
are found by the configuration's and the mix's names for them."""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict

import numpy as np
import torch

from . import host
from .readers import reader
from .spec import loop_of, program_of
from .window import measure


def run_cell(cell, seed: int, seconds: float, trace: bool, t_process: float, device="cuda") -> Dict:
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    program = program_of(cell.cfg)
    t0 = time.perf_counter()
    split = {"start": t0 - t_process}        # imports, argument parsing
    if on_card:
        torch.empty(0, device=dev)
        torch.cuda.synchronize(dev)
        split["cuda_context"] = time.perf_counter() - t0
    split.update(program.prepare(dev))
    sess = program.Session(cell.cfg, cell.mix, seed, dev)
    split.update(sess.setup_times)
    t2 = time.perf_counter()
    sess.warm_up()
    split["warm_up"] = time.perf_counter() - t2
    gc.collect()
    gc.freeze()      # set-up's objects out of the collector's way: no long pause inside the window
    if trace:
        with sess.spans.stopwatch():
            run = measure(sess, seconds, t_process, trace=True)
    else:
        run = measure(sess, seconds, t_process, trace=False)
    gc.unfreeze()
    run.program = program
    run.host["gpu"] = host.gpu_state() if on_card else {}     # the card's clocks as the window closed
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    args = program.reference_args(sess)
    sess.close()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = program.Reference(cell.cfg, seed, dev, **args)
    nums = program.numbers(sess, run, ref)
    compared = compare(nums, cell.limits())
    attempted, failed = loop_of(cell.mix).tally(run)
    print(f"portbench: {cell.name} seed {seed}: {attempted} requests, {failed} failed, "
          f"window {run.window_s:.3f} s, setup {run.setup_s:.3f} s", file=sys.stderr)
    for line in getattr(program, "describe", lambda r: [])(run):
        print(f"portbench: {line}", file=sys.stderr)
    split = {k: (round(v, 4) if isinstance(v, float) else v) for k, v in split.items()}
    print(f"portbench: setup split (s): {split}", file=sys.stderr)
    print(f"portbench: host over the window: {run.host}", file=sys.stderr)
    print(f"portbench: program counters over the window: {run.counters}", file=sys.stderr)
    for f in run.failures[:5]:
        print(f"portbench: failed: {f}", file=sys.stderr)
    result = {
        "correct": bool(passed(compared) and not run.failures),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)},
    }
    if trace and run.trace is not None:
        result["device"].update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
        result["breakdown"] = {"device_ops": run.trace["device_ops"], "idle_gaps": run.trace["idle_gaps"]}
    result["setup_split"] = split
    result["host"] = run.host
    result["compared"] = compared
    result["_run"] = run
    result["_nums"] = nums
    result["_session"] = sess
    return result


def compare(nums: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each number beside its limit; a number without a limit, or a
    limit without its number, fails."""
    names = sorted(set(nums) | set(limits))
    return {n: {"value": nums.get(n), "limit": limits.get(n)} for n in names}


def passed(compared: Dict[str, Dict]) -> bool:
    return all(v["value"] is not None and v["limit"] is not None and np.isfinite(v["value"])
               and v["value"] <= v["limit"] for v in compared.values())


def public(result: Dict) -> Dict:
    """The result line: every key but the run's internals, ``compared`` last."""
    out = {k: v for k, v in result.items() if not k.startswith("_") and k != "compared"}
    out["compared"] = result["compared"]
    return out


def compared_lines(compared: Dict) -> list:
    return [f"compared {n}: {v['value']!r} limit {v['limit']!r}" for n, v in compared.items()]
