"""One run of one cell: set-up, warm-up, the window, the metrics, then the
correctness check once the program's state is freed."""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict

import torch

from . import check, host
from .readers import reader
from .serve import Session
from .window import measure

FORBIDDEN = {"jax", "jaxlib", "flax", "autostyle_tts_tpu", "chip_smoke", "benchmarks"}


def forbidden_modules() -> list:
    """Top-level names (before the first dot, compared whole) of loaded
    modules that no run may hold: JAX, the JAX package, the old benchmark."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def run_cell(cell, seed: int, seconds: float, trace: bool, t_process: float, device="cuda") -> Dict:
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    split = {"start": t0 - t_process}        # imports, argument parsing
    if on_card:
        from autostyle_tts_tpu_torch.ops import cuda_build

        torch.empty(0, device=dev)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        split["cuda_context"] = t1 - t0
        built = cuda_build.build()           # all the port's kernels at once: nvcc only where a library is missing
        split["kernel_builds"] = time.perf_counter() - t1
        split["compiled"] = sorted(built)
    sess = Session(cell.cfg, cell.mix, seed, dev)
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
    run.host["gpu"] = host.gpu_state() if on_card else {}     # the card's clocks as the window closed
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    path = check.decode_path(sess)
    sess.close()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = check.Reference(cell.cfg, seed, dev, **path)
    nums = check.numbers(sess, run, ref)
    limits = cell.limits()
    compared = check.compare(nums, limits)
    rows = [r for r in run.records if not r.get("failed")]
    targets = [t for r in rows for t in (r["targets"] if "targets" in r else [r["target"]])]
    lens = [g for r in rows for g in (r["gen_lens"] if "gen_lens" in r else [r["gen_len"]])]
    early = sum(1 for g, t in zip(lens, targets) if g < t)
    attempted = len(targets) + len(run.failures) * cell.mix["batch"]
    print(f"portbench: {cell.name} seed {seed}: {attempted} requests, {len(run.failures)} failed, "
          f"{early} drew EOS before their target ({100.0 * early / max(len(lens), 1):.1f}%), "
          f"window {run.window_s:.3f} s, setup {run.setup_s:.3f} s", file=sys.stderr)
    split = {k: (round(v, 4) if isinstance(v, float) else v) for k, v in split.items()}
    print(f"portbench: setup split (s): {split}", file=sys.stderr)
    print(f"portbench: host over the window: {run.host}", file=sys.stderr)
    print(f"portbench: decode-step launches in the window by width: {run.launches}", file=sys.stderr)
    for f in run.failures[:5]:
        print(f"portbench: failed: {f}", file=sys.stderr)
    result = {
        "correct": bool(check.passed(compared) and not run.failures),
        "attempted": attempted,
        "failed": len(run.failures) * cell.mix["batch"],
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


def public(result: Dict) -> Dict:
    """The result line: every key but the run's internals, ``compared`` last."""
    out = {k: v for k, v in result.items() if not k.startswith("_") and k != "compared"}
    out["compared"] = result["compared"]
    return out


def compared_lines(compared: Dict) -> list:
    return [f"compared {n}: {v['value']!r} limit {v['limit']!r}" for n, v in compared.items()]
