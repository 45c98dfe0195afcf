"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload int8.b1-db --seed 7 --seconds 30 --trace 0

Prints diagnostics and each compared number beside its limit on standard
error, and one JSON object as the last line of standard output. Exits
non-zero, printing no result, without the CUDA devices the cell asks for,
when a run ends with JAX, the JAX package or the old benchmark loaded, or
when the program under test is not beside it.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "autostyle_tts_tpu", "chip_smoke", "benchmarks"}


def forbidden_modules() -> list:
    """Top-level names (before the first dot, compared whole) of loaded
    modules that no run may hold: JAX, the JAX package, the old benchmark."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"     # one host thread of work: no idle worker spins beside the serving loop
    sys.path.insert(0, str(ROOT))

    import torch

    torch.set_num_threads(1)

    from portbench.bench.harness import compared_lines, public, run_cell
    from portbench.bench.spec import Cell

    cell = Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules that no run may load are loaded: {bad}", file=sys.stderr)
        return 3
    for line in compared_lines(result["compared"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(public(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
