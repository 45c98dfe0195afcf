"""Readings for the limits of a cell's correctness check: for each seed,
one run of the program at the cell's own load (a short window, no
warm-up) and every compared number of the program and, with
``--control 1``, of the control (the reference one precision step below
what the configuration states, put in the program's place on the same
inputs). Never run by the benchmark's runs.

    python3 portbench/calibrate.py --workload int8.b1-db --seeds 1,2,3 --seconds 8 --control 1

One JSON line a seed on standard output (and appended to ``--out``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, seconds: float, control: bool, device="cuda") -> dict:
    from portbench.bench.harness import run_cell
    from portbench.bench.spec import program_of

    t0 = time.perf_counter()
    res = run_cell(cell, seed, seconds, False, t0, device=device)
    out = {"workload": cell.name, "seed": seed, "program": res["_nums"], "correct": res["correct"],
           "requests": res["attempted"], "seconds": time.perf_counter() - t0}
    if control:
        program = program_of(cell.cfg)
        ref = program.Reference(cell.cfg, seed, device, control=True, **program.reference_args(res["_session"]))
        out["control"] = program.numbers(res["_session"], res["_run"], ref)
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.bench.spec import Cell

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    for s in args.seeds.split(","):
        rec = readings(cell, int(s), args.seconds, bool(args.control))
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
