"""A new program and a new loop plug in as new files only: a copy of the
benchmark gains a toy program (one plain layer, its weights, its reference
and its numbers), a toy loop, a configuration, a mix, a metric and limits,
all as new files; ``run_cell`` runs the toy cell end to end in a fresh
process on that copy, and no file the copy already had changes."""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

TOY_PROGRAM = '''
"""A toy program: one plain layer y = tanh(x @ w), served a pair of rows at a time."""

import time

import numpy as np
import torch


def prepare(device):
    return {}


def specs(cfg):
    return {"w": ("normal", (cfg["dim"], cfg["dim"]), cfg["dim"] ** -0.5)}


def draw(cfg, seed, device):
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return {"w": torch.randn(cfg["dim"], cfg["dim"], generator=gen, device=device) * cfg["dim"] ** -0.5}


class _Flag:
    def __init__(self):
        self.on, self.spans = False, []

    def stopwatch(self):
        raise RuntimeError("the toy has no trace")


class Session:
    def __init__(self, cfg, mix, seed, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, int(seed), device
        self.w = draw(cfg, seed, device)["w"]
        self.taps, self.spans = _Flag(), _Flag()
        self.setup_times = {"weights": 0.0}
        self.served = 0

    def warm_up(self):
        torch.tanh(torch.zeros(1, self.cfg["dim"]) @ self.w)

    def requests(self):
        rng = np.random.default_rng([self.seed, 1])
        while True:
            yield rng.standard_normal(self.cfg["dim"]).astype(np.float32)

    def counters(self):
        return {"rows": self.served}

    def serve_pair(self, unit, j):
        t0 = time.perf_counter()
        x = torch.as_tensor(np.stack(unit), device=self.device)
        y = torch.tanh(x @ self.w).cpu().numpy()
        self.served += len(unit)
        time.sleep(0.01)
        return dict(i=j, t0=t0, t1=time.perf_counter(), useful_s=0.5 * len(unit), kept=dict(x=unit, y=y))

    def close(self):
        self.w = None


def reference_args(session):
    return {}


class Reference:
    def __init__(self, cfg, seed, device, control=False):
        self.w = draw(cfg, seed, device)["w"].double()
        self.control = control


def numbers(session, run, ref):
    err = 0.0
    for r in run.records:
        x = torch.as_tensor(np.stack(r["kept"]["x"])).double()
        want = torch.tanh(x @ ref.w)
        got = torch.tanh(x.half().double() @ ref.w.half().double()) if ref.control else torch.as_tensor(r["kept"]["y"])
        err = max(err, float((got - want).abs().max()))
    return {"max_err": err, "rows_off": float(run.counters["rows"] - 2 * len(run.records))}


def flops(cfg, rec):
    return 2.0 * len(rec["kept"]["x"]) * cfg["dim"] ** 2


def span_log():
    return None
'''

TOY_LOOP = '''
"""Requests served two at a time; the traced part is one pair."""

SERVES = "serve_pair"


def units(session):
    reqs = session.requests()
    while True:
        yield [next(reqs), next(reqs)]


def traced_enough(mix, traced):
    return len(traced) >= 1


def tally(run):
    return 2 * len(run.records), 2 * len(run.failures)
'''

TOY_METRIC = '''
"""Pairs served a second."""


def read(run):
    return len(run.records) / run.window_s
'''

RUN = '''
import json, sys, time
t = time.perf_counter()
sys.path.insert(0, sys.argv[1])
import portbench
assert portbench.__file__.startswith(sys.argv[1]), portbench.__file__
from portbench.bench.harness import public, run_cell
from portbench.bench.spec import Cell
bench = json.loads(sys.argv[2])
res = run_cell(Cell("toy.pairs", bench), 2 ** 31 + 77, 0.3, False, t, device="cpu")
print(json.dumps(public(res)))
'''


def digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_toy_program_and_loop_run_as_new_files(tmp_path):
    copy = tmp_path / "portbench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    before = digests(copy)
    new = {
        "programs/toy.py": TOY_PROGRAM,
        "loops/pairs.py": TOY_LOOP,
        "metrics/pairs_per_s.py": TOY_METRIC,
        "configs/toy.json": json.dumps({"name": "toy", "program": "toy", "dim": 16}),
        "workloads/pairs.json": json.dumps({"loop": "pairs", "trace": {"skip": 0}}),
        "limits/toy.pairs.json": json.dumps({"max_err": {"limit": 1e-5}, "rows_off": {"limit": 0}}),
    }
    for name, text in new.items():
        assert not (copy / name).exists(), name
        (copy / name).write_text(textwrap.dedent(text))
    bench = {
        "configs": [{"name": "toy", "file": "portbench/configs/toy.json"}],
        "workloads": [{"name": "toy.pairs", "config": "toy", "traffic": "pairs", "chips": 1}],
        "end_to_end": [{"name": "setup_s", "unit": "s"}, {"name": "audio_s_per_s", "unit": "s/s"},
                       {"name": "pairs_per_s", "unit": "1/s", "workloads": ["toy.pairs"]}],
        "per_layer": [],
    }
    out = subprocess.run([sys.executable, "-c", RUN, str(tmp_path), json.dumps(bench)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res
    assert res["attempted"] >= 2 and res["attempted"] % 2 == 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "audio_s_per_s", "pairs_per_s"}
    assert res["compared"] == {"max_err": {"value": res["compared"]["max_err"]["value"], "limit": 1e-5},
                               "rows_off": {"value": 0.0, "limit": 0.0}}
    after = digests(copy)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == set(new)
