"""``BENCHMARK.json`` and the files it names: a cell's configuration, its
traffic mix, its metrics and its limits, each found by name; and the
program a configuration drives and the loop a mix runs, each found by file
(``programs/<kind>.py``, ``loops/<kind>.py``)."""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
DEFAULT_PROGRAM = "tts"


def load_json(path: Path) -> Dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _module(folder: str, kind: str) -> ModuleType:
    if not kind.isidentifier() or not (BENCH_DIR / folder / f"{kind}.py").exists():
        raise SystemExit(f"portbench: no {folder}/{kind}.py")
    return importlib.import_module(f"{BENCH_DIR.name}.{folder}.{kind}")


def program_of(cfg: Dict) -> ModuleType:
    """The program module a configuration file names (``"program"``)."""
    return _module("programs", cfg.get("program", DEFAULT_PROGRAM))


def loop_of(mix: Dict) -> ModuleType:
    """The loop module a traffic mix names (``"loop"``)."""
    return _module("loops", mix["loop"])


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, name: str, bench: Optional[Dict] = None):
        bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = found[0]
        conf = [c for c in bench["configs"] if c["name"] == self.entry["config"]][0]
        self.cfg = load_json(ROOT / conf["file"])
        self.mix = load_json(BENCH_DIR / "workloads" / f"{self.entry['traffic']}.json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = self._metrics(bench["end_to_end"])
        self.per_layer = self._metrics(bench["per_layer"])
        self.bench = bench

    def _metrics(self, entries: List[Dict]) -> List[Dict]:
        return [m for m in entries if "workloads" not in m or self.name in m["workloads"]]

    def limits(self) -> Dict[str, float]:
        path = BENCH_DIR / "limits" / f"{self.name}.json"
        return {k: float(v["limit"]) for k, v in load_json(path).items()} if path.exists() else {}
