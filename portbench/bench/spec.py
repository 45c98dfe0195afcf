"""``BENCHMARK.json`` and the files it names: a cell's configuration, its
traffic mix, its metrics and its limits, each found by name."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> Dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


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


def port_config(cfg: Dict):
    """The port's ``Config`` of a configuration file (its other keys ignored)."""
    from autostyle_tts_tpu_torch.utils.config import from_dict

    return from_dict(cfg)
