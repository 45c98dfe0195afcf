"""What the machine around the run did over the window, to tell a slow
host from a slow program: this process's CPU time, the machine's busy
and stolen CPU time (``/proc/stat``), the load average, and the card's
clocks, temperature and power (``nvidia-smi``) at the window's end.
Printed on standard error and kept in the result line; no metric reads it.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Dict, Optional

GPU_FIELDS = ("clocks.sm", "clocks.max.sm", "clocks.mem", "temperature.gpu", "power.draw", "power.limit")


def _proc_stat() -> Optional[list]:
    """The machine's aggregate CPU jiffies: user, nice, system, idle,
    iowait, irq, softirq, steal (None where there is no /proc/stat)."""
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return None


def snapshot() -> Dict:
    t = os.times()
    return {"wall": time.perf_counter(), "proc_cpu": t.user + t.system, "stat": _proc_stat(),
            "load1": os.getloadavg()[0]}


def over(a: Dict, b: Dict) -> Dict:
    """The window between two snapshots: this process's CPU seconds over
    the wall seconds (1.0 = one core all the time); the machine's busy
    cores (all processes, this one included), its steal and iowait as
    shares of all its CPU time; the load average at both ends."""
    wall = b["wall"] - a["wall"]
    out = {"proc_cores": round((b["proc_cpu"] - a["proc_cpu"]) / wall, 4) if wall > 0 else None,
           "load1": [round(a["load1"], 2), round(b["load1"], 2)], "cpus": os.cpu_count()}
    if a["stat"] and b["stat"]:
        d = [y - x for x, y in zip(a["stat"], b["stat"])]
        total = sum(d)
        if total > 0:
            idle = d[3] + d[4]
            out.update(machine_cores=round((total - idle - d[7]) / total * os.cpu_count(), 4),
                       steal_pct=round(100.0 * d[7] / total, 4), iowait_pct=round(100.0 * d[4] / total, 4))
    return out


def gpu_state() -> Dict:
    """The card's clocks (MHz), temperature (C) and power (W) now; {} where
    ``nvidia-smi`` is missing or fails."""
    try:
        p = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(GPU_FIELDS)}", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return {}
    if p.returncode != 0 or not p.stdout.strip():
        return {}
    vals = [v.strip() for v in p.stdout.strip().splitlines()[0].split(",")]
    out = {}
    for k, v in zip(GPU_FIELDS, vals):
        try:
            out[k] = float(v)
        except ValueError:
            out[k] = v
    return out
