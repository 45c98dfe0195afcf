"""Ingest/convert a CosyVoice-300M release directory.

  # audit: dump every artifact's tensor names + shapes
  python -m autostyle_tts_tpu_torch.cli.convert_cosyvoice \\
      --model_dir /path/CosyVoice-300M --inventory --report_json inv.json

  # convert with the built-in rule tables (or --rules rules.json) into a
  # CosyEngine snapshot, checked by loading it on --device
  python -m autostyle_tts_tpu_torch.cli.convert_cosyvoice \\
      --model_dir ... --strict --output engine.npz [--device cpu]

Counterpart of the JAX ``cli/convert_cosyvoice.py``; the snapshot format is
the same, so either package loads the other's. Reads torch ``.pt`` state
dicts and ONNX weights (``utils/onnx_load.py``, no onnx package);
``campplus.onnx`` is carried by graph, not converted.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..utils import cosyvoice_convert as cc
from .common import add_device_arg


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_dir", type=str, required=True)
    p.add_argument("--inventory", action="store_true",
                   help="dump tensor names/shapes for every artifact")
    p.add_argument("--rules", type=str, default=None,
                   help="JSON rule table {artifact: [{src,dst,transform,"
                        "fuse,fuse_axis}]} overriding the built-ins")
    p.add_argument("--report_json", type=str, default=None)
    p.add_argument("--strict", action="store_true",
                   help="fail if any source tensor is unmapped")
    p.add_argument("--output", type=str, default=None,
                   help="write a CosyEngine .npz snapshot of the converted "
                        "trees (models/compat)")
    add_device_arg(p)     # where the snapshot's load check puts the engine
    args = p.parse_args(argv)

    if args.inventory:
        inv = cc.inventory(args.model_dir)
        text = json.dumps(inv, indent=2)
        if args.report_json:
            Path(args.report_json).write_text(text)
        n = sum(len(v) for v in inv.values())
        print(f"{len(inv)} artifacts, {n} tensors"
              + (f" -> {args.report_json}" if args.report_json else ""))
        if not args.report_json:
            print(text)
        return

    rulesets = dict(cc.RULESETS)
    if args.rules:
        raw = json.loads(Path(args.rules).read_text())
        for artifact, rules in raw.items():
            rulesets[artifact] = [cc.Rule(**r) for r in rules]
    reports = {}
    trees = {}
    for artifact, rules in rulesets.items():
        path = Path(args.model_dir) / artifact
        if not path.exists():
            continue
        tree, report = cc.apply_rules(cc.load_artifact(path), rules)
        trees[artifact] = tree
        reports[artifact] = report.__dict__
        print(f"{artifact}: mapped={len(report.mapped)} "
              f"unmapped={len(report.unmapped_src)}")
        if args.strict and report.unmapped_src:
            raise SystemExit(
                f"{artifact}: unmapped tensors: {report.unmapped_src[:10]}..."
            )
    # campplus.onnx converts by GRAPH, not by rule table (its D-TDNN
    # initializer names are not blind-reconstructible): the node graph is
    # carried verbatim into the snapshot and run op by op by ops/onnx_exec
    # (models/compat/campplus.py).
    camp_path = Path(args.model_dir) / "campplus.onnx"
    if camp_path.exists():
        from ..ops import onnx_exec
        from ..utils.onnx_load import load_onnx_graph

        raw_bytes = camp_path.read_bytes()
        graph = load_onnx_graph(raw_bytes)
        bad = onnx_exec.unsupported_ops(graph)
        reports["campplus.onnx"] = {
            "mode": "graph-executed",
            "ops": onnx_exec.op_histogram(graph),
            "unsupported_ops": bad,
            "n_initializers": len(graph.initializers),
            "inputs": graph.inputs, "outputs": graph.outputs,
        }
        print(f"campplus.onnx: graph-executed, {len(graph.nodes)} nodes, "
              f"unsupported={bad or 'none'}")
        if args.strict and bad:
            raise SystemExit(
                f"campplus.onnx: unsupported ops {bad} — extend "
                f"ops/onnx_exec.OPS"
            )
        if not bad:
            trees["campplus.onnx"] = {
                "__onnx__": np.frombuffer(raw_bytes, np.uint8)
            }
    if args.report_json:
        Path(args.report_json).write_text(json.dumps(reports, indent=2))
    if not reports:
        print("no rule tables matched any artifact — run --inventory first "
              "and author rules (utils/cosyvoice_convert.py docstring)")
    if args.output:
        if not {"llm.pt", "flow.pt", "hift.pt"} <= set(trees):
            raise SystemExit(
                "--output needs llm.pt + flow.pt + hift.pt converted; got "
                f"{sorted(trees)}"
            )
        from ..models.compat.engine import CosyEngine, save_snapshot

        save_snapshot(args.output, trees)
        # load check: the snapshot round-trips into an engine on --device
        CosyEngine.load(args.output, device=args.device)
        print(f"engine snapshot -> {args.output} (loads clean)")


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
