"""Batch style x timbre matrix: sample --style_num style wavs and
--timbre_num timbre wavs, synthesize every (style, timbre, line) combination
and write meta.lst rows 'name|style_text|timbre_path|text' for similarity
scoring (--cal_sim scores them at once into similarity.json). Style texts
are looked up in --style_json by 'denoise_' + the file's stem. Each
(style, timbre) pair's lines run as one batch. Counterpart of the JAX
``cli/vc_from_dir.py``; runs on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import json
import random
from pathlib import Path
from typing import List

from ..utils.manifest import meta_lst_row, write_meta_lst
from ..utils.native_audio import load_wav_fast
from .common import add_common_args, build_engine, read_lines, save_wav


def sample_paths(directory: str, num: int, rng: random.Random) -> List[str]:
    files = sorted(str(p) for p in Path(directory).iterdir() if p.is_file())
    if num > len(files):
        raise ValueError(f"requested {num} > available {len(files)} in {directory}")
    return rng.sample(files, num)


def style_text_lookup(style_json: str, stem: str) -> str:
    with open(style_json, encoding="utf-8") as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = list(data.values())
    want = stem if stem.startswith("denoise_") else "denoise_" + stem
    for entry in data:
        if entry.get("file_id") in (want, stem):
            return entry["zh_text"]
    raise KeyError(f"no style text for file_id {want!r} in {style_json}")


def run_matrix(engine, args, timbre_items: List[tuple], rng: random.Random) -> None:
    """timbre_items: [(timbre wav path, its text (unused))]."""
    sr = engine.cfg.audio.prompt_sample_rate
    lines = read_lines(args.txt_path)
    style_paths = sample_paths(args.style_dir, args.style_num, rng)
    Path(args.result_dir).mkdir(parents=True, exist_ok=True)
    # every sampled style and timbre featurized once, in one call each
    style_feats = engine.prompt_features([load_wav_fast(p, sr) for p in style_paths])
    timbre_feats = engine.prompt_features([load_wav_fast(p, sr) for p, _ in timbre_items])
    meta_rows: List[str] = []
    for style_path, style_feat in zip(style_paths, style_feats):
        style = Path(style_path).stem
        style_text = style_text_lookup(args.style_json, style)
        for (timbre_path, _), timbre_feat in zip(timbre_items, timbre_feats):
            timbre = Path(timbre_path).stem
            wavs = engine.synthesize_batch(lines, [style_text] * len(lines), [style_feat] * len(lines),
                                           [timbre_feat] * len(lines))
            for cnt, (line, wav) in enumerate(zip(lines, wavs), start=1):
                name = f"{style}_to_{timbre}_{cnt}_new"
                save_wav(Path(args.result_dir) / f"{name}.wav", wav, engine)
                meta_rows.append(meta_lst_row(name, style_text, timbre_path, line))
    write_meta_lst(Path(args.result_dir) / "meta.lst", meta_rows)
    print(f"wrote {len(meta_rows)} rows to {args.result_dir}/meta.lst")
    if getattr(args, "cal_sim", False):
        from ..pipeline.simeval import score_meta_lst, write_report

        report = score_meta_lst(engine, Path(args.result_dir) / "meta.lst", args.result_dir)
        write_report(Path(args.result_dir) / "similarity.json", report)
        print("similarity:", json.dumps(report["summary"]))


def add_matrix_args(p: argparse.ArgumentParser) -> None:
    add_common_args(p)
    p.add_argument("--txt_path", type=str, required=True)
    p.add_argument("--style_dir", type=str, required=True)
    p.add_argument("--result_dir", type=str, required=True)
    p.add_argument("--style_num", type=int, default=2)
    p.add_argument("--timbre_num", type=int, default=2)
    p.add_argument("--style_json", type=str, required=True, help="style transcripts: [{file_id, zh_text}, ...]")
    p.add_argument("--cal_sim", action="store_true",
                   help="score speaker similarity over the written meta.lst (similarity.json beside it)")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_matrix_args(p)
    p.add_argument("--timbre_dir", type=str, required=True)
    args = p.parse_args(argv)
    rng = random.Random(args.seed)
    engine = build_engine(args)
    run_matrix(engine, args, [(t, "") for t in sample_paths(args.timbre_dir, args.timbre_num, rng)], rng)


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
