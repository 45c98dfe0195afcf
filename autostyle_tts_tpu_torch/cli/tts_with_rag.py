"""RAG-driven TTS: read the retrieval JSONL (zh_text / speaker /
retrieved_file_id / retrieved_text / distance [/ whisper / retrieved_index])
and synthesize each turn in the retrieved style with the speaker's timbre.
--timbre_map maps speaker ids to timbre wavs (id=path,... or a JSON file);
--whisper_timbre serves whisper-flagged turns; with --style_db a row's style
comes from the DB's precomputed prompt artifacts (retrieved_index) instead
of its wav. --batch N synthesizes N turns in one batch.

Counterpart of the JAX ``cli/tts_with_rag.py``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict

from ..retrieval.store import StyleStore
from ..utils.audio_io import load_wav
from ..utils.manifest import JsonDataReader
from .common import add_common_args, build_engine, save_wav, timestamped_dir


def parse_timbre_map(spec: str) -> Dict[str, str]:
    if spec.endswith(".json"):
        with open(spec, encoding="utf-8") as f:
            return json.load(f)
    out = {}
    for part in spec.split(","):
        if part.strip():
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--corresponding_json", type=str, required=True, help="retrieval JSONL from search_json")
    p.add_argument("--result_dir", type=str, required=True)
    p.add_argument("--timbre_map", type=str, required=True, help="'w1=/p/w1.wav,m1=/p/m1.wav' or a JSON file")
    p.add_argument("--whisper_timbre", type=str, default=None, help="timbre wav for whisper-flagged turns")
    p.add_argument("--style_db", type=str, default=None,
                   help="StyleStore snapshot with prompt artifacts: a row's style features come from "
                        "the DB row (retrieved_index) instead of its wav")
    p.add_argument("--is_exp", type=str, default="false")
    p.add_argument("--batch", type=int, default=8)
    args = p.parse_args(argv)

    engine = build_engine(args)
    sr = engine.cfg.audio.prompt_sample_rate
    reader = JsonDataReader(args.corresponding_json)
    # each speaker's timbre is featurized once; every batch reuses it
    tmap = parse_timbre_map(args.timbre_map)
    wlist = [load_wav(v, sr) for v in tmap.values()]
    if args.whisper_timbre:
        wlist.append(load_wav(args.whisper_timbre, sr))
    tfeats = engine.prompt_features(wlist) if wlist else []
    timbres = dict(zip(tmap, tfeats))
    whisper_timbre = tfeats[-1] if args.whisper_timbre else None
    style_store = StyleStore.load(args.style_db, device=engine.device) if args.style_db else None
    result_dir = timestamped_dir(args.result_dir)

    rows = list(reader)
    for s0 in range(0, len(rows), max(args.batch, 1)):
        texts, style_texts, styles, timbs, names = [], [], [], [], []
        for cnt, r in enumerate(rows[s0 : s0 + args.batch], start=s0):
            if r.retrieved_file_id in ("N/A", "Error", ""):
                print(f"skip row {cnt}: no retrieval result")
                continue
            if style_store is not None and r.retrieved_index >= 0:
                style = engine.prompt_features_from_store(style_store, [r.retrieved_index])[0]
            else:
                style = load_wav(r.retrieved_file_id, sr)
            if r.whisper and whisper_timbre is not None:
                timbre, tname = whisper_timbre, "whisper"
            elif r.speaker in timbres:
                timbre, tname = timbres[r.speaker], r.speaker
            else:
                print(f"skip row {cnt}: no timbre for speaker {r.speaker!r}")
                continue
            texts.append(r.zh_text)
            style_texts.append(r.retrieved_text)
            styles.append(style)
            timbs.append(timbre)
            names.append(f"{cnt}_{Path(r.retrieved_file_id).stem}_to_{tname}")
        if not texts:
            continue
        for name, wav in zip(names, engine.synthesize_batch(texts, style_texts, styles, timbs)):
            out = result_dir / f"{name}.wav"
            save_wav(out, wav, engine)
            print(f"saved {out}")


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
