"""Dialog batch TTS: a correspondence JSON {turn_idx: {value: style_idx,
speaker, emotion} | 'null'} joins a dialog JSONL (zh_text per turn,
1-indexed) and a style-DB JSONL (file_id + zh_text, 1-indexed); each
non-null turn is synthesized with its style wav and the speaker's timbre
(--timbre_map), --batch turns at a time, as
{n}_{style stem}_to_{speaker}_0.wav in a timestamped directory.
Counterpart of the JAX ``cli/tts_for_dialog.py``; runs on the card unless
--device cpu.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..utils.manifest import read_jsonl
from ..utils.native_audio import load_wav_fast
from .common import add_common_args, build_engine, save_wav, timestamped_dir
from .tts_with_rag import parse_timbre_map


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--corresponding_json", type=str, required=True)
    p.add_argument("--dialogue_json", type=str, required=True)
    p.add_argument("--style_wav_json", type=str, required=True)
    p.add_argument("--style_wav_dir", type=str, required=True)
    p.add_argument("--result_dir", type=str, required=True)
    p.add_argument("--timbre_map", type=str, required=True)
    p.add_argument("--batch", type=int, default=8)
    args = p.parse_args(argv)

    engine = build_engine(args)
    sr = engine.cfg.audio.prompt_sample_rate
    dialogue = read_jsonl(args.dialogue_json)
    style_db = read_jsonl(args.style_wav_json)
    # each speaker's timbre is featurized once for the whole dialog
    tmap = parse_timbre_map(args.timbre_map)
    timbres = dict(zip(tmap, engine.prompt_features([load_wav_fast(v, sr) for v in tmap.values()]))) \
        if tmap else {}
    with open(args.corresponding_json, encoding="utf-8") as f:
        correspond = json.load(f)
    result_dir = timestamped_dir(args.result_dir)

    items = []
    cnt = 0
    for key, value in correspond.items():
        if value == "null" or value is None:
            continue
        cnt += 1
        turn_idx, style_idx, speaker = int(key), int(value["value"]), value["speaker"]
        if not (1 <= turn_idx <= len(dialogue)) or not (1 <= style_idx <= len(style_db)):
            print(f"skip turn {key}: index out of range")
            continue
        if speaker not in timbres:
            print(f"skip turn {key}: no timbre for speaker {speaker!r}")
            continue
        entry = style_db[style_idx - 1]
        style_path = Path(args.style_wav_dir) / f"{entry['file_id']}.wav"
        items.append((cnt, dialogue[turn_idx - 1]["zh_text"], entry["zh_text"], str(style_path), speaker))

    for s0 in range(0, len(items), max(args.batch, 1)):
        chunk = items[s0 : s0 + args.batch]
        wavs = engine.synthesize_batch([c[1] for c in chunk], [c[2] for c in chunk],
                                       [load_wav_fast(c[3], sr) for c in chunk], [timbres[c[4]] for c in chunk])
        for (n, _, _, spath, spk), wav in zip(chunk, wavs):
            out = result_dir / f"{n}_{Path(spath).stem}_to_{spk}_0.wav"
            save_wav(out, wav, engine)
            print(f"saved {out}")


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
