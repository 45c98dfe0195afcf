"""Per-line zero-shot TTS from a text file and one prompt wav: each line of
--txt_path is synthesized with --prompt_wav / --prompt_text, all lines in
one batch, as line_{n}.wav. Counterpart of the JAX
``cli/tts_from_lines.py``; runs on the card unless --device cpu."""

from __future__ import annotations

import argparse
from pathlib import Path

from ..utils.native_audio import load_wav_fast
from .common import add_common_args, build_engine, read_lines, save_wav


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--txt_path", type=str, required=True)
    p.add_argument("--prompt_wav", type=str, required=True)
    p.add_argument("--prompt_text", type=str, required=True)
    p.add_argument("--result_dir", type=str, required=True)
    args = p.parse_args(argv)

    engine = build_engine(args)
    prompt = load_wav_fast(args.prompt_wav, engine.cfg.audio.prompt_sample_rate)
    lines = read_lines(args.txt_path)
    Path(args.result_dir).mkdir(parents=True, exist_ok=True)
    # one wav object for every row: featurized once
    wavs = engine.synthesize_batch(lines, [args.prompt_text] * len(lines), [prompt] * len(lines),
                                   [prompt] * len(lines))
    for cnt, wav in enumerate(wavs, start=1):
        out = Path(args.result_dir) / f"line_{cnt}.wav"
        save_wav(out, wav, engine)
        print(f"saved {out}")


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
