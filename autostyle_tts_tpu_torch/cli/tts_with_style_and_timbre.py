"""Per-line TTS with a fixed style wav and timbre wav. Counterpart of the
JAX ``cli/tts_with_style_and_timbre.py``; runs on the card unless --device
cpu. Flags: --style_wav_path --timbre_wav_path --style_wav_text --txt_path
--result_dir --is_exp.

Modes:
- exp (--is_exp true): two stages, zero-shot TTS from the style wav, then
  voice conversion onto the timbre wav (the intermediate is resampled to
  the prompt rate in memory) -> {n}_exp_{i}_{k}.wav;
- infer (default): one-stage style/timbre synthesis through
  ``inference_tts_with_st`` -> {n}_st_{i}.wav.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..ops.resample import resample_poly_np
from ..utils.native_audio import load_wav_fast
from .common import add_common_args, build_engine, read_lines, save_wav


def run_exp(engine, args, texts, style_wav, timbre_wav) -> None:
    a = engine.cfg.audio
    for cnt, text in enumerate(texts):
        for i, j in enumerate(engine.inference_zero_shot(text, args.style_wav_text, style_wav)):
            mid16 = resample_poly_np(j["tts_speech"][0], a.sample_rate, a.prompt_sample_rate)
            for k, r in enumerate(engine.inference_vc(mid16, timbre_wav)):
                out = Path(args.result_dir) / f"{cnt}_exp_{i}_{k}.wav"
                save_wav(out, r["tts_speech"], engine)
                print(f"saved {out}")


def run_infer(engine, args, texts, style_wav, timbre_wav) -> None:
    for cnt, text in enumerate(texts):
        for i, j in enumerate(engine.inference_tts_with_st(text, args.style_wav_text, style_wav, timbre_wav)):
            out = Path(args.result_dir) / f"{cnt}_st_{i}.wav"
            save_wav(out, j["tts_speech"], engine)
            print(f"saved {out}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--style_wav_path", type=str, required=True)
    p.add_argument("--timbre_wav_path", type=str, required=True)
    p.add_argument("--style_wav_text", type=str, required=True)
    p.add_argument("--txt_path", type=str, required=True)
    p.add_argument("--result_dir", type=str, required=True)
    p.add_argument("--is_exp", type=str, default="false", help="true = two-stage exp mode, false = infer mode")
    args = p.parse_args(argv)

    engine = build_engine(args)
    sr = engine.cfg.audio.prompt_sample_rate
    # the fixed prompts are featurized once; every line reuses their features
    style_wav, timbre_wav = engine.prompt_features([load_wav_fast(args.style_wav_path, sr),
                                                    load_wav_fast(args.timbre_wav_path, sr)])
    texts = read_lines(args.txt_path)
    Path(args.result_dir).mkdir(parents=True, exist_ok=True)
    run = run_exp if args.is_exp.lower() in ("true", "1", "yes") else run_infer
    run(engine, args, texts, style_wav, timbre_wav)


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
