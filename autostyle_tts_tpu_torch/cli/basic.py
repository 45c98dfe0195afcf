"""Zero-shot smoke demo: one utterance with a prompt wav ->
zero_shot_{i}.wav in --result_dir. Counterpart of the JAX ``cli/basic.py``;
runs on the card unless --device cpu."""

from __future__ import annotations

import argparse

from ..utils.native_audio import load_wav_fast
from .common import add_common_args, build_engine, save_wav


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--tts_text", type=str, default="Hello, this is a zero-shot synthesis smoke test.")
    p.add_argument("--prompt_text", type=str, default="A short prompt transcript.")
    p.add_argument("--prompt_wav", type=str, required=True)
    p.add_argument("--result_dir", type=str, default="./results")
    args = p.parse_args(argv)

    engine = build_engine(args)
    prompt = load_wav_fast(args.prompt_wav, engine.cfg.audio.prompt_sample_rate)
    for i, j in enumerate(engine.inference_zero_shot(args.tts_text, args.prompt_text, prompt)):
        out = f"{args.result_dir}/zero_shot_{i}.wav"
        save_wav(out, j["tts_speech"], engine)
        print(f"saved {out}")


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
