"""Distill the CFM mel decoder to a few-step, guidance-free student.

Counterpart of the JAX ``cli/distill_cfm.py``; runs on the card unless
--device cpu. Progressive distillation (``train/cfm_distill.py``) over a
(wav, text) manifest: each phase halves the Euler step count and phase 1
folds the classifier-free guidance into the student's conditional field.
The output engine snapshot serves with
``--set cfm.n_steps=<last> --set cfm.use_cfg=false``.

  python -m autostyle_tts_tpu_torch.cli.distill_cfm --demo \\
      --checkpoint engine_trained.npz --manifest corpus/manifest.json \\
      --wav_dir corpus --output engine_distilled.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from ..train.cfm_distill import distill, eval_mel_l1
from ..train.data import load_acoustic_manifest, make_acoustic_batches
from ..utils.checkpoint import save_pytree
from .common import add_common_args, build_training_engine, is_main, save_engine_checkpoint


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--manifest", type=str, required=True)
    p.add_argument("--wav_dir", type=str, default="")
    p.add_argument("--output", type=str, required=True, help="distilled full-engine snapshot (.npz)")
    p.add_argument("--output_cfm", type=str, default=None, help="also write the distilled CFM tree alone (.npz)")
    p.add_argument("--schedule", type=str, default="4,2", help="comma-separated step counts per phase")
    p.add_argument("--steps_per_phase", type=int, default=400)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--prompt_seconds", type=float, default=3.0)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--eval_batches", type=int, default=4,
                   help="held-out batches for the final teacher/student mel-L1 report (0 = skip)")
    args = p.parse_args(argv)

    engine, masters = build_training_engine(args)
    cfg = engine.cfg
    schedule = tuple(int(s) for s in args.schedule.split(",") if s)
    items = load_acoustic_manifest(args.manifest, args.wav_dir)
    n_eval = min(args.eval_batches * args.batch_size, len(items) // 4)
    train_items, eval_items = items[: len(items) - n_eval], items[len(items) - n_eval:]
    print(f"{len(train_items)} train / {len(eval_items)} eval items; schedule {schedule}, "
          f"{args.steps_per_phase} steps/phase")
    feat_cache = {}
    gen = lambda offset: torch.Generator(device=engine.device).manual_seed(args.seed + offset)

    def batches(items_, phase, shuffle=True):
        return make_acoustic_batches(engine, items_, args.batch_size, args.prompt_seconds, seed=args.seed + phase,
                                     stages=("cfm",), cache=feat_cache, shuffle=shuffle)

    teacher = masters.cfm
    student, history = distill(teacher, cfg.cfm, lambda phase: batches(train_items, phase), schedule=schedule,
                               steps_per_phase=args.steps_per_phase, learning_rate=args.learning_rate,
                               generator=gen(0), log_every=args.log_every)
    print("history:", json.dumps(history))

    if eval_items and args.eval_batches:
        scfg = dataclasses.replace(cfg.cfm, n_steps=schedule[-1], use_cfg=False)
        held_out = lambda: batches(eval_items, 0, False)
        m_t = eval_mel_l1(teacher, cfg.cfm, held_out(), gen(99), use_cfg=cfg.cfm.use_cfg)
        m_s = eval_mel_l1(student, scfg, held_out(), gen(99), use_cfg=False, ref_params=teacher, ref_cfg=cfg.cfm,
                          ref_use_cfg=cfg.cfm.use_cfg)
        m_fast = eval_mel_l1(teacher, scfg, held_out(), gen(99), use_cfg=False)
        print(f"held-out mel-L1: teacher@{cfg.cfm.n_steps}+cfg {m_t['mel_l1']:.4f} | "
              f"student@{schedule[-1]} {m_s['mel_l1']:.4f} (vs teacher output {m_s['mel_l1_vs_ref']:.4f}) | "
              f"undistilled-teacher@{schedule[-1]} {m_fast['mel_l1']:.4f}")

    engine.set_module("cfm", student)
    save_engine_checkpoint(engine, args.output)
    print(f"distilled engine -> {args.output} (serve with --set cfm.n_steps={schedule[-1]} "
          f"--set cfm.use_cfg=false)")
    if args.output_cfm and is_main():
        save_pytree(args.output_cfm, student, metadata={"n_steps": schedule[-1], "use_cfg": False})
        print(f"distilled CFM tree -> {args.output_cfm}")


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
