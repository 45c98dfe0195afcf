"""Train one stage of the synthesis stack from a (wav, text) manifest.

Counterpart of the JAX ``cli/train_acoustic.py``; runs on the card unless
--device cpu.

  --stage tokenizer | token_lm | cfm | vocoder | vocoder_gan | phn_head

Data: --manifest JSON/JSONL of {wav|file_id, text[, speaker][, phn]}
(+ --wav_dir), featurized by the engine (``train/data.py``). The stage
starts from the engine's f32 weights (--checkpoint, else drawn from --seed)
and writes step-numbered checkpoints to --out_dir (``CheckpointManager``,
the JAX package's files); a rerun resumes from the latest one, skipping the
epochs it completed. ``export_engine --stage_ckpt STAGE=DIR`` merges a
stage into an engine snapshot. The JAX CLI's --stall_min watchdog (for a
remote device that can stall) has no counterpart here.
"""

from __future__ import annotations

import argparse

import torch

from ..train import acoustic
from ..train.data import load_acoustic_manifest, make_acoustic_batches
from ..utils.checkpoint import CheckpointManager
from .common import add_common_args, build_training_engine

STAGES = ("tokenizer", "token_lm", "cfm", "vocoder", "vocoder_gan", "phn_head")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--manifest", type=str, required=True)
    p.add_argument("--wav_dir", type=str, default="")
    p.add_argument("--stage", type=str, required=True, choices=STAGES)
    p.add_argument("--n_phoneme_classes", type=int, default=0,
                   help="tokenizer / phn_head stage: phoneme label classes (0 = the synthcorpus inventory)")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--prompt_seconds", type=float, default=3.0)
    p.add_argument("--save_every", type=int, default=200)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--cache_items", type=int, default=40000,
                   help="feature-cache capacity in items (a larger corpus re-featurizes the overflow each epoch)")
    args = p.parse_args(argv)

    engine, masters = build_training_engine(args)
    cfg, a, dev = engine.cfg, engine.cfg.audio, engine.device
    items = load_acoustic_manifest(args.manifest, args.wav_dir)
    print(f"{len(items)} training items")
    feat_cache = {}
    per_epoch = max(1, len(items) // args.batch_size)
    opt = acoustic.default_optimizer(args.learning_rate, total_steps=max(1, args.epochs * per_epoch))
    mgr = CheckpointManager(args.out_dir, save_total_limit=2)
    gen = lambda offset: torch.Generator(device=dev).manual_seed(args.seed + offset)
    data_stage = {"tokenizer": "tokenizer", "phn_head": "tokenizer", "vocoder_gan": "vocoder"}.get(
        args.stage, args.stage)

    def batches(step: int):
        """(step, batch) over the epochs left, resuming at ``step``."""
        for epoch in range(min(args.epochs, step // per_epoch), args.epochs):
            for batch in make_acoustic_batches(engine, items, args.batch_size, args.prompt_seconds,
                                               seed=args.seed + epoch, stages=(data_stage,), cache=feat_cache,
                                               cache_max_items=args.cache_items):
                step += 1
                yield step, batch[data_stage]

    def save(step: int, tree, final: bool = False) -> None:
        if final or step % args.save_every == 0:
            mgr.save(max(step, 1), tree)

    if args.stage in ("tokenizer", "phn_head"):
        from ..train.synthcorpus import N_PHONEME_CLASSES

        n_cls = args.n_phoneme_classes or N_PHONEME_CLASSES
    if args.stage == "tokenizer":
        params = {"tok": masters.speech_tokenizer,
                  "head": acoustic.init_tokenizer_head(gen(2), cfg.speech_tokenizer, n_cls)}
        step_fn = acoustic.make_tokenizer_step(cfg.speech_tokenizer, a, opt, n_cls)
        opt_state = opt.init(params)
        usage = acoustic.init_usage(cfg.speech_tokenizer, dev)
        step = mgr.latest_step() or 0
        if step:
            params = mgr.restore(params)
        g = gen(0)
        for step, batch in batches(step):
            params, opt_state, usage, loss, ce, acc, n_used = step_fn(params, opt_state, usage, batch, g)
            if step % args.log_every == 0:
                print(f"step {step}: loss={float(loss):.4f} phn_ce={float(ce):.4f} phn_acc={float(acc):.3f} "
                      f"codes_used={int(n_used)}")
            save(step, params)
    elif args.stage == "phn_head":
        params = acoustic.init_tokenizer_head(gen(3), cfg.speech_tokenizer, n_cls)
        step_fn = acoustic.make_phn_head_step(cfg.speech_tokenizer, a, opt, n_cls)
        opt_state = opt.init(params)
        step = mgr.latest_step() or 0
        if step:
            params = mgr.restore(params)
        for step, batch in batches(step):
            params, opt_state, ce, acc = step_fn(masters.speech_tokenizer, params, opt_state, batch)
            if step % args.log_every == 0:
                print(f"step {step}: phn_ce={float(ce):.4f} phn_acc={float(acc):.3f}")
            save(step, params)
    elif args.stage == "vocoder_gan":
        from ..models import discriminator as disc_lib

        params = masters.vocoder
        d_params = disc_lib.init_params(gen(1))
        d_opt = acoustic.default_optimizer(args.learning_rate)
        gen_step, disc_step = acoustic.make_vocoder_gan_steps(cfg.vocoder, opt, d_opt, sr=a.sample_rate,
                                                              n_fft=a.n_fft, hop=a.hop_length)
        g_st, d_st = opt.init(params), d_opt.init(d_params)
        step = mgr.latest_step() or 0
        if step:
            params = mgr.restore(params)
        g = gen(0)
        for step, batch in batches(step):
            d_params, d_st, d_loss = disc_step(d_params, d_st, params, batch, g)
            params, g_st, g_loss = gen_step(params, g_st, d_params, batch, g)
            if step % args.log_every == 0:
                print(f"step {step}: g={float(g_loss):.4f} d={float(d_loss):.4f}")
            save(step, params)
    else:
        if args.stage == "token_lm":
            params, step_fn = masters.token_lm, acoustic.make_token_lm_step(cfg.token_lm, opt)
        elif args.stage == "cfm":
            params, step_fn = masters.cfm, acoustic.make_cfm_step(cfg.cfm, opt)
        else:
            params = masters.vocoder
            step_fn = acoustic.make_vocoder_step(cfg.vocoder, opt, sr=a.sample_rate, n_fft=a.n_fft,
                                                 hop=a.hop_length)
        opt_state = opt.init(params)
        step = mgr.latest_step() or 0
        if step:
            params = mgr.restore(params)
        g = gen(0)
        for step, batch in batches(step):
            params, opt_state, loss = step_fn(params, opt_state, batch, g)
            if step % args.log_every == 0:
                print(f"step {step}: loss={float(loss):.4f}")
            save(step, params)
    save(step, params, final=True)
    print(f"done: {step} steps -> {args.out_dir}")


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
