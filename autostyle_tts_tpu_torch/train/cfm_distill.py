"""Progressive distillation of the CFM mel decoder: fewer steps, no CFG.

Counterpart of the JAX ``train/cfm_distill.py``. The trained OT-CFM field
serves mel with an N-step Euler solve under classifier-free guidance (2N
estimator evaluations, the pair batch-folded). Distillation trains a
student of the same architecture that needs a few steps and no
unconditional branch:

  phase 1: teacher = trained field under CFG      -> student at n_1 steps
  phase k: teacher = previous student, plain call -> student at n_k steps

At each grid time t of its schedule the student learns to jump in one Euler
step of size dt to where the teacher lands after two steps of dt/2 (Salimans
& Ho 2022 in the OT-CFM parameterisation: the target is the mean teacher
field (v1 + v2) / 2, masked as ``cfm_loss`` is). x_t is drawn from the OT
interpolant's marginal, x_t = (1 - (1 - sigma_min) t) x0 + t x1. The
student serves with ``CFMConfig(n_steps=schedule[-1], use_cfg=False)``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from ..models import cfm as cfm_lib
from ..utils.config import CFMConfig
from .optim import (GradientTransformation, adamw, apply_optimizer, cosine_decay_schedule, detached, tree_map,
                    value_and_grad)

Params = Dict


def guided_field(params: Params, cfg: CFMConfig, cfg_scale: float, x, t, token_cond, spk, prompt_mel,
                 prompt_mask, frame_mask) -> torch.Tensor:
    """The sampler's effective vector field: one conditional call when
    ``cfg_scale`` is 0, else the conditional / unconditional pair folded
    into one 2B call, as ``cfm.sample_mel``'s guidance branch."""
    if cfg_scale == 0.0:
        return cfm_lib.vector_field(params, cfg, x, t, token_cond, spk, prompt_mel, prompt_mask, frame_mask)
    two = lambda a: torch.cat([a, a], dim=0)
    tc2 = torch.cat([token_cond, torch.zeros_like(token_cond)], dim=0)
    v2 = cfm_lib.vector_field(params, cfg, two(x), two(t), tc2, two(spk), two(prompt_mel), two(prompt_mask),
                              two(frame_mask))
    B = x.shape[0]
    return (1 + cfg_scale) * v2[:B] - cfg_scale * v2[B:]


def distill_draws(generator: torch.Generator, mel: torch.Tensor, n_student_steps: int) -> Dict[str, torch.Tensor]:
    """The draws of one distillation step: grid indices ``i`` [B] in
    [0, n_student_steps) and the noise ``x0`` [B, F, M]."""
    B = mel.shape[0]
    return {"i": torch.randint(0, n_student_steps, (B,), generator=generator, device=mel.device),
            "x0": torch.randn(mel.shape, generator=generator, device=mel.device, dtype=mel.dtype)}


def make_distill_step(cfg: CFMConfig, optimizer: GradientTransformation, n_student_steps: int,
                      teacher_cfg_scale: float):
    """One distillation update on a "cfm"-stage batch (``train.data``):
    ``step(student, teacher, opt_state, batch, generator, draws=None) ->
    (student, opt_state, loss)``; ``draws`` as ``distill_draws`` gives."""
    dt = 1.0 / n_student_steps

    def step(student, teacher, opt_state, batch, generator: Optional[torch.Generator],
             draws: Optional[Dict[str, torch.Tensor]] = None):
        mel, spk = batch["mel"], batch["spk"]
        pmask, fmask = batch["prompt_mask"], batch["frame_mask"]
        M = mel.shape[-1]
        d = draws if draws is not None else distill_draws(generator, mel, n_student_steps)
        t = d["i"].float() * dt
        s = cfg.sigma_min
        x_t = (1 - (1 - s) * t)[:, None, None] * d["x0"] + t[:, None, None] * mel
        prompt_mel = mel * pmask[..., None]
        with torch.no_grad():   # two teacher half-steps -> the student's one-step target
            cond_t = cfm_lib.upsample_tokens(teacher, batch["tokens"], cfg.upsample, cfg.token_vocab_size)
            v1 = guided_field(teacher, cfg, teacher_cfg_scale, x_t, t, cond_t, spk, prompt_mel, pmask, fmask)
            x_half = x_t + (dt / 2) * v1
            v2 = guided_field(teacher, cfg, teacher_cfg_scale, x_half, t + dt / 2, cond_t, spk, prompt_mel,
                              pmask, fmask)
            target = (v1 + v2) / 2.0

        def loss_fn(p):
            cond_s = cfm_lib.upsample_tokens(p, batch["tokens"], cfg.upsample, cfg.token_vocab_size)
            pred = cfm_lib.vector_field(p, cfg, x_t, t, cond_s, spk, prompt_mel, pmask, fmask)
            w = (fmask * (1 - pmask))[..., None]
            return (w * (pred - target) ** 2).sum() / torch.clamp(w.sum() * M, min=1.0)

        loss, _, grads = value_and_grad(loss_fn, student)
        student, opt_state = apply_optimizer(step, optimizer, detached(student), grads, opt_state)
        return student, opt_state, loss

    return step


def distill(teacher_params: Params, cfg: CFMConfig, batch_iter_fn, schedule: Sequence[int] = (4, 2),
            steps_per_phase: int = 400, learning_rate: float = 1e-4, generator: Optional[torch.Generator] = None,
            log_every: int = 50, log=print) -> Tuple[Params, List[Dict]]:
    """Run the halving schedule -> (student params, history).
    ``batch_iter_fn(phase)`` returns a fresh iterator of batches (dicts with
    a "cfm" entry); it is called again when a phase exhausts it. The
    teacher is queried through its guidance when ``cfg.use_cfg`` (an
    already distilled teacher is not)."""
    teacher = teacher_params
    scale = float(cfg.cfg_scale) if cfg.use_cfg else 0.0
    history: List[Dict] = []
    student = teacher
    for phase, n_steps in enumerate(schedule):
        student = tree_map(lambda x: x.detach().clone(), teacher)
        opt = adamw(cosine_decay_schedule(learning_rate, max(steps_per_phase, 1)))
        opt_state = opt.init(student)
        step_fn = make_distill_step(cfg, opt, n_steps, scale)
        it = iter(batch_iter_fn(phase))
        last = float("nan")
        for u in range(steps_per_phase):
            try:
                batch = next(it)["cfm"]
            except StopIteration:
                it = iter(batch_iter_fn(phase))
                batch = next(it)["cfm"]
            student, opt_state, loss = step_fn(student, teacher, opt_state, batch, generator)
            if (u + 1) % log_every == 0 or u == steps_per_phase - 1:
                last = float(loss)
                log(f"phase {phase} (n={n_steps}, teacher_cfg={scale:g}) step {u + 1}/{steps_per_phase}: "
                    f"loss={last:.5f}")
        history.append({"phase": phase, "n_steps": n_steps, "teacher_cfg_scale": scale, "final_loss": last})
        teacher, scale = student, 0.0
    return student, history


@torch.no_grad()
def eval_mel_l1(params: Params, cfg: CFMConfig, batches: Iterator[Dict], generator: torch.Generator,
                use_cfg: bool, ref_params: Optional[Params] = None, ref_cfg: Optional[CFMConfig] = None,
                ref_use_cfg: bool = True) -> Dict[str, float]:
    """Masked mel-L1 of sampled mel against the data on "cfm" batches; with a
    reference sampler also against its output from the same noise."""
    tot = n = tot_ref = 0.0
    for b in batches:
        b = b["cfm"]
        cond = cfm_lib.upsample_tokens(params, b["tokens"], cfg.upsample, cfg.token_vocab_size)
        pmel = b["mel"] * b["prompt_mask"][..., None]
        noise = torch.randn(b["mel"].shape, generator=generator, device=b["mel"].device)
        mel = cfm_lib.sample_mel(params, cfg, None, cond, b["spk"], pmel, b["prompt_mask"], b["frame_mask"],
                                 use_cfg=use_cfg, noise=noise)
        w = (b["frame_mask"] * (1 - b["prompt_mask"]))[..., None]
        tot += float((w * (mel - b["mel"]).abs()).sum())
        n += float(w.sum() * cfg.n_mels)
        if ref_params is not None:
            cond_r = cfm_lib.upsample_tokens(ref_params, b["tokens"], ref_cfg.upsample,
                                               ref_cfg.token_vocab_size)
            ref = cfm_lib.sample_mel(ref_params, ref_cfg, None, cond_r, b["spk"], pmel, b["prompt_mask"],
                                     b["frame_mask"], use_cfg=ref_use_cfg, noise=noise)
            tot_ref += float((w * (mel - ref).abs()).sum())
    out = {"mel_l1": tot / max(n, 1.0)}
    if ref_params is not None:
        out["mel_l1_vs_ref"] = tot_ref / max(n, 1.0)
    return out
