"""A stream's windows as plain float32 PyTorch, on ``tts.py``'s CFM and
iSTFT vocoder.

A stream renders its tokens a chunk of ``chunk`` at a time. Each chunk is
the middle of one CFM solve and vocoder pass over a window of
``W = fp_w + 2 * chunk`` tokens: the prompt's last ``keep`` tokens and
their mel in ``fp_w`` slots, then up to ``chunk`` tokens of context right
before the chunk with the previous window's chunk mel in-painted under
them, then the chunk. Frame positions are absolute: the chunk's frames sit
where the whole utterance's solve would put them. Nothing here reads a
tensor of the program: the prompt is clipped and bucketed again, and each
window's context mel is this render's own previous chunk.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import tts


def render(tree: Dict, cfg: Dict, num: tts.Numerics, prompt_tokens: Sequence[int], prompt_mel: np.ndarray,
           spk: torch.Tensor, gen_tokens: Sequence[int], noises: Sequence[torch.Tensor], chunk: int,
           keep: int) -> List[torch.Tensor]:
    """Each chunk's samples of a stream of ``gen_tokens``: window k solves
    from ``noises[k]`` [W * up, M]."""
    c, hop = cfg["cfm"], cfg["audio"]["hop_length"]
    up, M = c["upsample"], c["n_mels"]
    dev = spk.device
    k0 = max(0, len(prompt_tokens) - keep)
    ptok = [int(t) for t in prompt_tokens[k0:]]
    pmel = np.asarray(prompt_mel)[k0 * up:]
    fp_w = tts.bucket(len(ptok), tts.TOKEN_BUCKETS)
    n_p = min(len(ptok), fp_w)
    n_mel = min(pmel.shape[0], n_p * up)
    W = fp_w + 2 * chunk
    fr = torch.arange(W * up, device=dev)
    sl = fr // up
    gen = [int(t) for t in gen_tokens]
    mel_ctx = torch.zeros((chunk * up, M), device=dev)
    out, emitted = [], 0
    for noise in noises:
        if emitted >= len(gen):
            break
        n_chunk = min(chunk, len(gen) - emitted)
        ctx = min(chunk, emitted)
        lo_slot = fp_w + chunk - ctx              # the context's first slot
        toks = torch.zeros(W, dtype=torch.long, device=dev)
        toks[:n_p] = torch.tensor(ptok[:n_p], dtype=torch.long, device=dev)
        toks[lo_slot: fp_w + chunk + n_chunk] = torch.tensor(gen[emitted - ctx: emitted + n_chunk],
                                                             dtype=torch.long, device=dev)
        in_ctx = (sl >= lo_slot) & (sl < fp_w + chunk)
        pmask = ((fr < n_mel) | in_ctx).float()
        fmask = ((fr < n_p * up) | in_ctx | ((sl >= fp_w + chunk) & (sl < fp_w + chunk + n_chunk))).float()
        pm = torch.zeros((W * up, M), device=dev)
        pm[:n_mel] = torch.as_tensor(pmel[:n_mel], dtype=torch.float32, device=dev)
        pm[fp_w * up: (fp_w + chunk) * up] = mel_ctx
        pm = pm * pmask[:, None]
        pos = torch.where(fr < fp_w * up, fr, torch.clamp((n_p + emitted - chunk) * up + fr - fp_w * up, min=0))
        mel = _solve(tree["cfm"], c, num, toks, pos, spk, pm, pmask, fmask, noise)
        wav = tts.vocoder_istft(tree["vocoder"], cfg["vocoder"], num, mel)
        lo = (fp_w + chunk) * up
        out.append(wav[lo * hop: (lo + n_chunk * up) * hop])
        mel_ctx = mel[lo: lo + chunk * up]
        emitted += n_chunk
    return out


def _solve(p: Dict, c: Dict, num: tts.Numerics, toks: torch.Tensor, pos: torch.Tensor, spk: torch.Tensor,
           pm: torch.Tensor, pmask: torch.Tensor, fmask: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The window's Euler solve, as ``tts.cfm_mel``'s, with its frames at
    positions ``pos``: ``tts._vector_field`` adds the sinusoid of frames
    0.. to its conditioning, so the conditioning carries the difference."""
    n_fr, D = pm.shape[0], c["dim"]
    shift = tts._sinusoid(pos, D) - tts._sinusoid(torch.arange(n_fr, device=pos.device), D)
    cond = num.f32(p["tok_emb"][toks.clamp(max=c["token_vocab_size"] - 1)]).repeat_interleave(c["upsample"], dim=0)
    x = noise.float()
    for i in range(c["n_steps"]):
        t = i / c["n_steps"]
        v = tts._vector_field(p, c, num, x, t, cond + shift, spk, pm, pmask, fmask)
        if c["use_cfg"]:
            v0 = tts._vector_field(p, c, num, x, t, shift, spk, pm, pmask, fmask)
            v = (1 + c["cfg_scale"]) * v - c["cfg_scale"] * v0
        x = x + (1.0 / c["n_steps"]) * v
    return x * (1 - pmask[:, None]) + pm * pmask[:, None]
