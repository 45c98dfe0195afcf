"""Quality proxies that need no listener.

Counterpart of ``SpeakerScorer`` and ``token_round_trip`` of the JAX
``pipeline/simeval.py`` (its manifest scoring, retrieval report and phoneme
recognizer are not ported yet: ROADMAP.md queue A item 11).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..models import speaker
from ..ops import stft
from ..ops.resample import resample_poly_np


class SpeakerScorer:
    """SV cosine on the engine's speaker encoder: each wav's prompt-rate
    log-mel (the fused log-mel kernel on the card), ``speaker.apply`` (its
    embeddings are L2-normalized), and the dot of two embeddings. A batch
    of wavs is padded to one length bucket and embedded in one call."""

    def __init__(self, engine, max_seconds: float = 30.0):
        self.engine = engine
        a = engine.cfg.audio
        self._buckets = tuple(a.prompt_sample_rate * s for s in (1, 2, 4, 8, 16, int(max_seconds)))

    def embed_wavs(self, wavs_16k: Sequence[np.ndarray]) -> np.ndarray:
        """[N wavs at the prompt rate] -> [N, emb_dim] L2-normalized."""
        eng = self.engine
        a, scfg = eng.cfg.audio, eng.cfg.speaker
        if not wavs_16k:
            return np.zeros((0, scfg.emb_dim), np.float32)
        lens = [max(1, len(w)) for w in wavs_16k]
        T = next((b for b in self._buckets if max(lens) <= b), self._buckets[-1])
        batch = np.zeros((len(wavs_16k), T), np.float32)
        for i, w in enumerate(wavs_16k):
            batch[i, : min(len(w), T)] = np.asarray(w, np.float32)[:T]
        mel16 = stft.log_mel_spectrogram(
            eng._tensor(batch, torch.float32), a.prompt_sample_rate, a.prompt_n_fft,
            a.prompt_hop_length, a.prompt_win_length, n_mels=a.prompt_n_mels, fmax=a.prompt_fmax)
        frames = torch.arange(mel16.shape[1], device=mel16.device)[None, :]
        fmask = (frames < eng._tensor(lens, torch.int64)[:, None] // a.prompt_hop_length + 1).float()
        return speaker.apply(eng.params.speaker, scfg, mel16, fmask).float().cpu().numpy()

    def similarity(self, synth_16k: List[np.ndarray], ref_16k: List[np.ndarray]) -> np.ndarray:
        """Row-wise cosine between synthesized and reference speakers."""
        if len(synth_16k) != len(ref_16k):
            raise ValueError(f"{len(synth_16k)} synthesized wavs for {len(ref_16k)} references")
        embs = self.embed_wavs(list(synth_16k) + list(ref_16k))
        n = len(synth_16k)
        return np.sum(embs[:n] * embs[n:], axis=-1)


def token_round_trip(engine, wav_out: np.ndarray, expected_tokens: np.ndarray) -> Tuple[float, int]:
    """Re-tokenize synthesized audio (at ``audio.sample_rate``) and compare
    with the speech tokens that produced it: -> (share of the first n
    tokens that agree, n). A healthy tokens -> CFM -> vocoder -> tokenizer
    chain is near the identity."""
    a = engine.cfg.audio
    wav16 = resample_poly_np(np.asarray(wav_out, np.float32).ravel(), a.sample_rate,
                             a.prompt_sample_rate)
    feats = engine.prompt_features([wav16])[0]
    exp = np.asarray(expected_tokens).ravel()
    n = min(len(feats.tokens), len(exp))
    if n == 0:
        return 0.0, 0
    return float((feats.tokens[:n] == exp[:n]).mean()), n
