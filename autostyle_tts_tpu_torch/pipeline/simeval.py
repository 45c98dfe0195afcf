"""Quality proxies that need no listener.

Counterpart of ``token_round_trip`` of the JAX ``pipeline/simeval.py`` (the
speaker-similarity scorer is not ported yet).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..ops.resample import resample_poly_np


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
