"""Style-DB build: the prompt-artifact half.

Counterpart of the artifact half of the JAX ``pipeline/rag.py::build_style_db``:
each sample's style wav is featurized at insert time and its speech tokens,
prompt mel and speaker embedding land in the DB as artifacts, so serving
indexes these instead of loading wavs per query. The embedding half
(biographies, emotion labels, combined embeddings) needs the RAG embedder,
which is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .engine import Engine


def prompt_artifacts(engine: Engine, wavs: Sequence[np.ndarray], batch: int = 16) -> Dict[str, np.ndarray]:
    """Featurize 16 kHz style wavs (arrays, row i of the DB first) in chunks
    of ``batch`` and pack them as ``StyleStore.artifacts``: ``speech_tokens``
    [n, T_tok] / ``speech_token_lens``, ``prompt_mel`` [n, F, M] /
    ``prompt_mel_lens``, ``spk`` [n, spk_dim], right-padded with zeros."""
    feats = []
    # chunked as the embedding loop is: one [n, 30 s] device batch for a
    # large corpus would not fit
    for s0 in range(0, len(wavs), batch):
        feats.extend(engine.prompt_features(wavs[s0 : s0 + batch]))
    n = len(feats)
    T_tok = max(len(f.tokens) for f in feats)
    F_mel = max(f.mel24.shape[0] for f in feats)
    tokens = np.zeros((n, T_tok), np.int32)
    tok_lens = np.zeros((n,), np.int32)
    mels = np.zeros((n, F_mel, feats[0].mel24.shape[1]), np.float32)
    mel_lens = np.zeros((n,), np.int32)
    spks = np.zeros((n, feats[0].spk.shape[0]), np.float32)
    for i, f in enumerate(feats):
        tokens[i, : len(f.tokens)] = f.tokens
        tok_lens[i] = len(f.tokens)
        mels[i, : f.mel24.shape[0]] = f.mel24
        mel_lens[i] = f.mel24.shape[0]
        spks[i] = f.spk
    return {"speech_tokens": tokens, "speech_token_lens": tok_lens,
            "prompt_mel": mels, "prompt_mel_lens": mel_lens, "spk": spks}


def build_style_db(embedder, samples, capacity: int = 4096, batch: int = 16, engine=None, wavs=None):
    """The whole insert pipeline needs the embedder service for its first
    half. Until that is ported, insert vectors into a ``StyleStore``
    directly and set ``store.artifacts = prompt_artifacts(engine, wavs)``."""
    raise NotImplementedError(
        "build_style_db's embedding half (biographies, emotion labels, combined embeddings) "
        "is not ported yet (ROADMAP.md: queue A item 6, RAG embedder); "
        "prompt_artifacts() is its artifact half"
    )
