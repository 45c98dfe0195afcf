"""Quality proxies that need no listener.

Counterpart of ``SpeakerScorer``, ``token_round_trip`` and the manifest
scoring (``read_meta_lst``, ``score_meta_lst``, ``write_report``) of the JAX
``pipeline/simeval.py`` (its retrieval report and phoneme recognizer are not
ported yet: ROADMAP.md queue A item 11).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..models import speaker
from ..ops import stft
from ..ops.resample import resample_poly_np
from ..utils.native_audio import load_wav_fast


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


@dataclass
class SimRow:
    name: str
    wav_path: str
    timbre_path: str
    similarity: float


def read_meta_lst(path) -> List[Dict[str, str]]:
    """Parse ``name|style_text|timbre_path|text`` rows (``vc_from_dir``'s)."""
    rows = []
    for line in Path(path).read_text(encoding="utf-8").splitlines():
        if not line.strip():
            continue
        parts = line.split("|")
        if len(parts) != 4:
            raise ValueError(f"malformed meta.lst row: {line!r}")
        rows.append({"name": parts[0], "style_text": parts[1], "timbre_path": parts[2], "text": parts[3]})
    return rows


def score_meta_lst(engine, meta_lst_path, wav_dir, batch: int = 64) -> Dict:
    """Score every meta.lst row: cosine(spk(synthesized wav), spk(timbre
    wav)), ``batch`` rows a ``SpeakerScorer`` call. The synthesized wavs are
    ``wav_dir/{name}.wav``, the timbre wavs at the rows' paths (each loaded
    once). -> {"rows": [...], "summary": {n, mean, p50, min, max}}."""
    rows = read_meta_lst(meta_lst_path)
    scorer = SpeakerScorer(engine)
    sr = engine.cfg.audio.prompt_sample_rate
    out_rows: List[SimRow] = []
    timbre_cache: Dict[str, np.ndarray] = {}
    for s0 in range(0, len(rows), batch):
        chunk = rows[s0 : s0 + batch]
        paths = [Path(wav_dir) / (r["name"] if r["name"].endswith(".wav") else r["name"] + ".wav") for r in chunk]
        synth = [load_wav_fast(str(p), sr) for p in paths]
        for r in chunk:
            if r["timbre_path"] not in timbre_cache:
                timbre_cache[r["timbre_path"]] = load_wav_fast(r["timbre_path"], sr)
        sims = scorer.similarity(synth, [timbre_cache[r["timbre_path"]] for r in chunk])
        for r, s, p in zip(chunk, sims, paths):
            out_rows.append(SimRow(name=r["name"], wav_path=str(p), timbre_path=r["timbre_path"],
                                   similarity=float(s)))
    sims = np.array([r.similarity for r in out_rows], np.float64)
    stat = (lambda f: float(f(sims))) if sims.size else (lambda f: 0.0)
    summary = {"n": int(sims.size), "mean": stat(np.mean), "p50": stat(np.median), "min": stat(np.min),
               "max": stat(np.max)}
    return {"rows": [asdict(r) for r in out_rows], "summary": summary}


def write_report(path, report: Dict) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(report, indent=2, ensure_ascii=False))
