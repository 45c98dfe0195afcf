"""Quality proxies that need no listener.

Counterpart of the JAX ``pipeline/simeval.py``: ``SpeakerScorer``,
``token_round_trip``, the manifest scoring (``read_meta_lst``,
``score_meta_lst``, ``write_report``), the style DB's ``retrieval_report``
and the phoneme evaluation (``levenshtein``, ``collapse_phoneme_frames``,
``text_to_phoneme_ids``, ``PhonemeRecognizer``, ``fit_code_map``,
``phoneme_error_rate``). Wavs are featurized through
``stft.log_mel_spectrogram``, which on the card launches the fused log-mel
kernel.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import speaker
from ..models import speech_tokenizer as st_lib
from ..ops import stft
from ..ops.resample import resample_poly_np
from ..utils.native_audio import load_wav_fast


def _bucket(n: int, buckets: Sequence[int]) -> int:
    return next((b for b in buckets if n <= b), buckets[-1])


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
        T = _bucket(max(lens), self._buckets)
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


# --------------------------------------------------------------- retrieval QA


def retrieval_report(store, k: int = 5, reference_band=(0.83, 0.88)) -> Dict:
    """Retrieval-quality report over a StyleStore.

    - self-recall@k: the share of rows whose self-query ranks themselves (or
      a perfect-score tie) in the top k -- 1.0 on a healthy store;
    - the top-1 cross cosine: for each row, the best OTHER row's cosine, the
      analogue of the reference's production query distances (~0.83-0.88),
      reported against that band.
    """
    n = len(store.meta)
    if n == 0:
        return {"n": 0, "recall_at_k": 1.0, "cross_top1": {}, "k": k}
    hit = 0
    cross: List[float] = []
    chunk = 1024
    for s0 in range(0, n, chunk):
        s1 = min(s0 + chunk, n)
        rows = store.db[s0:s1].cpu().numpy()
        kk = min(k + 1, n)
        scores, idx = store.search_arrays(rows, k=kk)
        for qi in range(s1 - s0):
            row = s0 + qi
            in_topk = (idx[qi, :k] == row).any() or (scores[qi, :k] >= 1.0 - 1e-4).any()
            hit += bool(in_topk)
            others = [float(scores[qi, j]) for j in range(kk) if idx[qi, j] != row]
            if others:
                cross.append(max(others))
    cross_arr = np.array(cross, np.float64)
    lo, hi = reference_band
    stat = (lambda f: float(f(cross_arr))) if cross_arr.size else (lambda f: 0.0)
    return {
        "n": n,
        "k": k,
        "recall_at_k": hit / n,
        "cross_top1": {
            "mean": stat(np.mean), "p50": stat(np.median), "min": stat(np.min), "max": stat(np.max),
            "frac_in_reference_band": stat(lambda c: ((c >= lo) & (c <= hi)).mean()),
        },
        "reference_band": [lo, hi],
    }


# ---------------------------------------------------------- phoneme evaluation


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance between two sequences (insert/delete/substitute = 1)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


def collapse_phoneme_frames(frame_ids: Sequence[int]) -> List[int]:
    """Frame-level phoneme ids -> the phoneme sequence: consecutive repeats
    merged, silence (id 0) dropped (the corpus labels are exact alignments,
    so the framewise recognizer needs no CTC blank)."""
    out: List[int] = []
    prev = None
    for f in frame_ids:
        f = int(f)
        if f != prev and f != 0:
            out.append(f)
        prev = f
    return out


def text_to_phoneme_ids(text: str) -> List[int]:
    """Corpus orthography (phoneme letters, space-separated pseudo-words,
    ``train/synthcorpus.py``) -> the expected phoneme-id sequence."""
    from ..train.synthcorpus import PHONE_ID

    return [PHONE_ID[c] for c in text if c in PHONE_ID]


class PhonemeRecognizer:
    """Framewise phoneme transcriber on the engine's frozen speech
    tokenizer, in one of two kinds, both fitted without touching the
    engine's weights:

    - ``code_map`` [codebook_size] int: VQ code -> phoneme id by majority
      vote over an aligned corpus (``fit_code_map``);
    - ``head`` [D, n_classes] float: a linear phoneme head on the pre-VQ
      features (``train_acoustic --stage phn_head``).

    A wav is padded to a length bucket (1, 2, 4, 8, 16 or ``max_seconds``
    seconds at the prompt rate), featurized (the log-mel kernel on the
    card), tokenized, mapped to phoneme ids frame by frame (masked frames to
    silence) and collapsed."""

    def __init__(self, engine, head: Optional[np.ndarray] = None, code_map: Optional[np.ndarray] = None,
                 max_seconds: float = 30.0):
        if head is None and code_map is None:
            raise ValueError("need head and/or code_map")
        self.engine = engine
        a = engine.cfg.audio
        self._buckets = tuple(a.prompt_sample_rate * s for s in (1, 2, 4, 8, 16, int(max_seconds)))
        self._code_map = None if code_map is None else engine._tensor(code_map, torch.int64)
        self._head = None if head is None else engine._tensor(head, torch.float32)

    @torch.no_grad()
    def frame_ids(self, wav16: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
        """[B, T] prompt-rate wavs with their [B] lengths -> [B, T_tok]
        phoneme ids, 0 on masked frames."""
        eng = self.engine
        a = eng.cfg.audio
        mel16 = stft.log_mel_spectrogram(
            wav16, a.prompt_sample_rate, a.prompt_n_fft, a.prompt_hop_length, a.prompt_win_length,
            n_mels=a.prompt_n_mels, fmax=a.prompt_fmax)
        frames = torch.arange(mel16.shape[1], device=mel16.device)[None, :]
        fmask = (frames < length.long()[:, None] // a.prompt_hop_length + 1).float()
        res = st_lib.apply(eng.params.speech_tokenizer, eng.cfg.speech_tokenizer, mel16, fmask)
        if self._code_map is not None:
            ids = self._code_map[res.tokens.long()]
        else:
            ids = torch.argmax(res.pre_vq.float() @ self._head, dim=-1)
        return torch.where(res.token_mask, ids, torch.zeros_like(ids))

    def transcribe(self, wav: np.ndarray, rate: Optional[int] = None) -> List[int]:
        """wav (at ``rate``, default ``audio.sample_rate``) -> phoneme-id sequence."""
        eng = self.engine
        a = eng.cfg.audio
        w = np.asarray(wav, np.float32).ravel()
        rate = rate or a.sample_rate
        if rate != a.prompt_sample_rate:
            w = resample_poly_np(w, rate, a.prompt_sample_rate)
        T = _bucket(len(w), self._buckets)
        buf = np.zeros((1, T), np.float32)
        buf[0, : min(len(w), T)] = w[:T]
        ids = self.frame_ids(eng._tensor(buf, torch.float32), eng._tensor([len(w)], torch.int64))
        return collapse_phoneme_frames(ids[0].cpu().numpy())


def fit_code_map(engine, wavs_16k: Sequence[np.ndarray], phn_labels: Sequence[np.ndarray],
                 codebook_size: Optional[int] = None, batch: int = 64) -> np.ndarray:
    """VQ code -> phoneme id by majority vote over aligned (wav, labels)
    pairs (labels at the 25 Hz token rate, ``train/synthcorpus.py``), for
    ``PhonemeRecognizer(code_map=...)``. No gradients, no change to the
    engine; codes never seen map to silence (0). ``batch`` wavs a
    ``prompt_features`` call."""
    V = codebook_size or engine.cfg.speech_tokenizer.codebook_size
    votes = np.zeros((V, 64), np.int64)   # 64 >> any phoneme inventory
    wavs = [np.asarray(w, np.float32) for w in wavs_16k]
    for s in range(0, len(wavs), batch):
        feats = engine.prompt_features(wavs[s : s + batch])
        for f, phn in zip(feats, phn_labels[s : s + batch]):
            phn = np.asarray(phn, np.int64).ravel()
            n = min(len(f.tokens), len(phn))
            np.add.at(votes, (f.tokens[:n], np.clip(phn[:n], 0, 63)), 1)
    code_map = votes.argmax(-1).astype(np.int32)
    code_map[votes.sum(-1) == 0] = 0
    return code_map


def phoneme_error_rate(recognizer: PhonemeRecognizer, wav_out: np.ndarray, text: str) -> float:
    """PER of synthesized audio against its input text (corpus orthography):
    levenshtein(transcribed, expected) / len(expected)."""
    expected = text_to_phoneme_ids(text)
    if not expected:
        raise ValueError(f"text encodes no corpus phonemes: {text!r}")
    pred = recognizer.transcribe(wav_out)
    return levenshtein(pred, expected) / len(expected)
