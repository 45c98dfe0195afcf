"""Formant-synthesis speech corpus generator (source-filter model).

The port's own copy of the JAX ``train/synthcorpus.py`` (numpy): the same
seed gives bitwise the same wavs, 25 Hz phoneme labels and manifest.
Klatt-style source-filter synthesis (a glottal pulse train or noise shaped
by per-phoneme formant resonators) yields speech-like audio with exact text
and frame-level phoneme alignment, the supervision that makes the speech
tokens phonetic (``train/acoustic.make_tokenizer_step``).

Each utterance: pseudo-words of CV(C) syllables over an 18-phoneme
inventory, spelled with the phoneme letters. Each speaker: base F0, a
vocal-tract (formant) scale and breathiness.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

SR = 16000          # native rate: the prompt rate; all formants live < 8 kHz
TOKEN_RATE = 25     # phoneme frame labels at the speech-token rate (25 Hz)

# phoneme -> (F1, F2, F3, kind); kinds: v=vowel, n=nasal, f=fricative,
# s=stop, l=liquid. Formant values are classic male averages.
PHONES: Dict[str, Tuple[float, float, float, str]] = {
    "a": (730, 1090, 2440, "v"),
    "e": (530, 1840, 2480, "v"),
    "i": (270, 2290, 3010, "v"),
    "o": (570, 840, 2410, "v"),
    "u": (300, 870, 2240, "v"),
    "m": (250, 1000, 2200, "n"),
    "n": (250, 1700, 2600, "n"),
    "l": (360, 1300, 2700, "l"),
    "r": (310, 1060, 1380, "l"),
    "s": (0, 5000, 7000, "f"),
    "f": (0, 1400, 4500, "f"),
    "h": (500, 1500, 2500, "f"),
    "t": (0, 4000, 6000, "s"),
    "k": (0, 1800, 3500, "s"),
    "p": (0, 800, 2000, "s"),
    "b": (200, 800, 2000, "s"),
    "d": (200, 2500, 3500, "s"),
    "g": (200, 1800, 3000, "s"),
}
PHONE_LIST = sorted(PHONES)          # stable ids
PHONE_ID = {p: i + 1 for i, p in enumerate(PHONE_LIST)}  # 0 = silence
N_PHONEME_CLASSES = len(PHONE_LIST) + 1

_CONS = [p for p, v in PHONES.items() if v[3] in "nfsl"]
_VOWELS = [p for p, v in PHONES.items() if v[3] == "v"]


@dataclass
class Speaker:
    name: str
    f0: float            # base pitch, Hz
    scale: float         # vocal-tract length factor on formants
    breath: float        # aspiration noise mix


def _resonator(sig: np.ndarray, freq: float, bw: float, sr: int) -> np.ndarray:
    """2nd-order IIR resonator (digital formant filter)."""
    if freq <= 0 or freq >= sr / 2:
        return sig
    r = np.exp(-np.pi * bw / sr)
    theta = 2 * np.pi * freq / sr
    a1, a2 = -2 * r * np.cos(theta), r * r
    b0 = 1 - r  # unity-ish gain at resonance
    out = np.empty_like(sig)
    x1 = x2 = 0.0
    # scipy.signal.lfilter equivalent; import lazily to keep numpy-only fallback
    try:
        from scipy.signal import lfilter

        return lfilter([b0], [1.0, a1, a2], sig).astype(np.float32)
    except Exception:  # pragma: no cover - scipy is in the image
        y1 = y2 = 0.0
        for i, x in enumerate(sig):
            y = b0 * x - a1 * y1 - a2 * y2
            out[i] = y
            y2, y1 = y1, y
        return out


def _glottal(n: int, f0: np.ndarray, sr: int, rng) -> np.ndarray:
    """Pulse-train source with shimmer/jitter; f0 per sample."""
    phase = np.cumsum(f0 / sr)
    # soft glottal pulse: rectified-cosine power (sharper than sine = richer
    # harmonics for the resonators to shape)
    x = np.maximum(0.0, np.cos(2 * np.pi * phase)) ** 6
    x = x - x.mean()
    x *= 1.0 + 0.05 * rng.standard_normal(n)  # shimmer
    return x.astype(np.float32)


def synth_phone(
    phone: str, dur_s: float, spk: Speaker, f0_seg: np.ndarray, rng,
) -> np.ndarray:
    n = max(int(dur_s * SR), 8)
    f1, f2, f3, kind = PHONES[phone]
    f1, f2, f3 = f1 * spk.scale, f2 * spk.scale, f3 * spk.scale
    if kind in ("v", "n", "l"):
        f0 = np.interp(np.linspace(0, 1, n), [0, 1], f0_seg)
        src = _glottal(n, f0, SR, rng)
        src = src + spk.breath * 0.15 * rng.standard_normal(n).astype(np.float32)
        amp = 1.0 if kind == "v" else 0.5
        out = (
            _resonator(src, f1, 60, SR)
            + 0.7 * _resonator(src, f2, 90, SR)
            + 0.3 * _resonator(src, f3, 150, SR)
        ) * amp
    elif kind == "f":
        src = rng.standard_normal(n).astype(np.float32)
        out = 0.25 * _resonator(src, f2, 900, SR) + \
            0.15 * _resonator(src, f3, 1200, SR)
    else:  # stop: closure silence + burst + short aspiration
        out = np.zeros(n, np.float32)
        closure = int(0.6 * n)
        burst = rng.standard_normal(max(n - closure, 4)).astype(np.float32)
        burst *= np.exp(-np.arange(burst.size) / (0.012 * SR))
        out[closure:] = 0.5 * (
            _resonator(burst, f2, 800, SR) + _resonator(burst, f3, 1100, SR)
        )[: n - closure]
    # 5 ms edge fades prevent clicks at phone boundaries
    fade = min(int(0.005 * SR), n // 4)
    if fade:
        out[:fade] *= np.linspace(0, 1, fade)
        out[-fade:] *= np.linspace(1, 0, fade)
    return out


def synth_utterance(
    words: List[str], spk: Speaker, rng,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (wav [T] float32 @16k, phoneme ids at 25 Hz [T_tok])."""
    segs: List[np.ndarray] = []
    labels: List[Tuple[int, int]] = []  # (phone_id, n_samples)
    n_ph = sum(len(w) for w in words)
    pitch_hi, pitch_lo = spk.f0 * 1.15, spk.f0 * 0.85
    idx = 0
    for wi, word in enumerate(words):
        accent = 1.12 if wi % 2 == 0 else 1.0  # alternating word accent
        for ph in word:
            frac0 = idx / max(n_ph, 1)
            idx += 1
            frac1 = idx / max(n_ph, 1)
            f0a = (pitch_hi + (pitch_lo - pitch_hi) * frac0) * accent
            f0b = (pitch_hi + (pitch_lo - pitch_hi) * frac1) * accent
            kind = PHONES[ph][3]
            dur = rng.uniform(0.12, 0.2) if kind == "v" else \
                rng.uniform(0.05, 0.1)
            seg = synth_phone(ph, dur, spk, np.array([f0a, f0b]), rng)
            segs.append(seg)
            labels.append((PHONE_ID[ph], seg.size))
        pause = np.zeros(int(rng.uniform(0.06, 0.14) * SR), np.float32)
        segs.append(pause)
        labels.append((0, pause.size))
    wav = np.concatenate(segs)
    peak = np.abs(wav).max()
    if peak > 0:
        wav = 0.5 * wav / peak
    # frame labels @ 25 Hz: majority phone per 40 ms window
    hop = SR // TOKEN_RATE
    n_tok = wav.size // hop
    phn = np.zeros(n_tok, np.int32)
    bounds = np.cumsum([0] + [n for _, n in labels])
    ids = np.array([p for p, _ in labels], np.int32)
    for t in range(n_tok):
        center = t * hop + hop // 2
        phn[t] = ids[np.searchsorted(bounds, center, "right") - 1]
    return wav.astype(np.float32), phn


def make_speakers(n: int, rng) -> List[Speaker]:
    out = []
    for i in range(n):
        out.append(Speaker(
            name=f"spk{i}",
            f0=float(rng.uniform(95, 240)),
            scale=float(rng.uniform(0.85, 1.18)),
            breath=float(rng.uniform(0.0, 0.6)),
        ))
    return out


def random_words(rng, n_words: int) -> List[str]:
    words = []
    for _ in range(n_words):
        sylls = []
        for _ in range(rng.integers(1, 4)):
            s = rng.choice(_CONS) + rng.choice(_VOWELS)
            if rng.random() < 0.25:
                s += rng.choice(["n", "m", "s", "l"])
            sylls.append(s)
        words.append("".join(sylls))
    return words


def generate_corpus(
    out_dir, n_utts: int = 1200, n_speakers: int = 24, seed: int = 0,
    min_words: int = 2, max_words: int = 6,
) -> str:
    """Write wavs + 25 Hz phoneme labels + manifest.json; returns manifest
    path. Manifest rows: {wav, text, speaker, phn} (all paths relative to
    out_dir, resolved by --wav_dir)."""
    from ..utils.audio_io import write_wav

    out = Path(out_dir)
    (out / "wavs").mkdir(parents=True, exist_ok=True)
    (out / "phn").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    speakers = make_speakers(n_speakers, rng)
    rows = []
    for i in range(n_utts):
        spk = speakers[i % n_speakers]
        words = random_words(rng, int(rng.integers(min_words, max_words + 1)))
        wav, phn = synth_utterance(words, spk, rng)
        name = f"utt{i:05d}"
        write_wav(out / "wavs" / f"{name}.wav", wav, SR)
        np.save(out / "phn" / f"{name}.npy", phn)
        rows.append({
            "wav": f"wavs/{name}.wav",
            "text": " ".join(words),
            "speaker": spk.name,
            "phn": f"phn/{name}.npy",
        })
    manifest = out / "manifest.json"
    manifest.write_text(json.dumps(rows, indent=1))
    (out / "speakers.json").write_text(json.dumps(
        [s.__dict__ for s in speakers], indent=1))
    return str(manifest)
