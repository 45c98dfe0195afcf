"""The one traffic generator: reads a mix file (``workloads/<name>.json``)
and the run's seed and yields the requests, the style DB's rows and the
prompt wavs.

Every seed gives the same multiset of sizes, in another order: the target
lengths come in blocks (``lengths.blocks``), taken in turn. A block is
either the counts of each length in speech tokens, shuffled whole by the
seed, or a list of such groups (one a batch), taken in the listed order,
each group shuffled by the seed: every seed then serves batches of the
same sizes, so the seed does not change the work. The DB's and the pool's wav durations are a fixed even spread over
``wav_seconds``, assigned in a seeded order. What the seed draws freely is
content: words, query vectors, wav signals, shifts and gains, CFM noise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

WORDS = Path(__file__).resolve().parent / "words.txt"
TEXT_CHARS = 340          # a request's text, at most (with a style transcript it stays under 512 bytes)
TRANSCRIPT_CHARS = 160    # a style row's transcript, at most


def synthetic_wav(rng: np.random.Generator, seconds: float, sr: int) -> np.ndarray:
    """A stand-in for a prompt recording: five sinusoids with slow
    amplitude envelopes plus noise, in [-1, 1]."""
    t = np.arange(int(round(seconds * sr))) / sr
    x = 0.02 * rng.standard_normal(t.shape)
    for _ in range(5):
        f0, a, fm = rng.uniform(90, 3000), rng.uniform(0.05, 0.2), rng.uniform(0.5, 4.0)
        x += a * (0.6 + 0.4 * np.sin(2 * np.pi * fm * t)) * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 6.28))
    return np.clip(x, -1.0, 1.0).astype(np.float32)


def groups(block) -> List[Dict]:
    """A block of ``lengths.blocks`` as its list of groups (a lone dict is one group)."""
    return list(block) if isinstance(block, list) else [block]


def lengths(mix: Dict) -> set:
    """Every target length a mix draws."""
    return {int(n) for blk in mix["lengths"]["blocks"] for g in groups(blk) for n in g}


@dataclass
class Request:
    index: int
    target: int                            # speech tokens the request asks for
    text: str
    query: Optional[np.ndarray] = None     # style-DB query (prompts "db")
    wavs: List[np.ndarray] = field(default_factory=list)   # [style, timbre] at 16 kHz (prompts "wav")
    wav_ids: List[int] = field(default_factory=list)


class Traffic:
    def __init__(self, mix: Dict, seed: int, prompt_sr: int = 16000):
        self.mix = mix
        self.seed = int(seed)
        self.sr = prompt_sr
        self.words = WORDS.read_text().split()

    def rng(self, stream: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, stream])

    # ------------------------------------------------------------------ sizes

    def targets(self) -> Iterator[int]:
        """Target lengths in speech tokens, block after block."""
        rng = self.rng(1)
        while True:
            for blk in self.mix["lengths"]["blocks"]:
                for group in groups(blk):
                    seq = [int(n) for n, c in group.items() for _ in range(int(c))]
                    yield from (seq[i] for i in rng.permutation(len(seq)))

    def text(self, rng: np.random.Generator, n_words: int, max_chars: int) -> str:
        words = [self.words[i] for i in rng.integers(0, len(self.words), max(n_words, 1))]
        out = words[0].capitalize()
        for w in words[1:]:
            if len(out) + len(w) + 2 > max_chars:
                break
            out += " " + w
        return out + "."

    def n_words(self, seconds: float) -> int:
        return int(round(self.mix["words_per_second"] * seconds))

    # ------------------------------------------------------------------ prompts

    def durations(self, n: int, lo_hi, stream: int) -> np.ndarray:
        lo, hi = lo_hi
        return np.linspace(lo, hi, n)[self.rng(stream).permutation(n)]

    def db_rows(self) -> Dict:
        """The style DB: vectors [rows, dim], a transcript a row, and the
        ``wavs`` prompt recordings cycled over the rows (row i holds wav
        i mod wavs)."""
        db = self.mix["db"]
        rng = self.rng(2)
        secs = self.durations(db["wavs"], db["wav_seconds"], 3)
        wavs = [synthetic_wav(rng, s, self.sr) for s in secs]
        scripts = [self.text(rng, self.n_words(s), TRANSCRIPT_CHARS) for s in secs]
        vecs = self.rng(4).standard_normal((db["rows"], db["dim"]), dtype=np.float32)
        rows = np.arange(db["rows"]) % db["wavs"]
        return {"vectors": vecs, "wavs": wavs, "wav_of_row": rows,
                "transcripts": [scripts[j] for j in rows]}

    def wav_pool(self) -> List[np.ndarray]:
        pool = self.mix["wav_pool"]
        rng = self.rng(5)
        return [synthetic_wav(rng, s, self.sr) for s in self.durations(pool["wavs"], pool["wav_seconds"], 6)]

    # ------------------------------------------------------------------ requests

    def requests(self, pool: Optional[List[np.ndarray]] = None) -> Iterator[Request]:
        """The requests in arrival order. Prompts "db": each carries a
        query of the DB's width; prompts "wav": a style and a timbre wav
        from ``pool``, each with its own circular shift and gain."""
        rng_text, rng_q, rng_w = self.rng(7), self.rng(8), self.rng(9)
        rate = self.mix["token_rate"]
        kind = self.mix["prompts"]
        for i, target in enumerate(self.targets()):
            req = Request(index=i, target=target,
                          text=self.text(rng_text, self.n_words(target / rate), TEXT_CHARS))
            if kind == "db":
                req.query = rng_q.standard_normal(self.mix["db"]["dim"], dtype=np.float32)
            elif kind == "wav":
                lo, hi = self.mix["wav_pool"]["gain"]
                ids = rng_w.choice(len(pool), 2, replace=False)
                for j in ids:
                    w = pool[int(j)]
                    req.wavs.append((np.roll(w, int(rng_w.integers(len(w)))) * rng_w.uniform(lo, hi)).astype(np.float32))
                req.wav_ids = [int(j) for j in ids]
            else:
                raise ValueError(f"unknown prompts kind {kind!r}")
            yield req

    def noise_bank(self, batch: int, frames: int, n_mels: int) -> np.ndarray:
        """[noise_bank, batch, frames, n_mels] standard-normal CFM noise;
        request (or batch) i takes entry i mod noise_bank, cut to its frames."""
        n = self.mix["noise_bank"]
        return self.rng(10).standard_normal((n, batch, frames, n_mels), dtype=np.float32)
