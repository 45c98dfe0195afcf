"""Text frontend: normalizer + self-contained byte-level tokenizer.

Replaces the CosyVoice text frontend (text normalization + tokenizer with
language tags <|zh|><|en|><|jp|><|yue|><|ko|>, reference usage basic.py:13 and
SURVEY §2.3.1 "Text frontend" row). Host-side, deterministic, no external
vocab files: UTF-8 bytes + special/tag tokens, emitting fixed-shape int32
buffers for the device. Byte-level keeps EN/ZH/JA/KO/YUE in one vocab with
zero OOV — the language tag carries the language prior instead of the
tokenizer.
"""

from __future__ import annotations

import re
import unicodedata
from typing import List, Optional, Tuple

import numpy as np

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
TASK_TTS = 3          # task tokens let one LM host multiple conditioning modes
TASK_VC = 4
LANG_TAGS = {"zh": 5, "en": 6, "jp": 7, "yue": 8, "ko": 9}
BYTE_OFFSET = 16
VOCAB_SIZE = BYTE_OFFSET + 256  # 272; TokenLMConfig.text_vocab_size must be >=

_TAG_RE = re.compile(r"<\|(zh|en|jp|yue|ko)\|>")

_PUNCT_MAP = {
    "。": ". ", "，": ", ", "、": ", ", "！": "! ", "？": "? ", "；": "; ",
    "：": ": ", "“": '"', "”": '"', "‘": "'", "’": "'", "（": " (", "）": ") ",
    "《": '"', "》": '"', "…": "... ", "—": "-", "·": " ",
}


def normalize(
    text: str, language: Optional[str] = None, numbers: bool = False
) -> str:
    """NFKC + CJK punctuation mapping + whitespace collapse; with
    numbers=True also verbalizes numerals/dates/abbreviations per segment
    language (models/textnorm.py — the reference engine's ttsfrd-class TN).
    Keeps language tags intact; each tagged segment normalizes under its own
    tag's language."""
    parts = []
    last = 0
    seg_lang = language
    for m in _TAG_RE.finditer(text):
        parts.append(_normalize_plain(text[last : m.start()], seg_lang, numbers))
        parts.append(m.group(0))
        seg_lang = m.group(1)
        last = m.end()
    parts.append(_normalize_plain(text[last:], seg_lang, numbers))
    return "".join(parts).strip()


def _normalize_plain(
    text: str, language: Optional[str] = None, numbers: bool = False
) -> str:
    text = unicodedata.normalize("NFKC", text)
    if numbers and text.strip():
        from .textnorm import normalize_numbers

        # TN runs before CJK-punct mapping so ZH date/time patterns still
        # see their original forms
        text = normalize_numbers(text, language or detect_language(text))
    for a, b in _PUNCT_MAP.items():
        text = text.replace(a, b)
    text = re.sub(r"\s+", " ", text)
    return text


def detect_language(text: str) -> str:
    """Char-class language guess for untagged input (reference passed explicit
    tags; we accept both)."""
    han = sum(1 for c in text if "一" <= c <= "鿿")
    kana = sum(1 for c in text if "぀" <= c <= "ヿ")
    hangul = sum(1 for c in text if "가" <= c <= "힯")
    if kana > 0:
        return "jp"
    if hangul > 0:
        return "ko"
    if han > 0:
        return "zh"
    return "en"


def _encode_segment_bytes(text: str) -> List[int]:
    return [BYTE_OFFSET + b for b in text.encode("utf-8")]


def encode(
    text: str,
    language: Optional[str] = None,
    add_bos: bool = True,
    add_eos: bool = True,
    tokenizer=None,
    numbers: bool = False,
) -> np.ndarray:
    """text -> int32 ids: [BOS] [lang tag] tokens... [EOS]. Inline <|xx|>
    tags become tag tokens at their position. `tokenizer` (a
    models.bpe.BPETokenizer) swaps the per-segment byte encoding for the
    trained vocab; `numbers=True` runs full TN first (the TTS path)."""
    text = normalize(text, language=language, numbers=numbers)
    seg = tokenizer.encode_segment if tokenizer is not None \
        else _encode_segment_bytes
    ids: List[int] = []
    if add_bos:
        ids.append(BOS_ID)
    # leading language tag
    m = _TAG_RE.match(text)
    if not m:
        lang = language or detect_language(text)
        ids.append(LANG_TAGS[lang])
    last = 0
    for m in _TAG_RE.finditer(text):
        ids.extend(seg(text[last : m.start()]))
        ids.append(LANG_TAGS[m.group(1)])
        last = m.end()
    ids.extend(seg(text[last:]))
    if add_eos:
        ids.append(EOS_ID)
    return np.asarray(ids, np.int32)


def decode(ids, tokenizer=None) -> str:
    """Best-effort inverse (drops specials/tags)."""
    if tokenizer is not None:
        return tokenizer.decode_segment(ids)
    bs = bytes(
        int(i) - BYTE_OFFSET for i in ids
        if BYTE_OFFSET <= int(i) < BYTE_OFFSET + 256
    )
    return bs.decode("utf-8", errors="replace")


def encode_batch(
    texts: List[str], languages: Optional[List[Optional[str]]] = None,
    width: Optional[int] = None,
    tokenizer=None,
    numbers: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> ([B, W] right-padded int32, [B] lengths)."""
    languages = languages or [None] * len(texts)
    seqs = [
        encode(t, l, tokenizer=tokenizer, numbers=numbers)
        for t, l in zip(texts, languages)
    ]
    lens = np.asarray([len(s) for s in seqs], np.int32)
    W = width or int(lens.max())
    out = np.full((len(seqs), W), PAD_ID, np.int32)
    for i, s in enumerate(seqs):
        if len(s) > W:  # keep the sequence terminal: EOS survives truncation
            s = np.concatenate([s[: W - 1], [EOS_ID]]).astype(np.int32)
        out[i, : len(s)] = s
    return out, np.minimum(lens, W)


def make_tokenizer(fcfg):
    """FrontendConfig -> segment tokenizer (None = byte fallback)."""
    if fcfg is None or getattr(fcfg, "tokenizer", "byte") == "byte":
        return None
    if fcfg.tokenizer == "bpe":
        from .bpe import BPETokenizer

        if not fcfg.bpe_path:
            raise ValueError("frontend.tokenizer='bpe' needs frontend.bpe_path")
        return BPETokenizer.load(fcfg.bpe_path)
    raise ValueError(f"unknown frontend.tokenizer: {fcfg.tokenizer!r}")


def vocab_size(tokenizer=None) -> int:
    return VOCAB_SIZE if tokenizer is None else tokenizer.vocab_size
