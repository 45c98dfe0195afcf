"""Acoustic training data: (wav, text) manifests -> device batches.

Counterpart of the JAX ``train/data.py``. A manifest of {"wav": path,
"text": str[, "speaker": str][, "phn": path]} rows is decoded and
resampled (``utils/native_audio.load_wav_fast``), featurized once by the
port's ``Engine.prompt_features`` (on the card: the log-mel kernel at both
rates, the speech tokenizer and the speaker encoder) and assembled into the
batch dicts the ``train/acoustic.py`` steps take, as tensors on the
engine's device:

- token LM: text tokens + style-prompt tokens (the utterance's own first
  ``prompt_seconds``) -> continuation targets;
- CFM: the whole token sequence -> mel regression with the prompt given;
- vocoder: fixed-length mel -> waveform crops;
- tokenizer: raw 16 kHz wavs and 25 Hz phoneme labels.

Shapes are padded to whole seconds of tokens, so a corpus gives a handful
of batch shapes.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..models import frontend
from ..utils.manifest import read_json, read_jsonl


@dataclass
class AcousticItem:
    wav_path: str
    text: str
    speaker: str = ""
    phn_path: str = ""   # optional 25 Hz phoneme-label .npy (tokenizer stage)


def load_acoustic_manifest(path: str, wav_dir: str = "") -> List[AcousticItem]:
    """JSON list or JSONL of {wav|wav_path|file_id, text|zh_text[, speaker]}."""
    p = Path(path)
    rows = read_jsonl(p) if p.suffix == ".jsonl" else read_json(p)
    if isinstance(rows, dict):
        rows = list(rows.values())
    items = []
    for r in rows:
        wav = r.get("wav") or r.get("wav_path") or r.get("file_id", "")
        phn = r.get("phn", "")
        if wav_dir:
            wav = str(Path(wav_dir) / (wav if wav.endswith(".wav") else wav + ".wav"))
            if phn:
                phn = str(Path(wav_dir) / phn)
        items.append(
            AcousticItem(
                wav_path=wav,
                text=r.get("text", r.get("zh_text", "")),
                speaker=str(r.get("speaker", "")),
                phn_path=phn,
            )
        )
    return items


def _load_wavs(paths: List[str], target_sr: int) -> List[np.ndarray]:
    from ..utils.native_audio import load_wav_fast

    return [load_wav_fast(p, target_sr) for p in paths]


def make_acoustic_batches(
    engine,
    items: List[AcousticItem],
    batch_size: int,
    prompt_seconds: float = 3.0,
    text_width: int = 128,
    seed: int = 0,
    shuffle: bool = True,
    stages: tuple = ("tokenizer", "token_lm", "cfm", "vocoder"),
    cache: Optional[Dict[int, tuple]] = None,
    cache_max_items: int = 20000,
    vocoder_segment_frames: int = 50,
) -> Iterator[Dict[str, Dict]]:
    """Yields batch dicts keyed by the requested `stages`.

    `cache`: optional {item index: (wav, feats-or-None)} dict that persists
    ACROSS epochs — wav decode and prompt featurization run once per item,
    not once per (item, epoch). The tokenizer stage needs no features, so
    it never featurizes. `cache_max_items` bounds host RAM (FIFO eviction):
    a corpus beyond it re-featurizes the overflow each epoch."""
    cfg = engine.cfg
    dev = engine.device

    def as_tensor(a):
        return torch.as_tensor(a, device=dev)

    a = cfg.audio
    rate = cfg.token_lm.token_rate
    prompt_tokens_n = int(prompt_seconds * rate)
    up = cfg.cfm.upsample
    need_feats = any(s in stages for s in ("token_lm", "cfm", "vocoder"))
    if cache is None:
        cache = {}

    rng = np.random.default_rng(seed)
    if shuffle:
        # length-grouped batching: sort by a duration proxy (text length)
        # with jitter, batch neighbours, then shuffle batch ORDER — batches
        # stay length-homogeneous (less padding) while epochs still vary
        proxy = np.array([len(it.text) for it in items], np.float64)
        proxy = proxy + rng.normal(0, max(proxy.std(), 1.0) * 0.1, proxy.shape)
        order = np.argsort(proxy)
        starts = list(range(0, len(order) - batch_size + 1, batch_size))
        rng.shuffle(starts)
    else:
        order = np.arange(len(items))
        starts = list(range(0, len(order) - batch_size + 1, batch_size))
    for s0 in starts:
        idx = order[s0 : s0 + batch_size]
        chunk = [items[i] for i in idx]
        missing = [int(i) for i in idx if int(i) not in cache]
        if missing:
            new_wavs = _load_wavs(
                [items[i].wav_path for i in missing], a.prompt_sample_rate
            )
            new_feats = (
                engine.prompt_features(new_wavs) if need_feats
                else [None] * len(new_wavs)
            )
            for i, w, f in zip(missing, new_wavs, new_feats):
                if len(cache) >= cache_max_items:
                    cache.pop(next(iter(cache)))   # FIFO eviction
                cache[i] = (w, f)
        wavs = [cache[int(i)][0] for i in idx]
        feats = [cache[int(i)][1] for i in idx]
        B = len(chunk)

        sub = int(np.prod(cfg.speech_tokenizer.strides))
        hop_tokens = sub * a.prompt_hop_length  # 16 kHz samples per token
        if need_feats:
            T_tok = max(len(f.tokens) for f in feats)
        else:
            T_tok = max(1, max(len(w) for w in wavs) // hop_tokens)
        # round T_tok up to 1-second multiples: a handful of static batch
        # shapes per corpus instead of one compile per distinct max-length
        T_tok = max(rate, ((T_tok + rate - 1) // rate) * rate)
        out: Dict[str, Dict] = {}

        if need_feats:
            text_ids, text_lens = frontend.encode_batch(
                [c.text for c in chunk], width=text_width,
                tokenizer=getattr(engine, "text_tokenizer", None),
                numbers=getattr(engine, "normalize_numbers", False),
            )
            tokens = np.zeros((B, T_tok), np.int32)
            tok_lens = np.zeros((B,), np.int32)
            F = T_tok * up
            M = cfg.cfm.n_mels
            mel = np.zeros((B, F, M), np.float32)
            spk = np.zeros((B, feats[0].spk.shape[0]), np.float32)
            prompt_mask = np.zeros((B, F), np.float32)
            frame_mask = np.zeros((B, F), np.float32)
            sty = np.zeros((B, min(prompt_tokens_n, T_tok)), np.int32)
            sty_lens = np.zeros((B,), np.int32)
            tgt_w = max(T_tok - prompt_tokens_n, 1)
            targets = np.zeros((B, tgt_w), np.int32)
            tgt_lens = np.zeros((B,), np.int32)
            for i, f in enumerate(feats):
                n = len(f.tokens)
                tokens[i, :n] = f.tokens
                tok_lens[i] = n
                nm = min(f.mel24.shape[0], n * up)
                mel[i, :nm] = f.mel24[:nm]
                spk[i] = f.spk
                n_p = min(prompt_tokens_n, max(n // 2, 1))
                prompt_mask[i, : n_p * up] = 1.0
                frame_mask[i, : n * up] = 1.0
                sty[i, :n_p] = f.tokens[:n_p]
                sty_lens[i] = n_p
                n_t = min(n - n_p, tgt_w)
                targets[i, :n_t] = f.tokens[n_p : n_p + n_t]
                tgt_lens[i] = n_t
            out["token_lm"] = {
                "text": as_tensor(text_ids), "text_len": as_tensor(text_lens),
                "style_tokens": as_tensor(sty), "style_len": as_tensor(sty_lens),
                "spk": as_tensor(spk),
                "targets": as_tensor(targets), "target_len": as_tensor(tgt_lens),
            }
            out["cfm"] = {
                "tokens": as_tensor(tokens), "mel": as_tensor(mel),
                "spk": as_tensor(spk),
                "prompt_mask": as_tensor(prompt_mask),
                "frame_mask": as_tensor(frame_mask),
            }

        if "vocoder" in stages:
            # standard HiFi-GAN recipe: train on fixed 1 s random crops, not
            # whole utterances — same gradient signal per sample at ~1/8 the
            # discriminator compute, and ONE static shape for every batch
            from ..ops.resample import resample_poly_np

            seg = vocoder_segment_frames
            hop = a.hop_length
            M = cfg.cfm.n_mels
            mel_seg = np.zeros((B, seg, M), np.float32)
            wav_seg = np.zeros((B, seg * hop), np.float32)
            for i, (f, w) in enumerate(zip(feats, wavs)):
                w24 = resample_poly_np(w, a.prompt_sample_rate, a.sample_rate)
                n_frames = min(f.mel24.shape[0], len(w24) // hop)
                start = 0 if n_frames <= seg else int(
                    rng.integers(0, n_frames - seg + 1))
                n = min(seg, n_frames)
                mel_seg[i, :n] = f.mel24[start : start + n]
                wav_seg[i, : n * hop] = w24[start * hop : (start + n) * hop]
            out["vocoder"] = {
                "mel": as_tensor(mel_seg), "wav": as_tensor(wav_seg),
            }

        if "tokenizer" in stages:
            # raw 16 kHz wavs + 25 Hz phoneme labels (aligned to tokens:
            # T_tok tokens cover T_tok * strides * hop samples)
            T16 = T_tok * hop_tokens
            wav16 = np.zeros((B, T16), np.float32)
            lens16 = np.zeros((B,), np.int32)
            phn = np.zeros((B, T_tok), np.int32)
            for i, (c, w) in enumerate(zip(chunk, wavs)):
                m = min(len(w), T16)
                wav16[i, :m] = w[:m]
                lens16[i] = m
                if c.phn_path:
                    lab = np.load(c.phn_path)
                    n = min(len(lab), T_tok)
                    phn[i, :n] = lab[:n]
            out["tokenizer"] = {
                "wav16": as_tensor(wav16), "len": as_tensor(lens16),
                "phn": as_tensor(phn),
            }

        yield out
