"""Synthesis engine: requests whose prompts are wavs or style-DB rows.

Counterpart of the JAX ``pipeline/engine.py`` for its non-streaming entry
points (``inference_tts_with_st``, ``inference_zero_shot``,
``inference_sft`` with ``register_speaker`` / ``save_speakers`` /
``load_speakers``, ``inference_vc``, ``synthesize_batch``,
``synthesize_from_tokens``), all through the staged ``_synthesize`` (the
reference's fused B=1 program, ``_synthesize_one``, exists to save
dispatches; the stages and their results are the same):

0. for a wav prompt, ``prompt_features`` -> ``featurize``: 16 kHz log-mel
   (fused log-mel kernel) -> speech tokenizer + speaker encoder; resample to
   24 kHz -> 24 kHz log-mel (the kernel again);
1. token-LM prefill (flash-attention kernel) and decode: the decode-step
   kernel (int8 or, with ``cfg.quantize_lm_int4``, int4) for a B=1
   request on an int8 LM whose widths it takes (H = K among them), else the
   scanned decode (a batch, a dense or GQA LM; an int8 KV cache with
   ``cfg.quantize_lm_kv_int8``); voice conversion skips the LM;
2. flow-conditioning assembly and the CFM Euler solve (``mel_body``),
3. the vocoder (iSTFT or HiFi-GAN) and the crop to each row's generated
   region, fetched to the host once.

The engine returns f32 wavs. The STYLE prompt drives the LM prosody prefix;
the TIMBRE prompt supplies the speaker embedding and the flow prompt
(tokens + mel). Streaming and speculative decoding raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import cfm, frontend, speaker, speech_tokenizer, token_lm, vocoder
from ..ops import decode_step, stft
from ..ops.resample import resample
from ..retrieval.store import StyleStore
from ..utils.config import Config
from ..utils.device import DeviceLike, resolve_device
from ..utils.timing import Stopwatch
from ..weights import init_params, quantize_tree, to_device

TEXT_BUCKETS = (32, 64, 128, 256, 512)
TOKEN_BUCKETS = (32, 64, 128, 256)
GEN_BUCKETS = (64, 128, 256, 512)
PROMPT_SECONDS = (1, 2, 4, 8, 16, 30)   # prompt wavs are padded to one of these lengths


def _bucket(n: int, buckets: Sequence[int]) -> int:
    i = bisect.bisect_left(buckets, max(n, 1))
    return buckets[min(i, len(buckets) - 1)]


@dataclass
class EngineParams:
    token_lm: Dict
    cfm: Dict
    vocoder: Dict
    speaker: Dict
    speech_tokenizer: Dict

    @classmethod
    def init(cls, generator: torch.Generator, cfg: Config) -> "EngineParams":
        return cls(**init_params(cfg, generator))

    def tree(self) -> Dict:
        return {
            "token_lm": self.token_lm, "cfm": self.cfm, "vocoder": self.vocoder,
            "speaker": self.speaker, "speech_tokenizer": self.speech_tokenizer,
        }

    @classmethod
    def from_tree(cls, t: Dict) -> "EngineParams":
        return cls(**t)


@dataclass
class PromptFeatures:
    """Features of one prompt wav (style or timbre), host numpy arrays."""

    tokens: np.ndarray        # [T_tok] int32 speech tokens (25 Hz)
    spk: np.ndarray           # [spk_dim]
    mel24: np.ndarray         # [F, n_mels] target-space mel (50 Hz)


def mel_body(
    cfm_p: Dict, cfg: Config,
    prompt_tokens: torch.Tensor,   # [B, fp_w] flow-prompt speech tokens
    p_lens: torch.Tensor,          # [B]
    gen_tokens: torch.Tensor,      # [B, max_new] LM output
    gen_lens: torch.Tensor,        # [B]
    prompt_mel: torch.Tensor,      # [B, F_p, M] right-padded prompt mel
    mel_lens: torch.Tensor,        # [B]
    spk: torch.Tensor,             # [B, spk_dim]
    generator: Optional[torch.Generator],
    noise: Optional[torch.Tensor] = None,
):
    """Flow-conditioning assembly + CFM solve -> (mel [B, F, M], tok_lens)."""
    up = cfg.cfm.upsample
    B, fp_w = prompt_tokens.shape
    max_new = gen_tokens.shape[1]
    T_all = fp_w + max_new
    n_frames = T_all * up
    dev = prompt_tokens.device
    p_lens = p_lens.long()
    j = torch.arange(T_all, device=dev)[None, :]
    in_prompt = j < p_lens[:, None]
    tok_lens = p_lens + gen_lens.long()
    from_prompt = torch.gather(prompt_tokens.long(), 1, torch.clamp(j, 0, fp_w - 1).expand(B, -1))
    from_gen = torch.gather(gen_tokens.long(), 1, torch.clamp(j - p_lens[:, None], 0, max_new - 1))
    zero = torch.zeros_like(from_gen)
    tokens = torch.where(in_prompt, from_prompt,
                         torch.where(j < tok_lens[:, None], from_gen, zero))
    cond = cfm.upsample_tokens(cfm_p, tokens, up)
    fr = torch.arange(n_frames, device=dev)[None, :]
    frame_mask = (fr < tok_lens[:, None] * up).float()
    pmask = (fr < torch.minimum(p_lens[:, None] * up, mel_lens.long()[:, None])).float()
    M = cfg.cfm.n_mels
    take = min(prompt_mel.shape[1], n_frames)
    pm = torch.zeros((B, n_frames, M), dtype=prompt_mel.dtype, device=dev)
    pm[:, :take] = prompt_mel[:, :take]
    pm = pm * pmask[..., None]
    mel = cfm.sample_mel(
        cfm_p, cfg.cfm, generator, cond, spk, pm, pmask, frame_mask,
        use_cfg=cfg.cfm.use_cfg, noise=noise,
    )
    return mel, tok_lens


def featurize(
    params: "EngineParams", cfg: Config,
    wav16: torch.Tensor,    # [B, T16] zero-padded 16 kHz prompt wavs
    length: torch.Tensor,   # [B] real lengths in samples
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (speech tokens [B, T_tok], token mask, speaker embedding
    [B, spk_dim], 24 kHz prompt mel [B, F, n_mels])."""
    a = cfg.audio
    # 16 kHz mel (100 Hz frames) for the tokenizer and the speaker encoder
    mel16 = stft.log_mel_spectrogram(
        wav16, a.prompt_sample_rate, a.prompt_n_fft, a.prompt_hop_length,
        a.prompt_win_length, n_mels=a.prompt_n_mels, fmax=a.prompt_fmax,
    )
    frames = torch.arange(mel16.shape[1], device=wav16.device)[None, :]
    fmask16 = (frames < (length.long()[:, None] // a.prompt_hop_length) + 1).float()
    tok = speech_tokenizer.apply(params.speech_tokenizer, cfg.speech_tokenizer, mel16, fmask16)
    spk = speaker.apply(params.speaker, cfg.speaker, mel16, fmask16)
    # target-space mel (24 kHz, 50 Hz frames) for the CFM prompt
    wav24 = resample(wav16, a.prompt_sample_rate, a.sample_rate)
    mel24 = stft.log_mel_spectrogram(
        wav24, a.sample_rate, a.n_fft, a.hop_length, a.win_length,
        n_mels=a.n_mels, fmax=a.fmax,
    )
    return tok.tokens, tok.token_mask, spk, mel24


def _not_in_slice(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md: {item})")


_DENSE_PROJ = ("wqkv", "wo", "w_gate_up", "w_down")


def _prepare_lm(lm: Dict, cfg: Config):
    """The token LM as served -> (params, decode-kernel params or None).

    int8 (``quantize_lm_int8``): weight-only quantized at init as the
    reference does. Where the decode kernel takes the LM's widths
    (``decode_step.step_serves``; the engine's B=1 requests then run it) its
    output-major copy is built once here and the prefill reads views of it
    (no second int8 copy); with ``quantize_lm_int4`` only the decode step's
    weights are re-quantized, the prefill keeps int8, as in the reference.
    Dense: the projections and the speech head are rounded to bf16 once
    here (the reference casts them to the bf16 activations in every
    product)."""
    if not cfg.quantize_lm_int8:
        layers = {k: (v.to(torch.bfloat16) if k in _DENSE_PROJ else v) for k, v in lm["layers"].items()}
        return dict(lm, layers=layers, speech_head=lm["speech_head"].to(torch.bfloat16)), None
    lm = quantize_tree(lm)
    tl = cfg.token_lm
    int4 = getattr(cfg, "quantize_lm_int4", False)
    if not decode_step.step_serves(dim=tl.dim, n_heads=tl.n_heads, n_kv_heads=tl.n_kv_heads,
                                   head_dim=tl.head_dim, ffn_dim=tl.ffn_dim,
                                   vocab=tl.speech_vocab_size, bits=4 if int4 else 8):
        return lm, None
    mega8 = token_lm.mega_decode_params(lm, tl)
    mega = token_lm.requantize_int4(mega8) if int4 else mega8
    return token_lm.share_decode_weights(lm, mega8), mega


class Engine:
    def __init__(
        self,
        cfg: Config,
        params: Optional[EngineParams] = None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        """Runs on ``cuda`` unless ``device="cpu"`` (where every kernel
        wrapper takes its plain PyTorch twin). ``params`` default to random
        weights drawn from ``torch.Generator(device).manual_seed(seed)``."""
        self.device = resolve_device(device)
        if vocoder.total_upsample(cfg.vocoder) != cfg.audio.hop_length:
            raise ValueError("vocoder upsampling must equal audio.hop_length "
                             "(mel frames map 1:1 onto output samples)")
        if getattr(cfg, "speculative_gamma", 0) > 0:
            raise _not_in_slice("speculative decoding (speculative_gamma)", "queue A item 5, speculative decode")
        self.cfg = cfg
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = EngineParams.init(gen, cfg)
        params = EngineParams.from_tree(to_device(params.tree(), self.device))
        params.token_lm, self._mega_params = _prepare_lm(params.token_lm, cfg)
        self.params = params
        self.speakers: Dict[str, PromptFeatures] = {}
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 17)
        fcfg = getattr(cfg, "frontend", None)
        self.text_tokenizer = frontend.make_tokenizer(fcfg)
        self.normalize_numbers = bool(getattr(fcfg, "normalize_numbers", True))
        need_vocab = frontend.vocab_size(self.text_tokenizer)
        if cfg.token_lm.text_vocab_size < need_vocab:
            raise ValueError(f"token_lm.text_vocab_size={cfg.token_lm.text_vocab_size} < "
                             f"frontend vocab {need_vocab}")
        # per-stage milliseconds of the last request (featurize when a
        # prompt came as a wav, prefill, decode, cfm, vocoder)
        self.last_timings: Dict[str, float] = {}
        self.last_decode_steps = 0
        self.last_gen_len = 0
        self.last_gen_lens: List[int] = []

    # ------------------------------------------------------------------ prompts

    def prompt_features(self, wavs_16k: Sequence[np.ndarray],
                        clock: Optional[Stopwatch] = None) -> List[PromptFeatures]:
        """Featurize a batch of 16 kHz prompt wavs: padded to one length
        bucket, one device batch, one host fetch. ``clock`` (a request's
        stopwatch) gets the time under its ``featurize`` span."""
        a = self.cfg.audio
        wavs = [np.asarray(w, np.float32).reshape(-1) for w in wavs_16k]
        lens = [len(w) for w in wavs]
        T = _bucket(max(lens), tuple(a.prompt_sample_rate * s for s in PROMPT_SECONDS))
        batch = np.zeros((len(wavs), T), np.float32)
        for i, w in enumerate(wavs):
            batch[i, : min(len(w), T)] = w[:T]
        clock = clock or Stopwatch(self.device)
        with clock.span("featurize"):
            tokens, _, spk, mel24 = featurize(
                self.params, self.cfg, self._tensor(batch, torch.float32),
                self._tensor(lens, torch.int32))
            # one host fetch for all outputs (token ids are exact in f32)
            flat = torch.cat([tokens.float().reshape(-1), spk.float().reshape(-1),
                              mel24.float().reshape(-1)]).cpu().numpy()
        n_t, n_s = tokens.numel(), spk.numel()
        tokens_h = flat[:n_t].astype(np.int32).reshape(tuple(tokens.shape))
        spk_h = flat[n_t : n_t + n_s].reshape(tuple(spk.shape))
        mel_h = flat[n_t + n_s :].reshape(tuple(mel24.shape))
        hop_tokens = a.prompt_hop_length * int(np.prod(self.cfg.speech_tokenizer.strides))
        mel24_per_sec = a.sample_rate // a.hop_length
        out = []
        for i, n in enumerate(lens):
            n_tok = max(1, min(n // hop_tokens, tokens_h.shape[1]))
            n_f24 = max(1, min(int(n / a.prompt_sample_rate * mel24_per_sec), mel_h.shape[1]))
            out.append(PromptFeatures(tokens=tokens_h[i, :n_tok], spk=spk_h[i],
                                      mel24=mel_h[i, :n_f24]))
        return out

    def prompt_features_from_store(self, store: StyleStore, indices) -> List[PromptFeatures]:
        """Precomputed prompt features of a StyleStore's rows (no wav loads,
        no featurization at serving time)."""
        a = store.artifacts
        required = {"speech_tokens", "speech_token_lens", "prompt_mel",
                    "prompt_mel_lens", "spk"}
        if not required <= set(a):
            raise ValueError("store has no precomputed prompt artifacts")
        out = []
        for i in indices:
            n_tok = int(a["speech_token_lens"][i])
            n_mel = int(a["prompt_mel_lens"][i])
            out.append(PromptFeatures(tokens=a["speech_tokens"][i, :n_tok],
                                      spk=a["spk"][i], mel24=a["prompt_mel"][i, :n_mel]))
        return out

    def _resolve_prompts(self, prompts: Sequence, clock: Stopwatch) -> List[PromptFeatures]:
        """Each prompt as ``PromptFeatures``: those given as wavs are
        featurized in one batch, and one wav OBJECT given several times
        (``[wav] * n`` for a fixed prompt) is featurized once."""
        order: Dict[int, int] = {}
        pending: List[np.ndarray] = []
        for w in prompts:
            if not isinstance(w, PromptFeatures) and id(w) not in order:
                order[id(w)] = len(pending)
                pending.append(np.asarray(w).reshape(-1))
        feats = self.prompt_features(pending, clock) if pending else []
        return [w if isinstance(w, PromptFeatures) else feats[order[id(w)]] for w in prompts]

    # ------------------------------------------------------------------ synthesis

    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _lm_stage(self, texts: Sequence[str], style_texts: Sequence[str],
                  style_feats: Sequence[PromptFeatures], spk: torch.Tensor,
                  max_seconds: float, clock: Stopwatch) -> Tuple[token_lm.SpeechGen, int]:
        """The token LM over the batch: (generated tokens and lengths on the
        device, the generation bucket). Each row's [style text ++ text] is
        encoded to one width bucket. A B=1 batch takes the decode kernel
        where the engine built its weights; anything else the scanned
        decode, with an int8 KV cache under ``quantize_lm_kv_int8``."""
        tl = self.cfg.token_lm
        B = len(texts)
        tok, tn = self.text_tokenizer, self.normalize_numbers
        full = [(st + " " + tx).strip() if st else tx for st, tx in zip(style_texts, texts)]
        width = _bucket(max(len(frontend.encode(t, tokenizer=tok, numbers=tn)) for t in full),
                        TEXT_BUCKETS)
        text_ids, text_lens = frontend.encode_batch(full, None, width=width, tokenizer=tok, numbers=tn)
        sty_w = _bucket(max(len(f.tokens) for f in style_feats), TOKEN_BUCKETS)
        sty = np.zeros((B, sty_w), np.int32)
        sty_lens = np.zeros((B,), np.int32)
        for i, f in enumerate(style_feats):
            sty_lens[i] = min(len(f.tokens), sty_w)
            sty[i, : sty_lens[i]] = f.tokens[: sty_lens[i]]
        max_new = _bucket(int(max_seconds * tl.token_rate), GEN_BUCKETS)
        i32 = torch.int32
        gen = token_lm.generate_speech_from_ids(
            self.params.token_lm, tl, self._tensor(text_ids, i32), self._tensor(text_lens, i32),
            self._tensor(sty, i32), self._tensor(sty_lens, i32), spk, self.generator,
            max_new_tokens=max_new, decode_params=self._mega_params if B == 1 else None,
            kv_int8=bool(getattr(self.cfg, "quantize_lm_kv_int8", False)), clock=clock,
        )
        return gen, max_new

    def _synthesize(
        self,
        texts: Sequence[str],
        style_texts: Sequence[str],
        style_feats: Sequence[PromptFeatures],
        flow_feats: Sequence[PromptFeatures],
        max_seconds: float = 20.0,
        lm_tokens_override: Optional[Sequence[np.ndarray]] = None,
        cfm_noise: Optional[np.ndarray] = None,
        clock: Optional[Stopwatch] = None,
    ) -> List[np.ndarray]:
        """Every mode, any B: the token LM (or ``lm_tokens_override``, the
        voice-conversion and pre-made-token modes, which skip it), flow
        conditioning + CFM solve (``cfm_noise`` [B, F, n_mels] replaces its
        initial noise), vocoder, each row's generated region cropped on the
        device, one host fetch. ``style_feats`` drive the LM prosody prompt,
        ``flow_feats`` the speaker identity. ``clock`` may already hold the
        request's ``featurize`` span."""
        cfg = self.cfg
        tl = cfg.token_lm
        B = len(texts)
        up, hop, M = cfg.cfm.upsample, cfg.audio.hop_length, cfg.cfm.n_mels
        i32, f32 = torch.int32, torch.float32
        clock = clock or Stopwatch(self.device)
        spk = self._tensor(np.stack([f.spk for f in flow_feats]), f32)
        steps = 0
        if lm_tokens_override is None:
            gen, max_new = self._lm_stage(texts, style_texts, style_feats, spk, max_seconds, clock)
            gen_tokens, gen_lens, steps = gen.tokens, gen.lengths, gen.decode_steps
        else:
            lens = np.asarray([len(t) for t in lm_tokens_override], np.int32)
            max_new = _bucket(int(lens.max()), GEN_BUCKETS)
            lens = np.minimum(lens, max_new)
            toks = np.full((B, max_new), tl.speech_pad, np.int32)
            for i, t in enumerate(lm_tokens_override):
                toks[i, : lens[i]] = np.asarray(t)[: lens[i]]
            gen_tokens, gen_lens = self._tensor(toks, i32), self._tensor(lens, i32)
        # the flow prompt side (host arrays: prompt features are numpy)
        fp_w = _bucket(max(len(f.tokens) for f in flow_feats), TOKEN_BUCKETS)
        ptok = np.zeros((B, fp_w), np.int32)
        p_lens = np.zeros((B,), np.int32)
        pmel = np.zeros((B, fp_w * up, M), np.float32)
        mel_lens = np.zeros((B,), np.int32)
        for i, f in enumerate(flow_feats):
            p_lens[i] = min(len(f.tokens), fp_w)
            ptok[i, : p_lens[i]] = f.tokens[: p_lens[i]]
            mel_lens[i] = min(f.mel24.shape[0], p_lens[i] * up)
            pmel[i, : mel_lens[i]] = f.mel24[: mel_lens[i]]
        noise = None if cfm_noise is None else self._tensor(cfm_noise, f32)
        with clock.span("cfm"):
            mel, _ = mel_body(
                self.params.cfm, cfg, self._tensor(ptok, i32), self._tensor(p_lens, i32),
                gen_tokens, gen_lens, self._tensor(pmel, f32), self._tensor(mel_lens, i32),
                spk, self.generator, noise=noise,
            )
        with clock.span("vocoder"):
            wav = vocoder.apply(self.params.vocoder, cfg.vocoder, mel)
            # each row's generated region slid to offset 0, its sample count
            # in one more column (exact in f32): one fetch for the batch
            idx = (self._tensor(p_lens, torch.int64)[:, None] * (up * hop)
                   + torch.arange(max_new * up * hop, device=self.device)[None, :])
            n_out = gen_lens.to(f32)[:, None] * (up * hop)
            host = torch.cat([torch.gather(wav.float(), 1, idx), n_out], dim=1).cpu().numpy()
        n_samples = host[:, -1].astype(np.int64)
        wavs = [host[i, : n_samples[i]] for i in range(B)]
        self.last_timings = dict(clock.ms)
        self.last_decode_steps = steps
        self.last_gen_lens = (n_samples // (up * hop)).tolist()
        self.last_gen_len = self.last_gen_lens[0]
        return wavs

    def _one(self, text: str, style_text: str, style, timbre, stream: bool,
             max_seconds: float, cfm_noise: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        if stream:
            raise _not_in_slice("streaming synthesis", "queue A item 4, streaming")
        clock = Stopwatch(self.device)
        sty, tim = self._resolve_prompts([style, timbre], clock)
        wav = self._synthesize([text], [style_text], [sty], [tim], max_seconds=max_seconds,
                               cfm_noise=cfm_noise, clock=clock)[0]
        return {"tts_speech": wav[None, :]}

    def inference_zero_shot(
        self, tts_text: str, prompt_text: str, prompt_speech_16k,
        stream: bool = False, max_seconds: float = 20.0,
        cfm_noise: Optional[np.ndarray] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Zero-shot TTS: one 16 kHz wav (or its precomputed
        ``PromptFeatures``) supplies both prosody and identity."""
        yield self._one(tts_text, prompt_text, prompt_speech_16k, prompt_speech_16k,
                        stream, max_seconds, cfm_noise)

    def inference_tts_with_st(
        self, tts_text: str, style_wav_text: str, style_wav, timbre_wav,
        stream: bool = False, max_seconds: float = 20.0,
        cfm_noise: Optional[np.ndarray] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Style/timbre-split synthesis. ``style_wav``/``timbre_wav`` are
        16 kHz wavs or precomputed ``PromptFeatures`` (the style-DB serving
        path, which skips featurization). ``cfm_noise`` [1, F, n_mels]
        replaces the CFM's initial noise (to reproduce a reference run); by
        default it is drawn from the engine's generator."""
        yield self._one(tts_text, style_wav_text, style_wav, timbre_wav, stream,
                        max_seconds, cfm_noise)

    def register_speaker(self, spk_id: str, prompt_speech_16k: np.ndarray) -> None:
        self.speakers[spk_id] = self.prompt_features([prompt_speech_16k])[0]

    def save_speakers(self, path) -> None:
        """Persist the registered speakers (tokens / mel / spk per id) as
        ``<path>.npz`` + ``<path>.meta.json``, the reference's format."""
        base = str(path).removesuffix(".npz")
        Path(base).parent.mkdir(parents=True, exist_ok=True)
        arrays = {}
        order = sorted(self.speakers)
        for i, sid in enumerate(order):
            f = self.speakers[sid]
            arrays[f"tok_{i}"] = f.tokens
            arrays[f"spk_{i}"] = f.spk
            arrays[f"mel_{i}"] = f.mel24
        np.savez(base + ".npz", **arrays)
        with open(base + ".meta.json", "w", encoding="utf-8") as fh:
            json.dump(order, fh)

    def load_speakers(self, path) -> None:
        base = str(path).removesuffix(".npz")
        with open(base + ".meta.json", encoding="utf-8") as fh:
            order = json.load(fh)
        with np.load(base + ".npz") as data:
            for i, sid in enumerate(order):
                self.speakers[sid] = PromptFeatures(
                    tokens=data[f"tok_{i}"], spk=data[f"spk_{i}"], mel24=data[f"mel_{i}"])

    def inference_sft(
        self, tts_text: str, spk_id: str, stream: bool = False, max_seconds: float = 20.0,
        cfm_noise: Optional[np.ndarray] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Registered-speaker TTS."""
        f = self.speakers[spk_id]
        yield self._one(tts_text, "", f, f, stream, max_seconds, cfm_noise)

    def inference_vc(
        self, source_speech_16k, prompt_speech_16k, stream: bool = False,
        cfm_noise: Optional[np.ndarray] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Voice conversion: the source's speech tokens re-rendered with the
        prompt's identity, no LM. Either argument may be a 16 kHz wav or
        its precomputed ``PromptFeatures``."""
        if stream:
            raise _not_in_slice("streaming voice conversion", "queue A item 4, streaming")
        clock = Stopwatch(self.device)
        src, prm = self._resolve_prompts([source_speech_16k, prompt_speech_16k], clock)
        wav = self._synthesize([""], [""], [prm], [prm], lm_tokens_override=[src.tokens],
                               cfm_noise=cfm_noise, clock=clock)[0]
        yield {"tts_speech": wav[None, :]}

    def synthesize_from_tokens(self, reqs: List[Dict], max_seconds: float = 20.0,
                               cfm_noise: Optional[np.ndarray] = None) -> List[np.ndarray]:
        """Render finished requests (dicts with "tokens" [T] int32 and
        "flow_feat" ``PromptFeatures``) through the batched CFM + vocoder
        stages. One card: no padding of the batch."""
        if not reqs:
            return []
        feats = [r["flow_feat"] for r in reqs]
        return self._synthesize(
            [r.get("text", "") for r in reqs], [""] * len(reqs), feats, feats,
            max_seconds=max_seconds, cfm_noise=cfm_noise,
            lm_tokens_override=[np.asarray(r["tokens"], np.int32) for r in reqs])

    def synthesize_batch(
        self, tts_texts: List[str], style_texts: List[str], style_wavs: List,
        timbre_wavs: List, max_seconds: float = 20.0,
        cfm_noise: Optional[np.ndarray] = None,
    ) -> List[np.ndarray]:
        """Batched tts_with_st: one pass of each stage for the whole batch.
        Items are wavs or ``PromptFeatures``; the wavs of the batch are
        featurized together and one wav OBJECT given several times (as style
        and timbre, or in several rows) once."""
        B = len(tts_texts)
        clock = Stopwatch(self.device)
        feats = self._resolve_prompts(list(style_wavs) + list(timbre_wavs), clock)
        return self._synthesize(tts_texts, style_texts, feats[:B], feats[B:],
                                max_seconds=max_seconds, cfm_noise=cfm_noise, clock=clock)
