"""Synthesis engine: one B=1 request whose prompts come from the style DB.

Counterpart of the JAX ``pipeline/engine.py`` on its main path:
``inference_tts_with_st`` / ``synthesize_batch`` -> ``_synthesize_one``:

1. token-LM prefill (flash-attention kernel) and decode (decode-step kernel),
2. flow-conditioning assembly and the CFM Euler solve (``mel_body``),
3. the iSTFT vocoder and the crop to the generated region.

The engine returns f32 wavs. The STYLE prompt drives the LM prosody prefix;
the TIMBRE prompt supplies the speaker embedding and the flow prompt
(tokens + mel). Everything outside this path raises ``NotImplementedError``
naming its ROADMAP.md item rather than taking another path.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..models import cfm, frontend, token_lm, vocoder
from ..retrieval.store import StyleStore
from ..utils.config import Config
from ..utils.device import DeviceLike, resolve_device
from ..utils.timing import Stopwatch
from ..weights import init_params, quantize_tree, to_device

TEXT_BUCKETS = (32, 64, 128, 256, 512)
TOKEN_BUCKETS = (32, 64, 128, 256)
GEN_BUCKETS = (64, 128, 256, 512)


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
    """Features of one prompt (style or timbre), host numpy arrays."""

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


def _not_in_slice(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md: {item})")


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
        if not cfg.quantize_lm_int8:
            raise _not_in_slice("a non-int8 token LM", "queue A, scanned non-int8 / B>1 decode")
        if cfg.token_lm.n_heads != cfg.token_lm.n_kv_heads:
            raise _not_in_slice("a GQA token LM (H != K)", "queue A, scanned non-int8 / B>1 decode")
        if getattr(cfg, "quantize_lm_int4", False):
            raise _not_in_slice("the int4 decode megakernel", "queue B, int4 megakernel")
        if getattr(cfg, "speculative_gamma", 0) > 0:
            raise _not_in_slice("speculative decoding (speculative_gamma)", "queue A, speculative decode")
        self.cfg = cfg
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = EngineParams.init(gen, cfg)
        params = EngineParams.from_tree(to_device(params.tree(), self.device))
        # int8 weight-only LM, quantized at init as the reference does; the
        # decode kernel's output-major copy is built once here, and the
        # prefill reads views of it (no second int8 copy is kept)
        lm = quantize_tree(params.token_lm)
        self._mega_params = token_lm.mega_decode_params(lm, cfg.token_lm)
        params.token_lm = token_lm.share_decode_weights(lm, self._mega_params)
        del lm
        self.params = params
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 17)
        fcfg = getattr(cfg, "frontend", None)
        self.text_tokenizer = frontend.make_tokenizer(fcfg)
        self.normalize_numbers = bool(getattr(fcfg, "normalize_numbers", True))
        need_vocab = frontend.vocab_size(self.text_tokenizer)
        if cfg.token_lm.text_vocab_size < need_vocab:
            raise ValueError(f"token_lm.text_vocab_size={cfg.token_lm.text_vocab_size} < "
                             f"frontend vocab {need_vocab}")
        # per-stage milliseconds of the last request (prefill, decode, cfm, vocoder)
        self.last_timings: Dict[str, float] = {}
        self.last_decode_steps = 0
        self.last_gen_len = 0

    # ------------------------------------------------------------------ prompts

    def prompt_features(self, wavs_16k):
        raise _not_in_slice("prompt featurization from wavs", "queue A item 8, with kernel 5")

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

    def _as_features(self, x) -> PromptFeatures:
        if isinstance(x, PromptFeatures):
            return x
        return self.prompt_features([np.asarray(x).reshape(-1)])[0]

    # ------------------------------------------------------------------ synthesis

    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _synthesize_one(
        self,
        text: str,
        style_text: str,
        style_feat: PromptFeatures,
        flow_feat: PromptFeatures,
        language: Optional[str],
        max_seconds: float,
        cfm_noise: Optional[np.ndarray] = None,
    ) -> List[np.ndarray]:
        """One B=1 request: LM generate, flow conditioning + CFM solve,
        vocoder, crop to the generated region."""
        cfg = self.cfg
        tl = cfg.token_lm
        up, hop, M = cfg.cfm.upsample, cfg.audio.hop_length, cfg.cfm.n_mels
        tok, tn = self.text_tokenizer, self.normalize_numbers
        full = (style_text + " " + text).strip()
        text_ids, text_lens = frontend.encode_batch(
            [full], [language] if language else None,
            width=_bucket(len(frontend.encode(full, tokenizer=tok, numbers=tn)), TEXT_BUCKETS),
            tokenizer=tok, numbers=tn,
        )
        sty_w = _bucket(max(len(style_feat.tokens), 1), TOKEN_BUCKETS)
        n_s = min(len(style_feat.tokens), sty_w)
        sty = np.zeros((1, sty_w), np.int32)
        sty[0, :n_s] = style_feat.tokens[:n_s]
        fp_w = _bucket(len(flow_feat.tokens), TOKEN_BUCKETS)
        n_p = min(len(flow_feat.tokens), fp_w)
        n_mel = min(flow_feat.mel24.shape[0], n_p * up)
        ptok = np.zeros((1, fp_w), np.int32)
        ptok[0, :n_p] = flow_feat.tokens[:n_p]
        pmel = np.zeros((1, fp_w * up, M), np.float32)
        pmel[0, :n_mel] = flow_feat.mel24[:n_mel]
        max_new = _bucket(int(max_seconds * tl.token_rate), GEN_BUCKETS)

        i32, f32 = torch.int32, torch.float32
        spk = self._tensor(flow_feat.spk[None], f32)
        clock = Stopwatch(self.device)
        gen = token_lm.generate_speech_from_ids(
            self.params.token_lm, tl, self._tensor(text_ids, i32),
            self._tensor(text_lens, i32), self._tensor(sty, i32),
            self._tensor([n_s], i32), spk, self.generator,
            max_new_tokens=max_new, decode_params=self._mega_params, clock=clock,
        )
        noise = None if cfm_noise is None else self._tensor(cfm_noise, f32)
        with clock.span("cfm"):
            mel, _ = mel_body(
                self.params.cfm, cfg, self._tensor(ptok, i32), self._tensor([n_p], i32),
                gen.tokens, gen.lengths, self._tensor(pmel, f32),
                self._tensor([n_mel], i32), spk, self.generator, noise=noise,
            )
        with clock.span("vocoder"):
            wav = vocoder.apply(self.params.vocoder, cfg.vocoder, mel)
            start = n_p * up * hop
            n_out = int(gen.lengths[0]) * up * hop
            out = wav[0, start : start + n_out].float().cpu().numpy()
        self.last_timings = dict(clock.ms)
        self.last_decode_steps = gen.decode_steps
        self.last_gen_len = int(gen.lengths[0])
        return [out]

    def inference_tts_with_st(
        self, tts_text: str, style_wav_text: str, style_wav, timbre_wav,
        stream: bool = False, max_seconds: float = 20.0,
        cfm_noise: Optional[np.ndarray] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Style/timbre-split synthesis. ``style_wav``/``timbre_wav`` are
        precomputed ``PromptFeatures`` (the style-DB serving path).
        ``cfm_noise`` [1, F, n_mels] replaces the CFM's initial noise (to
        reproduce a reference run); by default it is drawn from the engine's
        generator."""
        if stream:
            raise _not_in_slice("streaming synthesis", "queue A, streaming")
        sty = self._as_features(style_wav)
        tim = self._as_features(timbre_wav)
        wav = self._synthesize_one(tts_text, style_wav_text, sty, tim, None, max_seconds,
                                   cfm_noise=cfm_noise)[0]
        yield {"tts_speech": wav[None, :]}

    def synthesize_batch(
        self, tts_texts: List[str], style_texts: List[str], style_wavs: List,
        timbre_wavs: List, max_seconds: float = 20.0,
    ) -> List[np.ndarray]:
        """Batched tts_with_st; the port serves B=1 only."""
        if len(tts_texts) != 1:
            raise _not_in_slice("B>1 synthesis", "queue A, scanned non-int8 / B>1 decode")
        return self._synthesize_one(
            tts_texts[0], style_texts[0], self._as_features(style_wavs[0]),
            self._as_features(timbre_wavs[0]), None, max_seconds,
        )
