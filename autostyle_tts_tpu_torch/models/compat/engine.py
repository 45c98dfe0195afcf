"""CosyEngine: serve a converted CosyVoice release through the reference API.

Counterpart of the JAX ``models/compat/engine.py``. It wires the compat
families (``cosy_llm``, ``matcha_unet``, ``hift``) into the synthesis
contract the reference consumed: speech-token generation from text + style
prompt, flow-matching mel decode conditioned on prompt tokens / mel and an
x-vector, NSF vocoding. Built from the trees of
``utils/cosyvoice_convert.RULESETS`` (``cli/convert_cosyvoice --output``
snapshot; the format is the JAX package's, so a snapshot written by either
package loads in the other).

Prompts come pre-tokenized (speech-token ids + x-vector + prompt mel) or
from 16 kHz wavs: ``tokenize_wav16`` runs the converted S3 tokenizer on
the log-mel of ``ops/stft.log_mel_spectrogram`` (the fused log-mel kernel
on the card), ``embed_speaker_wav16`` the graph-executed ``campplus.onnx``.
Geometry is inferred from the trees; batch = 1 (the reference's serving
shape). The engine runs on the card unless ``device="cpu"``; its random
draws (LM sampling, CFM noise, the vocoder's source) come from
``self.generator``. ``last_timings`` holds each stage's last span in ms
(``tokenize``, ``xvector``, ``llm``, ``flow``, ``hift``; synchronized).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional

import numpy as np
import torch

from ...ops.sampling import SamplerConfig
from ...utils.device import DeviceLike, resolve_device
from ...utils.timing import Stopwatch
from ...weights import compat_trees_to_torch
from . import cosy_llm, hift, matcha_unet, s3_tokenizer


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, p))
        else:
            out[p] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_snapshot(path, trees: Dict[str, Dict]) -> None:
    """{artifact: tree} -> one .npz (keys 'artifact::tree/path')."""
    flat = {}
    for artifact, tree in trees.items():
        for k, v in _flatten(tree).items():
            flat[f"{artifact}::{k}"] = v
    np.savez(path, **flat)


def load_snapshot(path) -> Dict[str, Dict]:
    """One .npz -> {artifact: tree of numpy arrays}."""
    with np.load(path) as data:
        per: Dict[str, Dict[str, np.ndarray]] = {}
        for key in data.files:
            artifact, p = key.split("::", 1)
            per.setdefault(artifact, {})[p] = data[key]
    return {a: _unflatten(flat) for a, flat in per.items()}


class CosyEngine:
    def __init__(
        self,
        trees: Dict[str, Dict],
        n_heads_est: int = 4,
        n_steps: int = 10,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        t = compat_trees_to_torch(trees, self.device)
        self.llm, self.flow, self.hift = t["llm.pt"], t["flow.pt"], t["hift.pt"]
        self.s3 = t.get("speech_tokenizer_v1.onnx")
        if self.s3 is not None:
            self.s3_cfg = s3_tokenizer.infer_config(self.s3)
        self.campplus = None
        camp = trees.get("campplus.onnx")
        if camp is not None and "__onnx__" in camp:
            from .campplus import CampPlusCompat

            # graph carried verbatim (uint8 wire bytes), run by ops/onnx_exec
            self.campplus = CampPlusCompat(bytes(np.asarray(camp["__onnx__"], np.uint8).tobytes()),
                                           device=self.device)
        self.llm_cfg = cosy_llm.infer_config(self.llm)
        n_mels = int(self.flow["encoder_proj"]["w"].shape[1])
        self.flow_cfg = matcha_unet.MatchaFlowConfig(n_mels=n_mels, n_heads=n_heads_est, n_steps=n_steps)
        self.flow_enc_cfg = cosy_llm._enc_config(
            self.flow["encoder"], int(self.flow["input_embedding"].shape[1]), "silu")
        self.hift_cfg = hift.infer_config(self.hift, n_mels=n_mels)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._n_down = len(self.flow["estimator"]["down"])
        self.last_timings: Dict[str, float] = {}
        self.last_gen_len = 0

    @classmethod
    def load(cls, snapshot_path, **kw) -> "CosyEngine":
        return cls(load_snapshot(snapshot_path), **kw)

    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    @contextmanager
    def _span(self, name: str):
        """Time a stage into ``last_timings[name]`` (ms, until the device
        has finished it)."""
        clock = Stopwatch(self.device)
        with clock.span(name):
            yield
            clock.wait()
        self.last_timings[name] = clock.ms[name]

    # -------------------------------------------------------------- stages

    @torch.no_grad()
    def tokenize_wav16(self, wav16: np.ndarray) -> np.ndarray:
        """16 kHz prompt wav -> upstream-token-space speech tokens via the
        converted S3 tokenizer, on the log-mel of the fused kernel (128 mels
        for the published tokenizer, fmax 8 kHz)."""
        if self.s3 is None:
            raise ValueError(
                "no speech_tokenizer_v1.onnx tree in this snapshot — pass "
                "pre-tokenized prompts instead"
            )
        from ...ops.stft import log_mel_spectrogram

        with self._span("tokenize"):
            w = self._tensor(np.asarray(wav16, np.float32).reshape(1, -1), torch.float32)
            mel = log_mel_spectrogram(w, 16000, 400, 160, 400, n_mels=self.s3_cfg.n_mels, fmax=8000.0)
            mask = torch.ones((1, mel.shape[1]), dtype=torch.float32, device=self.device)
            tokens, tmask = s3_tokenizer.encode(self.s3, self.s3_cfg, mel, mask)
            n = int(tmask[0].sum())
            return tokens[0, :n].cpu().numpy()

    def embed_speaker_wav16(self, wav16: np.ndarray, bucket: bool = False) -> np.ndarray:
        """16 kHz wav -> x-vector via the graph-executed campplus.onnx
        (upstream: kaldi fbank80 + CMN -> campplus, the timbre identity fed
        to the LM's spk_affine and the flow's spk conditioning)."""
        if self.campplus is None:
            raise ValueError(
                "no campplus.onnx graph in this snapshot — pass precomputed "
                "x-vectors instead"
            )
        with self._span("xvector"):
            return self.campplus.embed_wav16(np.asarray(wav16, np.float32).reshape(-1), bucket=bucket)

    def generate_tokens(
        self,
        text_ids: np.ndarray,          # [Wt] int32 text-token ids
        prompt_tokens: np.ndarray,     # [Wp] int32 prompt speech tokens
        spk: np.ndarray,               # [spk_dim]
        max_new: int = 64,
        sampler: SamplerConfig = SamplerConfig(top_k=25),
    ) -> np.ndarray:
        text = self._tensor(np.asarray(text_ids, np.int32)[None], torch.int32)
        prompt = self._tensor(np.asarray(prompt_tokens, np.int32)[None], torch.int32)
        with self._span("llm"):
            gen = cosy_llm.generate(
                self.llm, self.llm_cfg, text, self._tensor([text.shape[1]], torch.int32),
                prompt, self._tensor([prompt.shape[1]], torch.int32),
                self._tensor(np.asarray(spk, np.float32)[None], torch.float32),
                self.generator, max_new_tokens=max_new, sampler=sampler,
            )
            n = int(gen.lengths[0])
            return gen.tokens[0, :n].cpu().numpy()

    def decode_mel(
        self,
        tokens: np.ndarray,            # [T] all speech tokens (prompt + gen)
        prompt_mel: np.ndarray,        # [F_p, n_mels] prompt-region mel
        spk: np.ndarray,
        x0: Optional[torch.Tensor] = None,
    ) -> np.ndarray:
        """Flow solve over the full token span; prompt frames conditioned.
        ``x0`` [1, F_pad, M] replaces the noise draw."""
        ratio = self.flow_cfg.token_mel_ratio
        T = len(tokens)
        F = T * ratio
        div = 2 ** max(self._n_down - 1, 0)
        F_pad = -(-F // div) * div
        with self._span("flow"):
            tok = self._tensor(np.asarray(tokens, np.int32)[None], torch.int32)
            tok_mask = torch.ones((1, T), dtype=torch.float32, device=self.device)
            mu = matcha_unet.encode_tokens(self.flow, self.flow_enc_cfg, tok, tok_mask, F)
            mu = torch.nn.functional.pad(mu, (0, 0, 0, F_pad - F))
            M = self.flow_cfg.n_mels
            cond = np.zeros((1, F_pad, M), np.float32)
            n_p = min(prompt_mel.shape[0], F_pad)
            cond[0, :n_p] = prompt_mel[:n_p]
            mask = (np.arange(F_pad) < F).astype(np.float32)[None]
            mel = matcha_unet.solve(
                self.flow, self.flow_cfg, mu, self._tensor(np.asarray(spk, np.float32)[None], torch.float32),
                self._tensor(cond, torch.float32), self._tensor(mask, torch.float32),
                generator=self.generator, x0=x0,
            )
            return mel[0, :F].cpu().numpy()

    def vocode(self, mel: np.ndarray) -> np.ndarray:
        with self._span("hift"):
            wav = hift.apply(self.hift, self.hift_cfg, self._tensor(mel[None], torch.float32), self.generator)
            return wav[0].cpu().numpy()

    # -------------------------------------------------------------- API

    def inference_tts_with_st(
        self,
        text_ids: np.ndarray,
        style_tokens: np.ndarray,      # style prompt speech tokens (prosody)
        timbre_tokens: np.ndarray,     # timbre prompt tokens (flow prompt)
        timbre_mel: np.ndarray,        # [F_p, M] timbre prompt mel
        spk: np.ndarray,               # timbre x-vector
        max_new: int = 64,
    ):
        """The reference's custom style/timbre split: style drives the LM
        prosody prompt, timbre drives the flow prompt + speaker identity.
        Yields {'tts_speech': [1, T]} like upstream."""
        gen = self.generate_tokens(text_ids, style_tokens, spk, max_new)
        all_tokens = np.concatenate([np.asarray(timbre_tokens, np.int32), gen])
        mel = self.decode_mel(all_tokens, timbre_mel, spk)
        wav = self.vocode(mel)
        self.last_gen_len = len(gen)
        spf = self.hift_cfg.samples_per_frame * self.flow_cfg.token_mel_ratio
        start = len(timbre_tokens) * spf
        yield {"tts_speech": wav[None, start: len(all_tokens) * spf]}

    def inference_zero_shot(self, text_ids, prompt_tokens, prompt_mel, spk, max_new: int = 64):
        """One prompt supplies prosody and identity."""
        return self.inference_tts_with_st(text_ids, prompt_tokens, prompt_tokens, prompt_mel, spk, max_new)
