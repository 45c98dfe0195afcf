"""Synthesis engine: requests whose prompts are wavs or style-DB rows.

Counterpart of the JAX ``pipeline/engine.py``: its entry points
(``inference_tts_with_st``, ``inference_zero_shot``, ``inference_sft`` with
``register_speaker`` / ``save_speakers`` / ``load_speakers``,
``inference_vc``, ``synthesize_batch``, ``synthesize_from_tokens``), all
through the staged ``_synthesize`` (the reference's fused B=1 program,
``_synthesize_one``, exists to save dispatches; the stages and their
results are the same):

0. for a wav prompt, ``prompt_features`` -> ``featurize``: 16 kHz log-mel
   (fused log-mel kernel) -> speech tokenizer + speaker encoder; resample to
   24 kHz -> 24 kHz log-mel (the kernel again);
1. token-LM prefill (flash-attention kernel) and decode: the decode-step
   kernel (int8 or, with ``cfg.quantize_lm_int4``, int4) for a B=1
   request on an int8 LM whose widths it takes (H = K among them), else the
   scanned decode (a batch, a dense or GQA LM; an int8 KV cache with
   ``cfg.quantize_lm_kv_int8``); with ``cfg.speculative_gamma > 0`` a B=1
   request that the decode kernel does not serve takes the speculative
   decode instead (``token_lm.generate_speech_spec``, the standard sampler
   by rejection sampling); where the kernel serves, gamma is ignored (its
   0.36-ms step beats a plain-PyTorch verify of 20-28 ms on the H100);
   voice conversion skips the LM;
2. flow-conditioning assembly and the CFM Euler solve (``mel_body``),
3. the vocoder (iSTFT or HiFi-GAN) and the crop to each row's generated
   region, fetched to the host once.

With ``stream=True`` each ``inference_*`` entry point yields the audio a
chunk at a time (``_synthesize_stream``): the LM's decode loop hands out
its tokens as it draws them and ``stream_window`` renders one CFM +
vocoder window per chunk; ``render_windows`` renders the windows of many
streams in one call (``pipeline/stream_serve.py``), on a card as the
replay of a kept ``WindowGraph``.

The engine returns f32 wavs. The STYLE prompt drives the LM prosody prefix;
the TIMBRE prompt supplies the speaker embedding and the flow prompt
(tokens + mel).

``Engine(cfg, mesh=...)`` (``parallel.make_mesh``; every rank of the mesh
builds its engine alike and makes the same calls) holds this rank's slices
of the token LM, the CFM and the speech tokenizer under the tensor-parallel
rules, the vocoder and the speaker encoder whole. A batch whose size is a
multiple of the data axis (``synthesize_batch`` and
``synthesize_from_tokens`` pad theirs by repeating the first item, as the
JAX engine does) is split into data ranks' row ranges, each computed by
its model group and gathered, so every rank returns the whole batch; a
smaller batch runs whole on every data rank. A mesh changes placement, not
results: every rank draws the whole batch's LM noise and CFM noise from
the engine's generators, in the shapes one device draws, and keeps its
rows. The decode kernel, the speculative decode and continuous batching
are the single-device paths: under a mesh the LM takes the scanned decode.
"""

from __future__ import annotations

import bisect
import json
import time
from dataclasses import dataclass
from pathlib import Path
from contextlib import contextmanager, nullcontext
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import cfm, frontend, speaker, speech_tokenizer, token_lm, vocoder
from ..ops import decode_step, stft
from ..ops.resample import resample
from ..ops.sampling import SamplerConfig
from ..parallel import comm
from ..parallel.sharding import abstract, batch_sharding, gather_params, shard_params
from ..retrieval.store import StyleStore
from ..utils.config import Config
from ..utils.device import DeviceLike, resolve_device, upload
from ..utils.timing import Span, Stopwatch
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
    clock: Optional[Stopwatch] = None,
):
    """Flow-conditioning assembly (``clock``'s span ``cfm.cond``) + CFM
    solve (``cfm.solve``, counting ``euler_steps`` and ``frames``) ->
    (mel [B, F, M], tok_lens)."""
    up = cfg.cfm.upsample
    B, fp_w = prompt_tokens.shape
    max_new = gen_tokens.shape[1]
    T_all = fp_w + max_new
    n_frames = T_all * up
    dev = prompt_tokens.device
    clock = clock or Stopwatch(dev)
    with clock.open("cfm.cond"):
        p_lens = p_lens.long()
        j = torch.arange(T_all, device=dev)[None, :]
        in_prompt = j < p_lens[:, None]
        tok_lens = p_lens + gen_lens.long()
        from_prompt = torch.gather(prompt_tokens.long(), 1, torch.clamp(j, 0, fp_w - 1).expand(B, -1))
        from_gen = torch.gather(gen_tokens.long(), 1, torch.clamp(j - p_lens[:, None], 0, max_new - 1))
        zero = torch.zeros_like(from_gen)
        tokens = torch.where(in_prompt, from_prompt,
                             torch.where(j < tok_lens[:, None], from_gen, zero))
        cond = cfm.upsample_tokens(cfm_p, tokens, up, cfg.cfm.token_vocab_size)
        fr = torch.arange(n_frames, device=dev)[None, :]
        frame_mask = (fr < tok_lens[:, None] * up).float()
        pmask = (fr < torch.minimum(p_lens[:, None] * up, mel_lens.long()[:, None])).float()
        M = cfg.cfm.n_mels
        take = min(prompt_mel.shape[1], n_frames)
        pm = torch.zeros((B, n_frames, M), dtype=prompt_mel.dtype, device=dev)
        pm[:, :take] = prompt_mel[:, :take]
        pm = pm * pmask[..., None]
    with clock.open("cfm.solve"):
        mel = cfm.sample_mel(
            cfm_p, cfg.cfm, generator, cond, spk, pm, pmask, frame_mask,
            use_cfg=cfg.cfm.use_cfg, noise=noise,
        )
        clock.count("euler_steps", cfg.cfm.n_steps)
        clock.count("frames", B * n_frames)
    return mel, tok_lens


class StreamPrompt(NamedTuple):
    """The flow prompt of a stream on the device (``Engine._flow_stream_dev``):
    the last ``STREAM_PROMPT_TOKENS`` tokens of a prompt and their mel,
    bucketed to ``fp_w`` tokens."""

    key: Tuple                  # (fp_w, upsample, n_mels, device)
    tokens: torch.Tensor        # [1, fp_w] int32
    mel: torch.Tensor           # [1, fp_w * up, M] f32, zero past n_mel
    n_p: int
    n_mel: int
    spk: torch.Tensor           # [1, spk_dim] f32


STREAM_PROMPT_TOKENS = 64    # a stream's windows in-paint against the prompt's last 64 tokens
# a stream prompt's widths: its last STREAM_PROMPT_TOKENS tokens bucketed
STREAM_BUCKETS = tuple(b for b in TOKEN_BUCKETS if b <= _bucket(STREAM_PROMPT_TOKENS, TOKEN_BUCKETS))
# a window graph's row counts: B rows replay the graph of the next one up (rows past B
# repeat row 0 and are dropped); a window of more rows runs eagerly
WINDOW_ROWS = (1, 2, 4, 8)
# captured window renders an engine keeps, every key of one chunk size and one set of
# weights (a row count for each prompt width); a new key drops the oldest
MAX_KEPT_WINDOWS = len(WINDOW_ROWS) * len(STREAM_BUCKETS)


def _window_mel(
    params: "EngineParams", cfg: Config, tok, gen_len, emitted, prompt_tokens, n_p, prompt_mel, n_mel, spk,
    mel_ctx, generator: Optional[torch.Generator], *, chunk: int, noise: Optional[torch.Tensor],
    clock: Optional[Stopwatch],
) -> torch.Tensor:
    """A window's flow conditioning (span ``cfm.cond``) and CFM solve
    (``cfm.solve``; no spans without ``clock``) -> mel [B, W * up, M]
    (``stream_window``'s arguments)."""
    up, M = cfg.cfm.upsample, cfg.cfm.n_mels
    B, fp_w = prompt_tokens.shape
    W = fp_w + 2 * chunk
    dev = prompt_tokens.device
    gl, em, npp, nm = (x.long().reshape(-1, 1) for x in (gen_len, emitted, n_p, n_mel))
    with clock.open("cfm.cond") if clock else nullcontext():
        n_chunk = torch.clamp(gl - em, max=chunk)
        slot = torch.arange(W, device=dev)[None, :]
        ctx_lo = fp_w + chunk - torch.clamp(em, max=chunk)
        # slot fp_w + chunk + (i - emitted) holds generated token i: column slot - fp_w of ``tok``
        gidx = slot - (fp_w + chunk) + em
        from_gen = torch.gather(tok.long(), 1, torch.clamp(slot - fp_w, 0, 2 * chunk - 1).expand(B, W))
        from_prompt = torch.gather(prompt_tokens.long(), 1, torch.clamp(slot, 0, fp_w - 1).expand(B, W))
        in_tail = (slot >= ctx_lo) & (gidx < em + n_chunk) & (slot >= fp_w)
        zero = torch.zeros_like(from_gen)
        tokens = torch.where(slot < npp, from_prompt, torch.where(in_tail, from_gen, zero))
        fr = torch.arange(W * up, device=dev)[None, :]
        sl = fr // up
        in_ctx = (sl >= ctx_lo) & (sl < fp_w + chunk)
        pmask = ((fr < nm) | in_ctx).float()
        fmask = ((fr < npp * up) | in_ctx | ((sl >= fp_w + chunk) & (sl < fp_w + chunk + n_chunk))).float()
        pm = torch.zeros((B, W * up, M), dtype=torch.float32, device=dev)
        pm[:, : fp_w * up] = prompt_mel * (torch.arange(fp_w * up, device=dev)[None, :, None] < nm[:, :, None])
        pm[:, fp_w * up : (fp_w + chunk) * up] = mel_ctx
        pm = pm * pmask[..., None]
        pos = torch.where(fr < fp_w * up, fr, torch.clamp((npp + em - chunk) * up + fr - fp_w * up, min=0))
        cond = cfm.upsample_tokens(params.cfm, tokens, up, cfg.cfm.token_vocab_size)
    with clock.open("cfm.solve") if clock else nullcontext():
        return cfm.sample_mel(params.cfm, cfg.cfm, generator, cond, spk, pm, pmask, fmask,
                              use_cfg=cfg.cfm.use_cfg, positions=pos, noise=noise)


def _window_wav(params: "EngineParams", cfg: Config, mel: torch.Tensor, *, fp_w: int, chunk: int):
    """The vocoder over a window's mel and the chunk's cut -> (samples [B,
    chunk * up * hop], the mel chunk [B, chunk * up, M], a view of ``mel``)."""
    up, hop = cfg.cfm.upsample, cfg.audio.hop_length
    lo = (fp_w + chunk) * up
    wav = vocoder.apply(params.vocoder, cfg.vocoder, mel)[:, lo * hop : (lo + chunk * up) * hop].float()
    return wav, mel[:, lo : lo + chunk * up]


def _count_window(clock: Stopwatch, cfg: Config, frames: int, graph: bool, replayed: bool) -> None:
    """A window's counters on its innermost open span: ``graph`` (a kept
    ``WindowGraph`` serves it), ``graph_replays`` (1 where a replay did),
    ``graph_captures`` (1 where it ran eagerly and recorded); on ``cfm``
    (``frames`` > 0) also the solve's ``euler_steps`` and ``frames``."""
    if frames:
        clock.count("euler_steps", cfg.cfm.n_steps)
        clock.count("frames", frames)
    clock.count("graph_replays", int(replayed), dict(graph=graph))
    clock.count("graph_captures", int(graph and not replayed))


def stream_window(
    params: "EngineParams", cfg: Config,
    gen_tokens: torch.Tensor,      # [B, 2 * chunk] the row's tokens emitted - chunk .. emitted + chunk, 0 past its ends
    gen_len: torch.Tensor,         # [B] tokens the row has (emitted ones included)
    emitted: torch.Tensor,         # [B] tokens already rendered
    prompt_tokens: torch.Tensor,   # [B, fp_w]
    n_p: torch.Tensor,             # [B] real prompt tokens
    prompt_mel: torch.Tensor,      # [B, fp_w * up, M]
    n_mel: torch.Tensor,           # [B] real prompt mel frames
    spk: torch.Tensor,             # [B, spk_dim]
    mel_ctx: torch.Tensor,         # [B, chunk * up, M] the row's previous chunk mel (zeros at first)
    generator: Optional[torch.Generator],
    *, chunk: int, noise: Optional[torch.Tensor] = None, clock: Optional[Stopwatch] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render the next chunk of each row of a stream, eagerly: the CFM
    solves one ``[prompt | ctx | chunk]`` window of ``W = fp_w + 2 *
    chunk`` tokens, the vocoder renders it, and the chunk is cut out. The
    context holds the row's ``min(chunk, emitted)`` previous tokens
    right-aligned against the chunk, with the previous chunk's mel
    in-painted under them; frame positions are absolute (the chunk starts
    at frame (n_p + emitted) * up, where the whole-utterance solve puts
    it), so seams line up. The chunk holds ``min(chunk, gen_len -
    emitted)`` tokens. ``noise`` [B, W * up, M] replaces the draw from
    ``generator``. The ``vocoder`` span ends on the samples' fetch. ->
    (samples [B, chunk * up * hop] f32 on the host, of which each row's
    first n_chunk * up * hop are its audio; the mel chunk [B, chunk * up,
    M], the row's next ``mel_ctx``). ``WindowGraph`` replays the same
    work on a card."""
    B, fp_w = prompt_tokens.shape
    clock = clock or Stopwatch(prompt_tokens.device)
    with clock.span("cfm"):
        mel = _window_mel(params, cfg, gen_tokens, gen_len, emitted, prompt_tokens, n_p, prompt_mel, n_mel, spk,
                          mel_ctx, generator, chunk=chunk, noise=noise, clock=clock)
        _count_window(clock, cfg, mel.shape[0] * mel.shape[1], False, False)
        clock.wait()
    with clock.span("vocoder"):
        wav, mel_chunk = _window_wav(params, cfg, mel, fp_w=fp_w, chunk=chunk)
        _count_window(clock, cfg, 0, False, False)
        return clock.read(wav.cpu), mel_chunk


class WindowGraph:
    """``stream_window`` on one card for up to B rows (a ``WINDOW_ROWS``
    count) over buffers that keep their addresses: ``block`` [B, 2 * chunk
    + 4] int32 (each row's token slice, then gen_len, emitted, n_p,
    n_mel), the prompt tokens, mel and speaker vector, the mel context and
    the noise. Its first window runs eagerly and then records two CUDA
    graphs (``token_lm.record``): the CFM part (conditioning and solve) in
    the ``cfm`` span, the vocoder and the chunk's cut in the ``vocoder``
    span. Every later window copies its inputs in and replays them; both
    spans count ``graph_replays`` and ``graph_captures``. A window of
    fewer rows fills the rest with its row 0 and keeps its own rows of the
    result. The samples are fetched before the call returns and the mel
    chunk is a copy, so a later replay overwrites nothing a caller holds."""

    def __init__(self, key: tuple, B: int, chunk: int, prompt: StreamPrompt, cfg: Config):
        up, M = cfg.cfm.upsample, cfg.cfm.n_mels
        fp_w = prompt.tokens.shape[1]
        dev = prompt.tokens.device
        self.key, self.chunk, self.fp_w = key, chunk, fp_w
        self.block = torch.zeros((B, 2 * chunk + 4), dtype=torch.int32, device=dev)
        self.ptok = torch.zeros((B, fp_w), dtype=torch.int32, device=dev)
        self.pmel = torch.zeros((B, fp_w * up, M), dtype=torch.float32, device=dev)
        self.spk = torch.zeros((B, prompt.spk.shape[1]), dtype=torch.float32, device=dev)
        self.ctx = torch.zeros((B, chunk * up, M), dtype=torch.float32, device=dev)
        self.noise = torch.zeros((B, (fp_w + 2 * chunk) * up, M), dtype=torch.float32, device=dev)
        self.cfm_graph: Optional["torch.cuda.CUDAGraph"] = None
        self.vocoder_graph: Optional["torch.cuda.CUDAGraph"] = None     # set once both are recorded
        self.mel = self.wav = self.mel_chunk = None       # the graphs' outputs
        self.consts: tuple = ()                            # what the vocoder graph reads besides its weights

    def _mel(self, params: "EngineParams", cfg: Config, clock: Optional[Stopwatch]) -> torch.Tensor:
        c, b = self.chunk, self.block
        return _window_mel(params, cfg, b[:, : 2 * c], b[:, 2 * c], b[:, 2 * c + 1], self.ptok, b[:, 2 * c + 2],
                           self.pmel, b[:, 2 * c + 3], self.spk, self.ctx, None, chunk=c, noise=self.noise,
                           clock=clock)

    def render(self, params: "EngineParams", cfg: Config, block: np.ndarray, prompts: Sequence[StreamPrompt],
               mel_ctx: torch.Tensor, noise, generator: Optional[torch.Generator], clock: Stopwatch):
        """One window of ``len(prompts)`` rows: ``block`` the host's int32
        block, ``noise`` None (one draw of ``generator``, the call
        ``sample_mel`` makes) or [B, W * up, M] on the host. -> as
        ``stream_window``."""
        dev = self.block.device
        B, rows = len(prompts), self.block.shape[0]
        frames = self.noise.shape[0] * self.noise.shape[1]
        pad = [prompts[0]] * (rows - B)
        with clock.span("cfm"):
            block = np.concatenate([block] + [block[:1]] * (rows - B))
            self.block.copy_(torch.from_numpy(block).pin_memory(), non_blocking=True)
            torch.cat([p.tokens for p in (*prompts, *pad)], out=self.ptok)
            torch.cat([p.mel for p in (*prompts, *pad)], out=self.pmel)
            torch.cat([p.spk for p in (*prompts, *pad)], out=self.spk)
            self.ctx[:B].copy_(mel_ctx)
            if noise is None:
                self.noise[:B].copy_(torch.randn((B,) + self.noise.shape[1:], generator=generator, device=dev,
                                                 dtype=torch.float32))
            else:
                host = torch.from_numpy(np.ascontiguousarray(np.asarray(noise), dtype=np.float32))
                self.noise[:B].copy_(host.pin_memory(), non_blocking=True)
            replay = self.vocoder_graph is not None
            if replay:
                self.cfm_graph.replay()
            else:
                mel, self.cfm_graph, self.mel = token_lm.record(
                    dev, lambda: self._mel(params, cfg, clock), lambda: self._mel(params, cfg, None))
            _count_window(clock, cfg, frames, True, replay)
            clock.wait()
        with clock.span("vocoder"):
            if replay:
                self.vocoder_graph.replay()
                wav, mel_chunk = self.wav, self.mel_chunk
            else:
                self.consts = vocoder.constants(cfg.vocoder, mel.shape[1], dev)    # made on this stream, held
                (wav, mel_chunk), graph, (self.wav, self.mel_chunk) = token_lm.record(
                    dev, lambda: _window_wav(params, cfg, mel, fp_w=self.fp_w, chunk=self.chunk),
                    lambda: _window_wav(params, cfg, self.mel, fp_w=self.fp_w, chunk=self.chunk))
                self.vocoder_graph = graph     # from here on the window replays
            _count_window(clock, cfg, 0, True, replay)
            return clock.read(wav[:B].cpu), mel_chunk[:B].clone()


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


_DENSE_PROJ = ("wqkv", "wo", "w_gate_up", "w_down")


def _prepare_lm(lm: Dict, cfg: Config, decode_kernel: bool = True):
    """The token LM as served -> (params, decode-kernel params or None).

    int8 (``quantize_lm_int8``): weight-only quantized at init as the
    reference does. Where the decode kernel takes the LM's widths
    (``decode_step.step_serves``; the engine's B=1 requests then run it) its
    output-major copy is built once here and the prefill reads views of it
    (no second int8 copy); with ``quantize_lm_int4`` only the decode step's
    weights are re-quantized, the prefill keeps int8, as in the reference,
    and where the int4 step does not take the widths but the int8 one does
    the decode weights stay int8 (the reference's fallback).
    Dense: the projections and the speech head are rounded to bf16 once
    here (the reference casts them to the bf16 activations in every
    product). ``decode_kernel=False`` (an engine on a mesh): no kernel
    copy."""
    if not cfg.quantize_lm_int8:
        layers = {k: (v.to(torch.bfloat16) if k in _DENSE_PROJ else v) for k, v in lm["layers"].items()}
        return dict(lm, layers=layers, speech_head=lm["speech_head"].to(torch.bfloat16)), None
    lm = quantize_tree(lm)
    if not decode_kernel:
        return lm, None
    tl = cfg.token_lm

    def serves(bits):
        return decode_step.step_serves(dim=tl.dim, n_heads=tl.n_heads, n_kv_heads=tl.n_kv_heads,
                                       head_dim=tl.head_dim, ffn_dim=tl.ffn_dim,
                                       vocab=tl.speech_vocab_size, bits=bits)

    if not serves(8):
        return lm, None
    mega8 = token_lm.mega_decode_params(lm, tl)
    int4 = getattr(cfg, "quantize_lm_int4", False) and serves(4)
    mega = token_lm.requantize_int4(mega8) if int4 else mega8
    return token_lm.share_decode_weights(lm, mega8), mega


class Engine:
    def __init__(
        self,
        cfg: Config,
        params: Optional[EngineParams] = None,
        seed: int = 0,
        device: DeviceLike = None,
        mesh=None,
    ):
        """Runs on ``cuda`` unless ``device="cpu"`` (where every kernel
        wrapper takes its plain PyTorch twin). ``params`` default to random
        weights drawn from ``torch.Generator(device).manual_seed(seed)``.
        ``mesh`` (a ``parallel.Mesh``): the engine runs on its device, holds
        this rank's slices and splits batches over its data axis (module
        docstring)."""
        if mesh is not None:
            if device is not None and torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        if vocoder.total_upsample(cfg.vocoder) != cfg.audio.hop_length:
            raise ValueError("vocoder upsampling must equal audio.hop_length "
                             "(mel frames map 1:1 onto output samples)")
        self.cfg = cfg
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = EngineParams.init(gen, cfg)
        params = EngineParams.from_tree(to_device(params.tree(), self.device))
        params.token_lm, self._mega_params = _prepare_lm(params.token_lm, cfg, decode_kernel=mesh is None)
        self.mesh = mesh
        self.dp = 1 if mesh is None else mesh.data
        if mesh is not None:
            tl, c, st = cfg.token_lm, cfg.cfm, cfg.speech_tokenizer
            self._heads = {"token_lm": (tl.n_heads, tl.n_kv_heads), "cfm": (c.n_heads, c.n_heads),
                           "speech_tokenizer": (st.n_heads, st.n_heads)}
            self._full = {name: abstract(getattr(params, name)) for name in self._heads}
            for name, heads in self._heads.items():
                setattr(params, name, shard_params(mesh, getattr(params, name), heads))
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
        # prompt came as a wav, prefill, decode, cfm, vocoder): its phase spans
        self.last_timings: Dict[str, float] = {}
        self.last_trace: List[Span] = []          # every span of the last request (utils/timing.py)
        self.last_decode_steps = 0      # decode steps, or verify forwards of a speculative request
        self.last_spec: Optional[Dict[str, int]] = None   # {"n_verify", "n_commit"} of a speculative request
        self.last_gen_len = 0
        self.last_gen_lens: List[int] = []
        self.last_chunk_ms: List[float] = []      # a stream's render time of each chunk
        self._windows: List[WindowGraph] = []     # kept stream-window graphs, oldest first

    # ------------------------------------------------------------------ prompts

    def prompt_features(self, wavs_16k: Sequence[np.ndarray],
                        clock: Optional[Stopwatch] = None) -> List[PromptFeatures]:
        """Featurize a batch of 16 kHz prompt wavs: padded to one length
        bucket, one device batch, one host fetch (the read of the
        ``featurize`` span). ``clock`` is the request's trace; without one
        the call is a request of its own."""
        a = self.cfg.audio
        (wavs_16k,), n_real = self._pad_batch(list(wavs_16k))
        wavs = [np.asarray(w, np.float32).reshape(-1) for w in wavs_16k]
        lens = [len(w) for w in wavs]
        T = _bucket(max(lens), tuple(a.prompt_sample_rate * s for s in PROMPT_SECONDS))
        batch = np.zeros((len(wavs), T), np.float32)
        for i, w in enumerate(wavs):
            batch[i, : min(len(w), T)] = w[:T]
        rows = self._rows(len(wavs))
        with self._request(clock) as clock, clock.span("featurize"), self._on_mesh():
            tokens, _, spk, mel24 = featurize(
                self.params, self.cfg, self._tensor(batch[rows], torch.float32),
                self._tensor(lens[rows], torch.int32))
            # one host fetch for all outputs (token ids are exact in f32)
            B = tokens.shape[0]
            flat = torch.cat([tokens.float().reshape(B, -1), spk.float().reshape(B, -1),
                              mel24.float().reshape(B, -1)], dim=1)
            flat = clock.read(self._gather(flat, rows, len(wavs)).cpu).numpy()
        n_t, n_s = tokens[0].numel(), spk[0].numel()
        tokens_h = flat[:, :n_t].astype(np.int32).reshape(-1, *tokens.shape[1:])
        spk_h = flat[:, n_t : n_t + n_s].reshape(-1, *spk.shape[1:])
        mel_h = flat[:, n_t + n_s :].reshape(-1, *mel24.shape[1:])
        lens = lens[:n_real]
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
        return upload(torch.tensor(np.asarray(a), dtype=dtype), self.device)

    def set_module(self, name: str, tree: Dict) -> None:
        """Serve ``tree`` (one module's full weights) as ``name``: cut for
        the mesh where the engine has one."""
        if self.mesh is not None and name in self._heads:
            self._full[name] = abstract(tree)
            tree = shard_params(self.mesh, tree, self._heads[name])
        setattr(self.params, name, tree)

    def full_tree(self) -> Dict:
        """The served weights as one tree (``EngineParams.tree()``); under a
        mesh the cut ones gathered over the model group (every rank of the
        group calls it)."""
        tree = self.params.tree()
        if self.mesh is not None and self.mesh.model > 1:
            for name, heads in self._heads.items():
                tree[name] = gather_params(self.mesh, tree[name], self._full[name], heads)
        return tree

    def _on_mesh(self):
        """The engine's mesh as the active one (``with``), or nothing."""
        return nullcontext() if self.mesh is None else self.mesh

    @contextmanager
    def _request(self, clock: Optional[Stopwatch] = None):
        """The trace a call runs under (``with``): ``clock`` where the call
        is part of a request, else a new request's ``Stopwatch`` with its
        root span ``request`` open; its spans become ``last_trace``."""
        if clock is not None:
            yield clock
            return
        clock = Stopwatch(self.device)
        try:
            with clock.open("request"):
                yield clock
        finally:
            self.last_trace = clock.spans

    def _rows(self, n: int) -> slice:
        """The rows of an n-row batch this rank computes (all of them
        without a mesh, or when n does not split over the data axis)."""
        return batch_sharding(self.mesh, n)

    def _gather(self, x: torch.Tensor, rows: slice, n: int) -> torch.Tensor:
        """Every data rank's rows of a batch, where it was split."""
        return x if rows.stop - rows.start == n else comm.gather_rows(x, self.mesh)

    def _pad_batch(self, *lists):
        """Pad parallel per-item lists to a multiple of the data axis by
        repeating the first item -> (padded lists, the original count)."""
        n = len(lists[0])
        if self.dp <= 1 or n % self.dp == 0:
            return lists, n
        pad = self.dp - n % self.dp
        return tuple(list(l) + [l[0]] * pad for l in lists), n

    def _lm_generator(self, clock: Stopwatch) -> torch.Generator:
        """The random stream of one request's LM: a generator seeded by one
        draw of the engine's. A stream draws its windows' CFM noise from
        the engine's generator while the LM is still drawing tokens, and
        its tokens are still those the same request draws unstreamed from
        the same engine state (the reference gives its LM a key of its own
        for the same reason). The draw is read through ``clock``."""
        draw = torch.randint(0, 2 ** 62, (1,), generator=self.generator, device=self.device)
        return torch.Generator(device=self.device).manual_seed(clock.read(draw.item))

    def _lm_inputs(self, texts: Sequence[str], style_texts: Sequence[str],
                   style_feats: Sequence[PromptFeatures], max_seconds: float, rows: slice = slice(None)):
        """The LM's inputs on the device: (text ids, text lengths, style
        tokens, style lengths) of the batch's ``rows`` and the generation
        bucket. Each row's [style text ++ text] is encoded to one width
        bucket, chosen over the whole batch."""
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
        i32 = torch.int32
        ids = tuple(self._tensor(a[rows], i32) for a in (text_ids, text_lens, sty, sty_lens))
        return ids, _bucket(int(max_seconds * tl.token_rate), GEN_BUCKETS)

    def _lm_stage(self, texts: Sequence[str], style_texts: Sequence[str],
                  style_feats: Sequence[PromptFeatures], spk: torch.Tensor,
                  max_seconds: float, clock: Stopwatch,
                  rows: slice = slice(None)) -> Tuple[token_lm.SpeechGen, int]:
        """The token LM over the batch: (generated tokens and lengths on the
        device, the generation bucket). A B=1 batch takes the decode kernel
        where the engine built its weights, whatever ``speculative_gamma``
        says; else, with ``speculative_gamma > 0``, the speculative decode
        with the standard sampler (its verify forwards count as the decode
        steps; ``last_spec`` holds them and the committed tokens); anything
        else the scanned decode. The speculative and the scanned decode
        keep an int8 KV cache under ``quantize_lm_kv_int8``. ``rows``: this
        data rank's rows (``spk`` holds theirs); the sampling noise is drawn
        for the whole batch."""
        B = len(texts)
        ids, max_new = self._lm_inputs(texts, style_texts, style_feats, max_seconds, rows)
        kv_int8 = bool(getattr(self.cfg, "quantize_lm_kv_int8", False))
        gamma = getattr(self.cfg, "speculative_gamma", 0)
        self.last_spec = None
        split = rows.stop - rows.start < B
        if gamma > 0 and B == 1 and self._mega_params is None and self.mesh is None:
            spec = token_lm.generate_speech_spec_from_ids(
                self.params.token_lm, self.cfg.token_lm, *ids, spk, self._lm_generator(clock),
                max_new_tokens=max_new, gamma=gamma, kv_int8=kv_int8,
                sampler=SamplerConfig(temperature=1.0, top_k=25), clock=clock,
            )
            self.last_spec = {"n_verify": spec.n_verify, "n_commit": spec.n_commit}
            return token_lm.SpeechGen(tokens=spec.tokens, lengths=spec.lengths,
                                      decode_steps=spec.n_verify), max_new
        gen = token_lm.generate_speech_from_ids(
            self.params.token_lm, self.cfg.token_lm, *ids, spk, self._lm_generator(clock),
            max_new_tokens=max_new, decode_params=self._mega_params if B == 1 else None,
            kv_int8=kv_int8, clock=clock, rows=(rows.start, B) if split else None,
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
        request's ``featurize`` span. Under a mesh a data rank computes its
        rows (``_rows``) and the wavs of every row are gathered."""
        with self._on_mesh(), self._request(clock) as clock:
            return self._synthesize_rows(texts, style_texts, style_feats, flow_feats, max_seconds,
                                         lm_tokens_override, cfm_noise, clock)

    def _synthesize_rows(self, texts, style_texts, style_feats, flow_feats, max_seconds,
                         lm_tokens_override, cfm_noise, clock) -> List[np.ndarray]:
        cfg = self.cfg
        tl = cfg.token_lm
        B = len(texts)
        rows = self._rows(B)
        up, hop, M = cfg.cfm.upsample, cfg.audio.hop_length, cfg.cfm.n_mels
        i32, f32 = torch.int32, torch.float32
        spk = self._tensor(np.stack([f.spk for f in flow_feats])[rows], f32)
        steps = 0
        if lm_tokens_override is None:
            gen, max_new = self._lm_stage(texts, style_texts, style_feats, spk, max_seconds, clock, rows)
            gen_tokens, gen_lens, steps = gen.tokens, gen.lengths, gen.decode_steps
        else:
            lens = np.asarray([len(t) for t in lm_tokens_override], np.int32)
            max_new = _bucket(int(lens.max()), GEN_BUCKETS)
            lens = np.minimum(lens, max_new)
            toks = np.full((B, max_new), tl.speech_pad, np.int32)
            for i, t in enumerate(lm_tokens_override):
                toks[i, : lens[i]] = np.asarray(t)[: lens[i]]
            gen_tokens, gen_lens = self._tensor(toks[rows], i32), self._tensor(lens[rows], i32)
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
        if cfm_noise is not None:
            noise = self._tensor(np.asarray(cfm_noise)[rows], f32)
        elif rows.stop - rows.start < B:     # the whole batch's draw, this rank's rows
            shape = (B, (fp_w + max_new) * up, M)
            noise = torch.randn(shape, generator=self.generator, device=self.device, dtype=f32)[rows]
        else:
            noise = None
        with clock.span("cfm"):
            mel, _ = mel_body(
                self.params.cfm, cfg, self._tensor(ptok[rows], i32), self._tensor(p_lens[rows], i32),
                gen_tokens, gen_lens, self._tensor(pmel[rows], f32), self._tensor(mel_lens[rows], i32),
                spk, self.generator, noise=noise, clock=clock,
            )
            clock.wait()
        with clock.span("vocoder"):
            wav = vocoder.apply(self.params.vocoder, cfg.vocoder, mel)
            # each row's generated region slid to offset 0, its sample count
            # in one more column (exact in f32): one fetch for the batch
            idx = (self._tensor(p_lens[rows], torch.int64)[:, None] * (up * hop)
                   + torch.arange(max_new * up * hop, device=self.device)[None, :])
            n_out = gen_lens.to(f32)[:, None] * (up * hop)
            host = torch.cat([torch.gather(wav.float(), 1, idx), n_out], dim=1)
            host = clock.read(self._gather(host, rows, B).cpu).numpy()
        n_samples = host[:, -1].astype(np.int64)
        wavs = [host[i, : n_samples[i]] for i in range(B)]
        self.last_timings = dict(clock.ms)
        self.last_decode_steps = steps
        self.last_gen_lens = (n_samples // (up * hop)).tolist()
        self.last_gen_len = self.last_gen_lens[0]
        return wavs

    # ------------------------------------------------------------------ streaming

    def _flow_stream_dev(self, flow_feat: PromptFeatures) -> StreamPrompt:
        """The flow prompt of a stream on the device, clipped to its last
        ``STREAM_PROMPT_TOKENS`` tokens (the window's CFM cost grows with
        its width) and cached on the ``PromptFeatures`` (DB-served prompts
        come back request after request)."""
        up, M = self.cfg.cfm.upsample, self.cfg.cfm.n_mels
        k0 = max(0, len(flow_feat.tokens) - STREAM_PROMPT_TOKENS)
        tok, mel = flow_feat.tokens[k0:], flow_feat.mel24[k0 * up :]
        fp_w = _bucket(len(tok), TOKEN_BUCKETS)
        key = (fp_w, up, M, self.device)
        cached = getattr(flow_feat, "_stream_dev", None)
        if cached is not None and cached.key == key:
            return cached
        n_p = min(len(tok), fp_w)
        n_mel = min(mel.shape[0], n_p * up)
        ptok = np.zeros((1, fp_w), np.int32)
        ptok[0, :n_p] = tok[:n_p]
        pmel = np.zeros((1, fp_w * up, M), np.float32)
        pmel[0, :n_mel] = mel[:n_mel]
        flow_feat._stream_dev = StreamPrompt(
            key=key, tokens=self._tensor(ptok, torch.int32), mel=self._tensor(pmel, torch.float32),
            n_p=n_p, n_mel=n_mel, spk=self._tensor(flow_feat.spk[None], torch.float32))
        return flow_feat._stream_dev

    def _window_graph(self, B: int, prompt: StreamPrompt, chunk: int) -> Optional[WindowGraph]:
        """The kept ``WindowGraph`` for a window of B rows (key: B rounded up
        to a ``WINDOW_ROWS`` count, the prompt's key (fp_w, upsample,
        n_mels, device), chunk, hop, the CFM and vocoder configs and where
        their weights lie, read on every window), made where none is kept,
        the oldest dropped past ``MAX_KEPT_WINDOWS``; None (the eager
        window) off a card, under a mesh or past the largest row count."""
        if self.mesh is not None or not token_lm.graph_step_fits(self.device) or B > WINDOW_ROWS[-1]:
            return None
        cfg, p = self.cfg, self.params
        key = (_bucket(B, WINDOW_ROWS), prompt.key, chunk, cfg.audio.hop_length, cfg.cfm, cfg.vocoder,
               token_lm.weights_key(p.cfm), token_lm.weights_key(p.vocoder))
        for win in self._windows:
            if win.key == key:
                self._windows.remove(win)
                self._windows.append(win)
                return win
        if len(self._windows) >= MAX_KEPT_WINDOWS:
            self._windows.pop(0)
        self._windows.append(WindowGraph(key, key[0], chunk, prompt, cfg))
        return self._windows[-1]

    def render_windows(self, tokens: Sequence[Sequence[int]], emitted: Sequence[int],
                       prompts: Sequence[StreamPrompt], mel_ctx: torch.Tensor, chunk: int,
                       noise=None, clock: Optional[Stopwatch] = None):
        """The next chunk of each of B streams in one window (the prompts
        share one bucket): row b has generated ``tokens[b]`` and rendered
        ``emitted[b]`` of them. The window reads each row's tokens
        ``emitted - chunk .. emitted + chunk`` and its lengths as one int32
        block, one copy to the device. The noise is one draw of the
        engine's generator for the call, or ``noise`` [B, W * up, M]. On a
        card without a mesh, up to ``WINDOW_ROWS[-1]`` rows, the window is
        a kept ``WindowGraph``'s replay (its first window records it),
        elsewhere ``stream_window``. One
        host fetch, a read of ``clock`` (the stream's trace, or one of the
        call's own). -> (each row's new samples, f32 numpy; the rows' mel
        chunks, the next ``mel_ctx``, a tensor of their own)."""
        up, hop = self.cfg.cfm.upsample, self.cfg.audio.hop_length
        clock = clock or Stopwatch(self.device)
        B = len(tokens)
        block = np.zeros((B, 2 * chunk + 4), np.int32)
        for b, (t, e) in enumerate(zip(tokens, emitted)):
            lo = max(e - chunk, 0)
            seg = t[lo : e + chunk]
            block[b, lo - (e - chunk) : lo - (e - chunk) + len(seg)] = seg
            block[b, 2 * chunk :] = (len(t), e, prompts[b].n_p, prompts[b].n_mel)
        win = self._window_graph(B, prompts[0], chunk)
        if win is not None:
            wav, mel_chunk = win.render(self.params, self.cfg, block, prompts, mel_ctx, noise, self.generator, clock)
        else:
            with self._on_mesh():
                blk = self._tensor(block, torch.int32)
                c = 2 * chunk
                wav, mel_chunk = stream_window(
                    self.params, self.cfg, blk[:, :c], blk[:, c], blk[:, c + 1], torch.cat([p.tokens for p in prompts]),
                    blk[:, c + 2], torch.cat([p.mel for p in prompts]), blk[:, c + 3],
                    torch.cat([p.spk for p in prompts]), mel_ctx, self.generator, chunk=chunk,
                    noise=None if noise is None else self._tensor(noise, torch.float32), clock=clock)
        host = wav.numpy()
        n = [min(chunk, len(t) - e) * up * hop for t, e in zip(tokens, emitted)]
        return [host[b, : n[b]] for b in range(B)], mel_chunk

    def _synthesize_stream(
        self, text: str, style_text: str, style_feat: Optional[PromptFeatures],
        flow_feat: PromptFeatures, chunk_tokens: Optional[int] = None, max_seconds: float = 20.0,
        lm_tokens_override: Optional[np.ndarray] = None, cfm_noise=None,
        clock: Optional[Stopwatch] = None, t0: Optional[float] = None,
    ) -> Iterator[np.ndarray]:
        """One request's audio a chunk at a time (f32 samples), chunks of
        ``chunk_tokens`` tokens (by default ``max(8, 2 * token_rate // 3)``,
        0.64 s at 25 Hz). The LM (or ``lm_tokens_override``, voice
        conversion) runs once, as a decode loop that hands out its tokens
        as it draws them; a window is rendered each time ``chunk`` new
        tokens have arrived, and a last, shorter one at EOS. The LM draws
        from its own generator (``_lm_generator``), the windows' CFM noise
        from the engine's, one draw a window, so the tokens are those the
        same request draws unstreamed from the same engine state. The
        joined chunks are as long as that request's wav. ``cfm_noise``
        replaces the windows' draws (one [1, W * up, M] array a window).
        ``last_timings`` gains ``ttfa`` (ms from the call, ``t0``, to the
        first chunk's samples on the host) and ``last_chunk_ms`` holds each
        chunk's render time (window CFM, vocoder, fetch)."""
        cfg = self.cfg
        tl = cfg.token_lm
        up, M = cfg.cfm.upsample, cfg.cfm.n_mels
        t0 = time.perf_counter() if t0 is None else t0
        clock = clock or Stopwatch(self.device)
        chunk = chunk_tokens or max(8, (2 * tl.token_rate) // 3)
        prompt = self._flow_stream_dev(flow_feat)
        noises = None if cfm_noise is None else iter(cfm_noise)
        decode_steps = 0

        def arrivals():
            """(new tokens, whether the request has all its tokens)."""
            nonlocal decode_steps
            if lm_tokens_override is not None:
                yield [int(t) for t in np.asarray(lm_tokens_override).reshape(-1)], True
                return
            ids, max_new = self._lm_inputs([text], [style_text], [style_feat], max_seconds)
            with self._on_mesh():
                prefix = token_lm.build_prefix_padded(self.params.token_lm, tl, *ids, prompt.spk)
                loop = token_lm.start_decode(self.params.token_lm, tl, prefix, self._lm_generator(clock),
                                             max_new_tokens=max_new, decode_params=self._mega_params,
                                             kv_int8=bool(getattr(cfg, "quantize_lm_kv_int8", False)),
                                             clock=clock)
            gen = None
            while gen is None:
                with clock.span("decode"), self._on_mesh():
                    steps, gen = token_lm.take(loop, chunk)
                    new = [s[0] for s in steps]
                    if tl.speech_eos in new:     # the loop ends at EOS: collect its result
                        new, gen = new[: new.index(tl.speech_eos)], gen or token_lm.finish(loop)
                    clock.wait()
                yield new, gen is not None
            decode_steps = gen.decode_steps

        tokens: List[int] = []
        emitted, ttfa, chunk_ms = 0, None, []
        mel_ctx = torch.zeros((1, chunk * up, M), dtype=torch.float32, device=self.device)
        for new, ended in arrivals():
            tokens += new
            while len(tokens) - emitted >= chunk or (ended and emitted < len(tokens)):
                t_render = time.perf_counter()
                (wav,), mel_ctx = self.render_windows(
                    [tokens], [emitted], [prompt], mel_ctx, chunk,
                    noise=None if noises is None else next(noises), clock=clock)
                now = time.perf_counter()
                chunk_ms.append((now - t_render) * 1e3)
                ttfa = (now - t0) * 1e3 if ttfa is None else ttfa
                emitted += min(chunk, len(tokens) - emitted)
                yield wav
        self.last_timings = dict(clock.ms, ttfa=ttfa)
        self.last_chunk_ms = chunk_ms
        self.last_decode_steps = decode_steps
        self.last_gen_lens = [len(tokens)]
        self.last_gen_len = len(tokens)

    def _one(self, text: str, style_text: str, style, timbre, stream: bool,
             max_seconds: float, cfm_noise=None) -> Iterator[Dict[str, np.ndarray]]:
        """One B=1 request under one trace (a stream's holds its chunks)."""
        t0 = time.perf_counter()
        with self._request() as clock:
            sty, tim = self._resolve_prompts([style, timbre], clock)
            if stream:
                for wav in self._synthesize_stream(text, style_text, sty, tim, max_seconds=max_seconds,
                                                   cfm_noise=cfm_noise, clock=clock, t0=t0):
                    yield {"tts_speech": wav[None, :]}
                return
            wav = self._synthesize([text], [style_text], [sty], [tim], max_seconds=max_seconds,
                                   cfm_noise=cfm_noise, clock=clock)[0]
        yield {"tts_speech": wav[None, :]}

    def inference_zero_shot(
        self, tts_text: str, prompt_text: str, prompt_speech_16k,
        stream: bool = False, max_seconds: float = 20.0, cfm_noise=None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Zero-shot TTS: one 16 kHz wav (or its precomputed
        ``PromptFeatures``) supplies both prosody and identity."""
        yield from self._one(tts_text, prompt_text, prompt_speech_16k, prompt_speech_16k,
                             stream, max_seconds, cfm_noise)

    def inference_tts_with_st(
        self, tts_text: str, style_wav_text: str, style_wav, timbre_wav,
        stream: bool = False, max_seconds: float = 20.0, cfm_noise=None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Style/timbre-split synthesis. ``style_wav``/``timbre_wav`` are
        16 kHz wavs or precomputed ``PromptFeatures`` (the style-DB serving
        path, which skips featurization). ``cfm_noise`` [1, F, n_mels]
        replaces the CFM's initial noise (to reproduce a reference run); by
        default it is drawn from the engine's generator. Every entry point
        takes ``stream=True``: it then yields the audio a chunk at a time
        (``_synthesize_stream``; ``cfm_noise`` is then one array a
        window)."""
        yield from self._one(tts_text, style_wav_text, style_wav, timbre_wav, stream,
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
        cfm_noise=None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Registered-speaker TTS."""
        f = self.speakers[spk_id]
        yield from self._one(tts_text, "", f, f, stream, max_seconds, cfm_noise)

    def inference_vc(
        self, source_speech_16k, prompt_speech_16k, stream: bool = False, cfm_noise=None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Voice conversion: the source's speech tokens re-rendered with the
        prompt's identity, no LM. Either argument may be a 16 kHz wav or
        its precomputed ``PromptFeatures``."""
        t0 = time.perf_counter()
        with self._request() as clock:
            src, prm = self._resolve_prompts([source_speech_16k, prompt_speech_16k], clock)
            if stream:
                for wav in self._synthesize_stream("", "", None, prm, lm_tokens_override=src.tokens,
                                                   cfm_noise=cfm_noise, clock=clock, t0=t0):
                    yield {"tts_speech": wav[None, :]}
                return
            wav = self._synthesize([""], [""], [prm], [prm], lm_tokens_override=[src.tokens],
                                   cfm_noise=cfm_noise, clock=clock)[0]
        yield {"tts_speech": wav[None, :]}

    def synthesize_from_tokens(self, reqs: List[Dict], max_seconds: float = 20.0,
                               cfm_noise: Optional[np.ndarray] = None) -> List[np.ndarray]:
        """Render finished requests (dicts with "tokens" [T] int32 and
        "flow_feat" ``PromptFeatures``) through the batched CFM + vocoder
        stages. Under a mesh the batch is padded to a multiple of the data
        axis (``cfm_noise`` then has the padded batch's rows)."""
        if not reqs:
            return []
        (reqs,), n = self._pad_batch(list(reqs))
        feats = [r["flow_feat"] for r in reqs]
        return self._synthesize(
            [r.get("text", "") for r in reqs], [""] * len(reqs), feats, feats,
            max_seconds=max_seconds, cfm_noise=cfm_noise,
            lm_tokens_override=[np.asarray(r["tokens"], np.int32) for r in reqs])[:n]

    def synthesize_batch(
        self, tts_texts: List[str], style_texts: List[str], style_wavs: List,
        timbre_wavs: List, max_seconds: float = 20.0,
        cfm_noise: Optional[np.ndarray] = None,
    ) -> List[np.ndarray]:
        """Batched tts_with_st: one pass of each stage for the whole batch.
        Items are wavs or ``PromptFeatures``; the wavs of the batch are
        featurized together and one wav OBJECT given several times (as style
        and timbre, or in several rows) once. Under a mesh the batch is
        padded to a multiple of the data axis (``cfm_noise`` then has the
        padded batch's rows) and the padding dropped from the result."""
        (tts_texts, style_texts, style_wavs, timbre_wavs), n = self._pad_batch(
            list(tts_texts), list(style_texts), list(style_wavs), list(timbre_wavs))
        B = len(tts_texts)
        with self._request() as clock:
            feats = self._resolve_prompts(list(style_wavs) + list(timbre_wavs), clock)
            return self._synthesize(tts_texts, style_texts, feats[:B], feats[B:],
                                    max_seconds=max_seconds, cfm_noise=cfm_noise, clock=clock)[:n]


# ----------------------------------------------------------------------------- multi-device dry run


def _dryrun_inputs(B: int, cfg: Config):
    sr = cfg.audio.prompt_sample_rate
    t = np.arange(sr) / sr
    r = np.random.default_rng(7)
    texts = [f"hello world {i}" for i in range(B)]
    styles = [f"style {i}" for i in range(B)]
    sty = [(0.3 * np.sin(2 * np.pi * (200 + 30 * i) * t) + 0.02 * r.standard_normal(t.size)).astype(np.float32)
           for i in range(B)]
    tim = [(0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t) + 0.02 * r.standard_normal(t.size)).astype(np.float32)
           for i in range(B)]
    return texts, styles, sty, tim


def dryrun_engine_rank(data: int, model: int, B: int, device: str, backend: Optional[str]):
    """One rank of ``dryrun_engine``: the mesh engine's batch -> (mesh
    shape, the wavs)."""
    from ..parallel.mesh import make_mesh
    from ..utils.config import tiny_config

    mesh = make_mesh(data, model, device=device, backend=backend)
    cfg = tiny_config()
    eng = Engine(cfg, seed=3, mesh=mesh)
    return mesh.shape, eng.synthesize_batch(*_dryrun_inputs(B, cfg))


DRYRUN_ATOL = 2e-4     # the mesh engine's wavs against the unsharded engine's (JAX's dp x tp bound)


def dryrun_engine(n_devices: int, *, device=None, backend: Optional[str] = None) -> dict:
    """The JAX package's serving dry run: the full synthesis program
    (featurize -> token LM -> CFM -> vocoder -> crop) at ``tiny_config()``
    over an ``n_devices`` mesh (model 2 where n is even, data the rest, as
    JAX picks it) on ``n_devices`` spawned ranks (``parallel.launch``; one
    device shared, ``gloo`` unless ``backend`` names one), every rank's
    wavs checked against the unsharded engine's in this process within
    ``DRYRUN_ATOL``. Prints the ``dryrun_engine ok`` line and returns the numbers."""
    from ..parallel.launch import launch
    from ..utils.config import tiny_config

    dev = resolve_device(device)
    backend = backend or "gloo"
    model = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    data = n_devices // model
    B = max(data, 2)
    out = launch(dryrun_engine_rank, n_devices, data, model, B, str(dev), backend, backend=backend)
    cfg = tiny_config()
    ref = Engine(cfg, seed=3, device=dev).synthesize_batch(*_dryrun_inputs(B, cfg))
    err = 0.0
    for _, got in out:
        if [g.shape for g in got] != [r.shape for r in ref]:
            raise AssertionError(f"dry run wav shapes {[g.shape for g in got]} != {[r.shape for r in ref]}")
        err = max([err] + [float(np.abs(g - r).max()) for g, r in zip(got, ref)])
    if err > DRYRUN_ATOL:
        raise AssertionError(f"dry run wavs differ from the unsharded engine's by {err} > {DRYRUN_ATOL}")
    print(f"dryrun_engine ok: mesh=({out[0][0]}), B={B}, wav_len={out[0][1][0].shape[0]}, max_abs_err={err:.2e}")
    return {"mesh": out[0][0], "B": B, "wav_len": int(out[0][1][0].shape[0]), "max_abs_err": err}
