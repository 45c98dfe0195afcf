#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card's name and power limit (nvidia-smi); no CUDA -> exit 2;
2. build the CUDA kernels from ``autostyle_tts_tpu_torch/csrc`` (nvcc,
   one process per source, in parallel);
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the main paths give it, and time both (CUDA events), beside one
   library call where one computes the same function: flash attention (the
   prefill shape, a GQA batch and the embedder's hd = 128 geometry), the
   decode step with int8 and with int4 weights (each step's device time
   is broken down by phase from the kernel's own barrier timestamps), its
   two half-layers at both widths (``attn_step``, ``mlp_step``, one
   persistent launch each: timed per call over all layers' weights in turn
   so they stream from device memory, planned and public, by CUDA events,
   host enqueue and the profiler's device time, and by phase from their
   kernels' stamps) and the fused log-mel at both prompt shapes;
4. drive the main paths at the flagship configuration with an int8 token
   LM and random weights from a seeded generator, the kernels' launch counts
   set to 0 before each path and read after it:
   A. a style DB of 6144-d rows whose prompt artifacts are featurized from
      four synthetic 3 s wavs, 4 B=1 DB-served requests through
      ``Engine.inference_tts_with_st``, then one request with raw wavs, one
      through ``inference_zero_shot`` and one registered speaker through
      ``inference_sft``; every wav is checked;
   B. one ``generate_speech`` in the per-layer flavour (a planned
      ``attn_step`` / ``mlp_step`` per layer and token) for 32 tokens;
   C. a second engine with ``quantize_lm_int4`` and two requests;
   D. a flagship batch: ``synthesize_batch`` over 8 DB-served rows of path
      A's store through the scanned decode (int8 KV cache, ``sdpa_quant``;
      then the same batch with a bf16 cache) and one B=1 ``inference_vc``
      through the staged path; every wav is checked; requests/s;
   E. the trained demo engine (``tests/fixtures/demo_engine.npz``: a dense
      LM on the scanned decode, HiFi-GAN, wav prompts through the log-mel
      kernel) held to the JAX package's quality gates: the golden-wav
      statistics and the token round trip through ``inference_vc``, a
      zero-shot line's spectrum, a B=4 batch, then the phoneme purity of
      the speech tokens, speaker similarity, the trained iSTFT vocoder's
      resynthesis and the distilled 2-step CFM (``demo gates`` line);
   F. the HiFi-GAN vocoder at flagship widths (random weights) on a 5 s mel
      at B=1 and B=8: milliseconds and real-time factor;
   G. streaming, B=1 (``stream=True``): two DB-served
      ``inference_tts_with_st`` streams at ``max_seconds=5``, a raw-wav
      zero-shot stream, a voice-conversion stream and a stream on an int4
      engine, each beside the same request unstreamed from the same
      generator state (``stream`` lines: time to first audio, chunks and
      their render times, walls); the chunks must join to the unstreamed
      wav's length and the LM's tokens must be the same;
   H. continuous batching: ``ContinuousBatcher(slots=4, chunk=16,
      p_max=384)`` with the int8 KV cache serves 8 DB-served requests of
      24-125 tokens, rendered through the staged batch path as they finish
      (``continuous`` line: latency p50 / p95, requests/s, ms a decode
      step, admission prefills); then ``StreamingScheduler(slots=4)``
      serves 4 concurrent sessions (``scheduler`` line: each session's
      first chunk, all before the first session ends);
   I. the retrieval workflow at full width: ``Config().embedder``
      (Llama-3.2-3B geometry: 28 layers, 3072 wide, GQA 24:8, hd 128,
      128,256-token vocabulary) as the int8 base drawn on the card from
      ``PRNGKey(42)`` (``utils/rng``: the JAX package's draw, the base the
      adapter was trained over), with the ft3b LoRA adapter
      (``artifacts/ft3b/adapter_f16.npz``, chat-format labels):
      ``build_style_db`` over 8 style samples of 2
      speakers (one biography batch of B=2 at P=1024 and 250 new tokens,
      one label batch of B=8 at P=512, one embed batch of 16 rows at
      T=512; the style wavs featurized by path A's engine), ``self_verify``
      over every row, ``search_dialog`` over 4 turns with a +-5-turn
      labelling context (labels at P=768), each retrieved row served
      through ``prompt_features_from_store`` and one ``synthesize_batch``;
      then ``insert_embeddings`` -> ``search_json`` -> ``tts_with_rag
      --style_db`` through their ``main`` at ``--tiny`` geometry on the
      card (``rag`` line: stage times, the flash kernel at the embedder's
      four shapes, peak memory);
   J. the serving surface: ``cli/serve.py``'s ``main`` at the flagship
      serving point (int8 LM and KV cache, 2-step CFM) over a JSONL of 8
      requests (4 rows of A's style DB, wav pairs, a registered timbre, a
      bad path answered by an error line), batched at ``--batch 8``, then
      ``--continuous`` (slots 4, chunk 16, p_max 384) and ``--continuous
      --stream`` (``serve`` lines: requests/s, latency p50 / p95, which wav
      loader is live, the native one must be, and the batched run's
      loader ms; the ``wav loader`` line times the native loader against
      the numpy one at 16 to 48 kHz); every engine CLI once at ``--tiny``
      (``engine clis`` line; ``export_engine`` out and back in through
      ``--checkpoint``); speculative decoding at the flagship (an engine
      with ``speculative_gamma=4`` serves 2 DB-served requests on the
      decode kernel, which serves its LM; the speculative decode driven on
      the same requests' LM inputs, where the decode kernel must not
      launch: ``speculative flagship`` line, and a profile of its verify
      loop, ``profile speculative``) and on the trained demo LM
      (greedy, 128 tokens: the tokens of the standard decode but at
      near-ties of 1e-3, commits per verify above 1.5; ``speculative demo``
      line);
   K. the compat stack: a synthetic CosyVoice-300M release at its published
      widths (``COSYVOICE_300M``) in the upstream key names, converted by
      ``convert_cosyvoice --strict --output`` (every source tensor mapped,
      campplus carried by graph), served by ``CosyEngine`` on the card at
      B=1 through ``inference_zero_shot`` and ``inference_tts_with_st``
      from pre-tokenized 150-token prompts and from 3 s 16 kHz wavs
      (``tokenize_wav16``: the log-mel kernel at 128 mels;
      ``embed_speaker_wav16``: the campplus graph), 128 new tokens each;
      the greedy decode against one causal pass, the speech tokens from the
      kernel's mel against the plain mel's (``compat`` line); then a
      Llama-3.2-3B state dict in Hugging Face key names (bf16, drawn on the
      card) converted on the card and served as a dense embedder (an embed
      at B=16, T=512 and a left-padded prefill at B=2, P=512), and a tiny
      Hugging Face directory through ``load_hf_checkpoint`` (``hf
      embedder`` line);
   L. training: L1 every acoustic stage at ``Config()``'s widths (the
      tokenizer, the token LM on its f32 masters, the CFM, the iSTFT
      vocoder, the vocoder against its discriminators, a phoneme head, one
      distillation step), 3 steps each on batches of 4 that
      ``make_acoustic_batches`` featurizes on the card from a 32-utterance
      synthcorpus (``train stage`` lines: ms a step, peak GB, losses, the
      pre-clip gradient norms; every trained tensor but those the loss
      never reads moved, the engine's own did not; the vocoder's mel term
      has a gradient and the log-mel wrapper refuses a waveform that needs
      one); L2 the LoRA SFT at Llama-3.2-3B width on the int8 base from
      ``PRNGKey(42)`` (r 32, alpha 128: 40,370,176 adapter parameters, as
      ``artifacts/ft3b/meta.json`` records): ``lora_sft.train`` with
      ``TrainConfig``'s defaults on 40 synthetic chat samples of ~0.9 of
      seq 1024 (packing turns itself off), 2 applied steps and an eval at
      B=8, P=768 through the flash kernel, a second call that resumes and
      stops, one micro-step at B=2 with remat on and off, 4 updates on one
      repeated batch whose loss must fall (``train sft`` line); L3 the
      training CLIs at ``--tiny`` on the card, ``make_corpus`` ->
      ``train_acoustic`` for every stage -> ``export_engine --stage_ckpt``
      -> ``basic`` from the snapshot, ``distill_cfm``, ``ft_llm``,
      ``evaluate_base_model``, ``train_bpe`` (``train clis`` line);
   M. M1 the same int8 base drawn again from ``PRNGKey(42)`` (draw time,
      weight GB), held to the JAX package's slices of it
      (``tests/fixtures/jax_base_probe.npz``: ``tok_emb`` rows, layer 0 and
      27 ``wqkv`` / ``w_down`` int8 values and scales), beside path I's
      labels; M2 the int4 base (``bits=4`` from ``PRNGKey(0)``): an embed
      batch at B=16, T=512 and a biography batch at B=2, P=1024 with 32 new
      tokens; M3 ``retrieval_report`` over path I's store and its CLI over
      the snapshot (``--fail_below_recall 1.0``), ``llm_bio_extract`` on the
      3B int8 base with the ft3b adapter over one 4-utterance conversation
      (one B=4 batch), run twice (the second resumes); M4 a synthetic
      Milvus Lite file of 130 x 6144 rows plus skipped rows through
      ``import_milvus --list`` and an import to the card, ``self_verify``
      and ``retrieval_report``; M5 the phoneme evaluation on the trained
      demo engine (``fit_code_map`` over the corpus sample,
      ``PhonemeRecognizer`` with the map and with a drawn head over path
      E's wavs and the corpus wavs, each transcript also through the plain
      log-mel); M6 the training gates of ``tests/test_torch_train_gates.py``
      on the card (``M1`` ... ``M6`` lines);
   N. the device mesh (``parallel/``), its ranks spawned by
      ``parallel.launch`` and sharing the card: N0 gloo ``all_reduce`` /
      ``all_gather`` / ``broadcast`` of CUDA tensors among 4 ranks, NCCL at
      world size 1 (``N0 mesh backends`` line); N1 the flagship engine at
      dp 2 x tp 2 (4 ranks, gloo) serving the B=4 batch DB-served and from
      wavs (wall, requests/s, the collectives' calls and ms), its greedy
      tokens held to one device's at the same seed (parting only at a
      near-tie of MESH_NEAR_TIE) and its wavs from those tokens on one noise
      within MESH_WAV_ATOL; N2 the same on a 1 x 1 NCCL mesh; N3 the 3B int8
      embedder from ``PRNGKey(42)`` at tp 2 (each rank's GB, an embed at
      B=4, T=512 in bf16 against the unsharded one on rank 0); N4
      ``dryrun_engine(4)``, ``dryrun_train_step(4)`` and a ``dcp``
      checkpoint saved at tp 2, restored at tp 1 and tp 4. Every rank
      counts its own flash and log-mel launches over its main-path run and
      holds both kernels against their plain versions on its own inputs
      (``kernels path N`` line); a rank that fails fails the run;
   the inputs of the first call of each distinct geometry that paths A, D,
   E, G, H, I, J, K, L and M give ``flash_attention`` and ``fused_log_mel`` are
   kept (device copies) and, after the paths, each kernel is held against
   its plain version on them (path D's B=8 prefill, path H's admissions,
   T=384 at B=1, 2 and 4, path I's four embedder shapes and path K's two
   dense-embedder shapes and its 128-mel log-mel, path L's SFT eval prefill
   and its two flagship log-mel legs, path M's three embedder shapes and
   the recognizer's log-mel buckets are also timed);
5. print ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

``python3 chip_smoke.py --log-mel-only`` builds ``log_mel.cu`` alone, runs
the log-mel part of phase 3 and stops without the last two lines: the short
run for work on that kernel. ``--decode-only`` does the same for
``decode_step.cu``: the decode step and the two half-layers at both widths,
checked against their plain versions on the weights the full run draws
and timed (the ``attn_step`` / ``mlp_step`` lines, each half-layer also by
phase), and the ``decode phases`` line (both widths by phase). ``--mesh-only`` builds every kernel and runs
path N alone (its DB-served prompts featurized from synthetic wavs), also
without the last two lines.

Float32 matrix products and convolutions run in full f32 (TF32 off).
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import itertools
import json
from contextlib import contextmanager, redirect_stdout
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from autostyle_tts_tpu_torch.ops import cuda_build, decode_step, flash_attn, log_mel, stft
from autostyle_tts_tpu_torch.ops.resample import resample, resample_poly_np
from autostyle_tts_tpu_torch.ops.sampling import SamplerConfig
from autostyle_tts_tpu_torch.models import cfm, frontend, speech_tokenizer, token_lm, transformer, vocoder
from autostyle_tts_tpu_torch.pipeline import rag
from autostyle_tts_tpu_torch.parallel.launch import launch
from autostyle_tts_tpu_torch.parallel.mesh import make_mesh
from autostyle_tts_tpu_torch.parallel.sharding import abstract, gather_params, shard_params
from autostyle_tts_tpu_torch.pipeline.continuous import ContinuousBatcher
from autostyle_tts_tpu_torch.pipeline.engine import Engine, EngineParams, dryrun_engine
from autostyle_tts_tpu_torch.pipeline import simeval
from autostyle_tts_tpu_torch.pipeline.simeval import SpeakerScorer, token_round_trip
from autostyle_tts_tpu_torch.pipeline.stream_serve import StreamingScheduler
from autostyle_tts_tpu_torch.retrieval.store import StyleStore
from autostyle_tts_tpu_torch.train import lora_sft
from autostyle_tts_tpu_torch.utils import hf_convert, rng, timing
from autostyle_tts_tpu_torch.utils.audio_io import read_wav, write_wav
from autostyle_tts_tpu_torch.utils.config import CFMConfig, Config, VocoderConfig, demo_config
from autostyle_tts_tpu_torch.utils.synth_release import SynthGeometry, build_release_dir
from autostyle_tts_tpu_torch.utils.timing import Stopwatch
from autostyle_tts_tpu_torch.weights import (Q4Tensor, QTensor, _flat_keys, from_jax_tree, load_npz, load_tree,
                                             quantize_tree, tree_map)

# H100 SXM peaks (NVIDIA data sheet, dense): the least time a function can
# take is max(bytes / HBM rate, operations / peak rate of their type)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
F32_FLOP_PER_S = 67e12    # outside the tensor cores
TF32_FLOP_PER_S = 495e12
LOGMEL_PASSES = 3         # TF32 products per f32 product in the log-mel kernel (hi/lo split)

# tolerances of the kernel-vs-plain phases (both on the card, same inputs)
FLASH_ATOL = 2e-2     # bf16 output, |out| < 4: two bf16 ulps
DECODE_RTOL = 2e-2    # bf16 residual over 14 layers: a few ulps of max|h|
LOGIT_GAP = 5e-2      # the token must agree where the top-2 gap (and the top-k margin) is wider
HEAD_ATOL = 1e-4      # the kernel's logits against the plain head on its own residual (f32 sums in another order)
LOGMEL_ATOL = 1e-3    # log units: split-TF32 products (f32-level), sums over the window in another order
VQ_MARGIN = 1e-3      # a speech token must agree where the plain top-2 codebook scores differ by more

# the JAX package's quality gates for the trained demo engine (tests/test_trained_demo.py)
GOLDEN_RMS_REL, GOLDEN_RMS_ABS = 0.3, 1e-3    # |rms - g| < 0.3 g + 1e-3
GOLDEN_MEL = 0.3                              # mean |delta mel mean|, mean |delta mel std|
# like for like: on the JAX engine's own noise the golden statistics (its
# own, rounded to 1e-5) must hold far tighter (CPU port: rms within 5e-6,
# mel 2.8e-5; tests/test_torch_trained_demo.py)
LIKE_RMS, LIKE_MEL = 1e-4, 1e-3
ROUND_TRIP_MIN_N, ROUND_TRIP_AGREE = 10, 0.85
ZERO_SHOT_MIN_S, ZERO_SHOT_RMS, ZERO_SHOT_LOW_BAND = 0.3, 0.01, 0.90
PURITY, ISTFT_L1 = 0.90, 0.40                 # phoneme purity of the speech tokens; the iSTFT vocoder's mel-L1
DISTILL_RATIO, DISTILL_SLACK = 0.6, 0.10      # student-teacher L1 < 0.6 of the undistilled 2-step run's; gt L1 slack

FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures"
FLASH_SRC = "autostyle_tts_tpu_torch/csrc/flash_attn.cu"
DECODE_SRC = "autostyle_tts_tpu_torch/csrc/decode_step.cu"
LOGMEL_SRC = "autostyle_tts_tpu_torch/csrc/log_mel.cu"
KERNEL_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of fn() over iters calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_host_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean host milliseconds to enqueue fn() (no wait for the device in
    the timed loop; the queue is drained before and after)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return host


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------------- flash


def flash_err(q, k, v, off) -> float:
    """The kernel against its plain version on these inputs, over the real
    (not left-padded) query rows."""
    got = flash_attn.flash_attention(q, k, v, off)
    want = flash_attn.flash_attention_plain(q, k, v, off)
    torch.cuda.synchronize()
    real = (torch.arange(q.shape[1], device=q.device)[None, :] >= off[:, None].long())[:, :, None, None]
    return float(((got.float() - want.float()).abs() * real).max())


def flash_measure(q, k, v, off):
    """Error, times and bound of the flash kernel on these inputs."""
    dev = q.device
    B, T, H, hd = q.shape
    K = k.shape[2]
    offsets = off.tolist()
    err = flash_err(q, k, v, off)
    ms = time_ms(lambda: flash_attn.flash_attention(q, k, v, off), 200)
    plain_ms = time_ms(lambda: flash_attn.flash_attention_plain(q, k, v, off), 20)
    # one PyTorch call of the same function (timed only, never used by the port)
    rep = H // K
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    slot = torch.arange(T, device=dev)
    mask = (slot[None, :] <= slot[:, None])[None, None] & (slot[None, None, None, :] >= off.long()[:, None, None, None])
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    library_ms = time_ms(lib, 200)
    # work this call's data needs: each real query row attends keys [off, t]
    n_pairs = sum(sum(t - o + 1 for t in range(o, T)) for o in offsets) * H
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2 + off.numel() * 4
    b, by = bound_ms(nbytes, 4.0 * hd * n_pairs, BF16_FLOP_PER_S)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b, bound_by=by, shape=[B, T, H, K, hd], offsets=offsets,
                blocks=flash_attn.launch_blocks(B, T, H))


def flash_inputs(B, T, H, K, hd, gen):
    dev = torch.device("cuda")
    return tuple(torch.randn((B, T, n, hd), generator=gen, device=dev).to(torch.bfloat16) for n in (H, K, K))


def flash_case(B, T, H, K, hd, offsets, gen):
    q, k, v = flash_inputs(B, T, H, K, hd, gen)
    return flash_measure(q, k, v, torch.tensor(offsets, dtype=torch.int32, device=q.device))


# ----------------------------------------------------------------------------- decode step


def four_bit_exact(lm):
    """The int8 LM rounded onto 15 levels at the same absmax (q * 7 / 127,
    the scale grown by 127 / 7) with one 7 per output channel, so that the
    4-bit re-quantization reproduces these weights exactly."""
    def fix(t):
        q = torch.clamp(torch.round(t.q.float() * (7.0 / 127.0)), -7, 7).to(torch.int8)
        q[..., 0, :] = 7
        return QTensor(q=q, s=t.s * (127.0 / 7.0))
    layers = {k: fix(v) if isinstance(v, QTensor) else v for k, v in lm["layers"].items()}
    return dict(lm, layers=layers, speech_head=fix(lm["speech_head"]))


def decisive(logits, tl, suppress: bool, seed: int, skw: dict) -> bool:
    """Whether the plain sampler's token on these logits must also be the
    kernel's: the winner leads by more than LOGIT_GAP, and (top-k sampling)
    it still wins by that much when the top-k threshold moves LOGIT_GAP
    either way, so that no entry near the threshold decides the step. The
    kernel's logits may differ from the plain step's by a few bf16 roundings
    of the residual (held to DECODE_RTOL); on every step its head is held to
    the plain head on its own residual (HEAD_ATOL) and its sampler to the
    plain sampler on its own logits (equality)."""
    kw = dict(pad_id=tl.speech_pad, bos_id=tl.speech_bos, eos_id=tl.speech_eos, suppress=suppress,
              seed=seed, **{"greedy": True, "temperature": 1.0, "top_k": 0, **skw})
    shifts = (0.0,) if kw["greedy"] or kw["top_k"] <= 0 else (-LOGIT_GAP, 0.0, LOGIT_GAP)
    winners = set()
    for shift in shifts:
        y = decode_step.sample_scores_plain(
            logits, **kw, threshold=lambda y, k: decode_step.topk_threshold_plain(y, k) + shift)
        top2 = torch.topk(y, 2)
        if float(top2.values[0] - top2.values[1]) <= LOGIT_GAP:
            return False
        winners.add(int(top2.indices[0]))
    return len(winners) == 1


def decode_case(cfg: Config, steps: int, gen, bits: int = 8):
    """Teacher-forced decode steps on flagship weights (int8, or 4-bit-exact
    ones packed as int4): the kernel and the plain step each advance their
    own copy of one cache. Returns the record and, for the half-layer
    phases, the params and the kernel's cache."""
    dev = torch.device("cuda")
    tl = cfg.token_lm
    lm = quantize_tree(token_lm.init_params(tl, gen))
    if bits == 4:
        lm = four_bit_exact(lm)
    mp = token_lm.mega_decode_params(lm, tl, bits=bits)
    del lm
    mp_plain = decode_step.unpack_decode_params(mp)   # int8-valued rows for the plain step
    L, N, D, F, V = tl.n_layers, tl.dim, tl.dim, tl.ffn_dim, tl.speech_vocab_size
    P, max_new, off = 256, 128, 100
    S = -(-(P + max_new + 1) // 8) * 8
    k_plain = torch.zeros((L, S, N), dtype=torch.bfloat16, device=dev)
    v_plain = torch.zeros_like(k_plain)
    k_plain[:, off:P] = (torch.randn((L, P - off, N), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    v_plain[:, off:P] = (torch.randn((L, P - off, N), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    k_kern, v_kern = k_plain.clone(), v_plain.clone()
    toks = torch.randint(0, V - 3, (steps,), generator=gen, device=dev).tolist()
    kw = dict(n_heads=tl.n_heads, head_dim=tl.head_dim, eps=tl.norm_eps, pad_id=tl.speech_pad,
              bos_id=tl.speech_bos, eos_id=tl.speech_eos)
    sampled = dict(greedy=False, temperature=1.0, top_k=25)
    h_err = cache_err = head_err = logit_err = 0.0
    h_scale = 0.0
    checked = {"greedy": 0, "sampled": 0}
    loop_scratch = {mode: decode_step.decode_scratch(mp, tl.n_heads, tl.head_dim, dev)
                    for mode in checked}    # a scratch serves one sampler setting
    for i, tok in enumerate(toks):
        t = P + i
        tin = torch.tensor([tok], dtype=torch.int32, device=dev)
        for mode, skw in (("greedy", dict(greedy=True)), ("sampled", sampled)):
            # each mode writes row t again from the same inputs
            hk, tk = decode_step.mega_decode_step(tin, mp, k_kern, v_kern, t, off, i < 2, 1000 + i,
                                                  **kw, **skw, scratch=loop_scratch[mode])
            hp, tp = decode_step.mega_decode_step_plain(tin, mp_plain, k_plain, v_plain, t, off, i < 2, 1000 + i, **kw, **skw)
            torch.cuda.synchronize()
            # the kernel's head alone: its logits against the plain head on its own residual
            logits_p = decode_step.head_logits_plain(hp, mp_plain, tl.norm_eps)
            logits_k = loop_scratch[mode]["logits"]
            head_err = max(head_err, float(
                (logits_k - decode_step.head_logits_plain(hk, mp_plain, tl.norm_eps)).abs().max()))
            logit_err = max(logit_err, float((logits_k - logits_p).abs().max()))
            # the kernel's sampler alone: on the kernel's own logits the plain
            # sampler must pick the same token on every step
            on_kernel_logits = decode_step.sample_plain(
                logits_k, pad_id=tl.speech_pad, bos_id=tl.speech_bos,
                eos_id=tl.speech_eos, suppress=i < 2, seed=1000 + i,
                **{"greedy": True, "temperature": 1.0, "top_k": 0, **skw})
            check(int(tk[0]) == on_kernel_logits,
                  f"decode step {i} ({mode}): the kernel's sampler picked {int(tk[0])}, the plain "
                  f"sampler {on_kernel_logits} from the same logits")
            if decisive(logits_p, tl, i < 2, 1000 + i, skw):
                check(int(tk[0]) == int(tp[0]),
                      f"decode step {i} ({mode}): kernel token {int(tk[0])} != plain {int(tp[0])}")
                checked[mode] += 1
        h_err = max(h_err, float((hk.float() - hp.float()).abs().max()))
        h_scale = max(h_scale, float(hp.float().abs().max()))
        for a, b in ((k_kern, k_plain), (v_kern, v_plain)):
            cache_err = max(cache_err, float((a[:, t].float() - b[:, t].float()).abs().max()))
    c_scale = float(k_plain[:, P:P + steps].float().abs().max())
    check(h_err <= DECODE_RTOL * max(h_scale, 1.0), f"decode h_last err {h_err} (max|h| {h_scale})")
    check(cache_err <= DECODE_RTOL * max(c_scale, 1.0), f"decode cache err {cache_err}")
    check(torch.equal(k_kern[:, :off], k_plain[:, :off]) and torch.equal(k_kern[:, P + steps:], k_plain[:, P + steps:]),
          "decode step wrote outside its row")
    check(head_err <= HEAD_ATOL, f"decode head: logits err {head_err} on the kernel's own residual")
    check(min(checked.values()) >= steps // 2, f"too few decisive steps: {checked}")

    t = P + 64   # mid-generation
    tin = torch.tensor([toks[0]], dtype=torch.int32, device=dev)
    # the timing state, on a scratch of its own (as the decode loop holds one), checked once more
    hp, tp = decode_step.mega_decode_step_plain(tin, mp_plain, k_plain, v_plain, t, off, False, 7, **kw, **sampled)
    scratch = decode_step.decode_scratch(mp, tl.n_heads, tl.head_dim, dev)
    step = lambda: decode_step.mega_decode_step(tin, mp, k_kern, v_kern, t, off, False, 7, **kw, **sampled,
                                                scratch=scratch)
    hk, tk = step()
    torch.cuda.synchronize()
    mid_err = max(float((hk.float() - hp.float()).abs().max()),
                  float((k_kern[:, t].float() - k_plain[:, t].float()).abs().max()),
                  float((v_kern[:, t].float() - v_plain[:, t].float()).abs().max()))
    check(mid_err <= DECODE_RTOL * max(float(hp.float().abs().max()), 1.0),
          f"decode step at slot {t} ({bits} bits): err {mid_err} against the plain step")
    if decisive(decode_step.head_logits_plain(hp, mp_plain, tl.norm_eps), tl, False, 7, sampled):
        check(int(tk[0]) == int(tp[0]), f"decode step at slot {t}: token {int(tk[0])} != plain {int(tp[0])}")
    ms = time_ms(step, 100)
    host_ms = time_host_ms(step, 50)
    stamped = decode_step.decode_scratch(mp, tl.n_heads, tl.head_dim, dev, stamps=True)
    steps_of = dict(
        step=step, stamps=stamped["stamps"],
        stamped=lambda: decode_step.mega_decode_step(tin, mp, k_kern, v_kern, t, off, False, 7, **kw, **sampled,
                                                     scratch=stamped))
    plain_ms = time_ms(lambda: decode_step.mega_decode_step_plain(tin, mp_plain, k_plain, v_plain, t, off, False, 7, **kw, **sampled), 5, warmup=1)
    n_weights = L * (3 * N * D + D * N + 2 * F * D + D * F) + V * D
    scales = 4 * (L * (3 * N + D + 2 * F + D) + V) + 4 * (2 * L * D + D)
    n_keys = t - off
    cache_bytes = 2 * L * n_keys * N * 2 + 2 * L * N * 2
    nbytes = n_weights * bits // 8 + scales + D * 2 + cache_bytes + D * 2 + 4
    ops = 2 * n_weights + 4 * L * N * (n_keys + 1)
    b, by = bound_ms(nbytes, ops, INT8_OP_PER_S)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rec = dict(max_abs_err=max(h_err, cache_err, mid_err), ms=ms, plain_ms=plain_ms,
               library_ms=None, bound_ms=b, bound_by=by, bits=bits, steps=steps, decisive=checked,
               h_max=h_scale, head_logits_err=head_err, logits_err_vs_plain_step=logit_err,
               bytes_per_step=nbytes, cache_slots=S, t=t, live_keys=n_keys,
               attn_blocks=tl.n_heads * decode_step.attn_splits(n_keys, sms // tl.n_heads),   # step and half-layer
               host_enqueue_ms=host_ms)
    return rec, mp, (k_kern, v_kern, t, off), steps_of


LAYER_PHASES = ("qkv", "attention", "wo", "gate_up", "down")   # a layer's waits, in order


def wait_laps(call, stamps: torch.Tensor, n_waits: int, calls: int = 10):
    """Where a persistent kernel's device time goes on its critical path,
    from the timestamps its blocks leave at every wait (``call`` runs the
    kernel once on ``stamps``: [n_waits + 1, blocks, 2], arrival and leave,
    the last slot the block's end): per wait, the lap from the last
    block's arrival at it to the last block's arrival at the next (a
    block's arrival: its part of the phase before written) and the slowest
    block's work from leaving it to its next arrival, in us, means over
    ``calls`` calls; and the call's us from the last arrival at the first
    wait to the last block's end, then from the first arrival there."""
    call()
    acc = np.zeros((2, n_waits))
    total = span = 0.0
    for _ in range(calls):
        call()
        torch.cuda.synchronize()
        st = stamps.cpu().numpy().astype(np.float64)
        arrive, leave, nxt = st[:n_waits, :, 0], st[:n_waits, :, 1], st[1:n_waits + 1, :, 0]
        acc[0] += nxt.max(axis=1) - arrive.max(axis=1)
        acc[1] += (nxt - leave).max(axis=1)
        total += st[n_waits, :, 0].max() - arrive[0].max()
        span += st[n_waits, :, 0].max() - arrive[0].min()
    acc /= calls * 1e3
    return acc[0], acc[1], total / calls / 1e3, span / calls / 1e3


def barrier_times(step, stamps: torch.Tensor, n_layers: int, steps: int = 10) -> dict:
    """Where the decode step's device time goes on its critical path, from
    the timestamps its blocks leave at every wait (``decode_scratch(...,
    stamps=True)``; ``step`` runs one step on that scratch; ``wait_laps``):
    per phase ``lap_us`` and ``work_us``, means over the layers and over
    ``steps`` steps. The laps add up to ``step_us`` (last arrival at the
    first wait to the last block's end); a lap less its work is what the
    chain waited for beyond the slowest block's work."""
    lap, work, total, _ = wait_laps(step, stamps, stamps.shape[0] - 1, steps)
    rec = {}
    for i, name in enumerate(LAYER_PHASES):
        idx = np.arange(i, 5 * n_layers, 5)
        rec[name] = dict(lap_us=float(lap[idx].mean()), work_us=float(work[idx].mean()))
    for i, name in ((5 * n_layers, "head"), (5 * n_layers + 1, "sampler")):
        rec[name] = dict(lap_us=float(lap[i]), work_us=float(work[i]))
    rec["step_us"] = total
    rec["layer_us"] = float(lap[:5 * n_layers].sum()) / n_layers
    return rec


# a layer's weights, in the half-layers' order (decode_step's own, which the older checkouts that
# scripts/time_decode_step.py times against do not have)
ATTN_KEYS = ("attn_norm", "wqkv", "wqs", "wo", "wos")
MLP_KEYS = ("mlp_norm", "wgu", "wgus", "wd", "wds")


def per_call_device_us(fn, calls: int):
    """(device microseconds, kernels) per call of fn() over ``calls`` calls,
    from torch.profiler: the sum of every device event's duration (kernels,
    copies, fills), whatever the host needs to enqueue them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evts = device_events(prof)
    if not evts:
        return "not measured", "not measured"
    return sum(u for _, u, _ in evts) / calls, len(evts) / calls


def half_layer_times(tl, mp, cache, rounds: int = 20) -> dict:
    """``attn_step`` and ``mlp_step`` per call over all L layers' weights
    and caches in turn (more than the L2 holds, so they stream from device
    memory as in a step; each call adds to one residual in place: the
    values move, the bytes streamed do not): through the public wrappers on
    one decode scratch and, where the package has them, through a plan of
    the L layers (``plan_half_layers``). Each record: ``ms`` (CUDA events
    over ``rounds`` rounds of the L layers), ``host_enqueue_us`` (the host's
    time to enqueue a call), ``device_us`` and ``kernels_per_call`` (the
    profiler: the sum of the call's device events)."""
    dev = torch.device("cuda")
    k_all, v_all, t, off = cache
    L = tl.n_layers
    kw = dict(n_heads=tl.n_heads, head_dim=tl.head_dim, eps=tl.norm_eps)
    scratch = decode_step.decode_scratch(mp, tl.n_heads, tl.head_dim, dev)
    layers = [{k: mp[k][l] for k in ATTN_KEYS + MLP_KEYS} for l in range(L)]
    h = (torch.randn((1, tl.dim), device=dev) * 0.5).to(torch.bfloat16)
    calls = {
        "attn_step": {"public": lambda l: decode_step.attn_step(
            h, *(layers[l][k] for k in ATTN_KEYS), mp["invf"],
            k_all[l], v_all[l], t, off, scratch=scratch, **kw)},
        "mlp_step": {"public": lambda l: decode_step.mlp_step(
            h, *(layers[l][k] for k in MLP_KEYS), eps=tl.norm_eps,
            scratch=scratch)},
    }
    if hasattr(decode_step, "plan_half_layers"):
        plan = decode_step.plan_half_layers(h, layers, mp["invf"], k_all, v_all, scratch=scratch, **kw)
        calls["attn_step"]["planned"] = lambda l: decode_step.attn_step_planned(plan, l, t, off)
        calls["mlp_step"]["planned"] = lambda l: decode_step.mlp_step_planned(plan, l)
    out = {}
    for name, ways in calls.items():
        for way, fn in ways.items():
            layer = itertools.cycle(range(L))
            call = lambda: fn(next(layer))
            device_us, kernels = per_call_device_us(call, 2 * L)
            out.setdefault(name, {})[way] = dict(
                ms=time_ms(call, rounds * L, warmup=L), host_enqueue_us=1e3 * time_host_ms(call, rounds * L, warmup=L),
                device_us=device_us, kernels_per_call=kernels)
    return out


def half_layer_laps(tl, mp, cache, calls: int = 10) -> dict:
    """Each half-layer by phase, from its kernel's own stamps (a plan of the
    L layers with ``stamps``; layer 0, as ``barrier_times`` reads the
    step's): per phase ``lap_us`` (last arrival at the wait before it to
    last arrival after it; the first wait's arrival is a block's start) and
    ``work_us`` (the slowest block's time from leaving the wait to its next
    arrival); ``call_us`` from the last block's start to the last block's
    end, ``span_us`` from the first block's start; means over ``calls``."""
    dev = torch.device("cuda")
    k_all, v_all, t, off = cache
    kw = dict(n_heads=tl.n_heads, head_dim=tl.head_dim, eps=tl.norm_eps)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stamps = torch.zeros((decode_step.HALF_STAMP_SLOTS, sms, 2), dtype=torch.int64, device=dev)
    layers = [{k: mp[k][l] for k in ATTN_KEYS + MLP_KEYS} for l in range(tl.n_layers)]
    h = (torch.randn((1, tl.dim), device=dev) * 0.5).to(torch.bfloat16)
    plan = decode_step.plan_half_layers(h, layers, mp["invf"], k_all, v_all, **kw, stamps=stamps,
                                        scratch=decode_step.half_layer_scratch(tl.dim, tl.n_heads, tl.head_dim,
                                                                               tl.ffn_dim, dev))
    out = {}
    for name, waits, call in (("attn_step", ("qkv", "attention", "wo"), lambda: decode_step.attn_step_planned(plan, 0, t, off)),
                              ("mlp_step", ("gate_up", "down"), lambda: decode_step.mlp_step_planned(plan, 0))):
        lap, work, call_us, span_us = wait_laps(call, stamps, len(waits), calls)
        out[name] = dict({w: dict(lap_us=float(lap[i]), work_us=float(work[i])) for i, w in enumerate(waits)},
                         call_us=call_us, span_us=span_us)
    return out


def half_layer_case(cfg: Config, mp, cache, gen, bits: int = 8):
    """``attn_step`` and ``mlp_step`` on layer 0's views of the decode
    case's weights (int8, or int4 in ``pack4``'s order) and its cache
    state, each against its plain version from the same residual (the
    cache rows other than t untouched); then per call over all layers in
    turn (``half_layer_times``: the kernels' ``ms`` is the planned call's)
    and by phase (``half_layer_laps``)."""
    dev = torch.device("cuda")
    tl = cfg.token_lm
    k_all, v_all, t, off = cache
    D, N, F = tl.dim, tl.n_heads * tl.head_dim, tl.ffn_dim
    kw = dict(n_heads=tl.n_heads, head_dim=tl.head_dim, eps=tl.norm_eps)
    scratch = decode_step.decode_scratch(mp, tl.n_heads, tl.head_dim, dev)
    h0 = (torch.randn((1, D), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    u = decode_step.unpack4 if bits == 4 else (lambda w: w)
    a_args = [mp[k][0] for k in ATTN_KEYS] + [mp["invf"]]
    m_args = [mp[k][0] for k in MLP_KEYS]
    a_plain_args = [u(w) if k in ("wqkv", "wo") else w for k, w in zip(ATTN_KEYS, a_args)] + [mp["invf"]]
    m_plain_args = [u(w) if k in ("wgu", "wd") else w for k, w in zip(MLP_KEYS, m_args)]
    k1, v1 = k_all[0].clone(), v_all[0].clone()
    k2, v2 = k1.clone(), v1.clone()
    h = h0.clone()
    decode_step.attn_step(h, *a_args, k1, v1, t, off, scratch=scratch, **kw)
    want = decode_step.attn_step_plain(h0, *a_plain_args, k2, v2, t, off, **kw)
    torch.cuda.synchronize()
    scale = max(float(want.float().abs().max()), 1.0)
    a_err = max(float((h.float() - want.float()).abs().max()),
                float((k1[t].float() - k2[t].float()).abs().max()),
                float((v1[t].float() - v2[t].float()).abs().max()))
    check(a_err <= DECODE_RTOL * scale, f"attn_step ({bits} bits) err {a_err} (max|h| {scale})")
    rest = torch.arange(k1.shape[0], device=dev) != t
    check(torch.equal(k1[rest], k2[rest]) and torch.equal(v1[rest], v2[rest]),
          f"attn_step ({bits} bits) wrote outside its row")
    hm = want.clone()
    decode_step.mlp_step(hm, *m_args, eps=tl.norm_eps, scratch=scratch)
    want_m = decode_step.mlp_step_plain(want, *m_plain_args, eps=tl.norm_eps)
    torch.cuda.synchronize()
    m_scale = max(float(want_m.float().abs().max()), 1.0)
    m_err = float((hm.float() - want_m.float()).abs().max())
    check(m_err <= DECODE_RTOL * m_scale, f"mlp_step ({bits} bits) err {m_err} (max|h| {m_scale})")

    times = half_layer_times(tl, mp, cache)
    laps = half_layer_laps(tl, mp, cache)
    a_plain = time_ms(lambda: decode_step.attn_step_plain(h0, *a_plain_args, k2, v2, t, off, **kw), 20)
    m_plain = time_ms(lambda: decode_step.mlp_step_plain(want, *m_plain_args, eps=tl.norm_eps), 20)
    n_keys = t - off
    a_bytes = (3 * N * D + D * N) * bits // 8 + 4 * (3 * N + D) + 4 * D + 2 * tl.head_dim + 2 * 2 * D \
        + 2 * n_keys * N * 2 + 2 * N * 2
    a_b, a_by = bound_ms(a_bytes, 2 * (3 * N * D + D * N) + 4 * N * (n_keys + 1), INT8_OP_PER_S)
    m_bytes = 3 * F * D * bits // 8 + 4 * (2 * F + D) + 4 * D + 2 * 2 * D
    m_b, m_by = bound_ms(m_bytes, 2 * 3 * F * D, INT8_OP_PER_S)

    def rec(name, err, h_max, plain_ms, b, by, **extra):
        planned = times[name]["planned"]
        return dict(max_abs_err=err, ms=planned["ms"], plain_ms=plain_ms, library_ms=None, bound_ms=b, bound_by=by,
                    bits=bits, h_max=h_max, device_us=planned["device_us"],
                    host_enqueue_us=planned["host_enqueue_us"], launches_per_call=planned["kernels_per_call"],
                    public=times[name]["public"], phases_us=laps[name], **extra)

    return (rec("attn_step", a_err, scale, a_plain, a_b, a_by, t=t, live_keys=n_keys),
            rec("mlp_step", m_err, m_scale, m_plain, m_b, m_by))


def decode_phase(cfg: Config, gen):
    """The decode part of phase 3: the step at both widths and the two
    half-layers at both widths held to their plain versions (each prints
    its line), the widths timed in turns within one stretch, then each step
    by phase. Returns the int8 and int4 records, the int8 half-layers' and
    the phases'."""
    tl = cfg.token_lm
    dec, mp8, cache8, steps8 = decode_case(cfg, 16, gen)
    print("decode int8", json.dumps(dec), flush=True)
    attn_rec, mlp_rec = half_layer_case(cfg, mp8, cache8, gen)
    print("attn_step", json.dumps(attn_rec), flush=True)
    print("mlp_step", json.dumps(mlp_rec), flush=True)
    del mp8, cache8
    dec4, mp4, cache4, steps4 = decode_case(cfg, 16, gen, bits=4)
    print("decode int4", json.dumps(dec4), flush=True)
    # a generator of its own: the later phases draw from `gen` what they drew before
    attn4, mlp4 = half_layer_case(cfg, mp4, cache4, torch.Generator(device="cuda").manual_seed(1236), bits=4)
    print("attn_step int4", json.dumps(attn4), flush=True)
    print("mlp_step int4", json.dumps(mlp4), flush=True)
    del mp4, cache4
    attn_rec["max_abs_err"] = max(attn_rec["max_abs_err"], attn4["max_abs_err"])   # the worst of both widths
    mlp_rec["max_abs_err"] = max(mlp_rec["max_abs_err"], mlp4["max_abs_err"])
    turns = {8: 0.0, 4: 0.0}
    for bits, steps in ((8, steps8), (4, steps4), (4, steps4), (8, steps8)):
        turns[bits] += 0.5 * time_ms(steps["step"], 50)
    phases = dict(
        ms_in_turns_int8=turns[8], ms_in_turns_int4=turns[4], host_enqueue_ms=dec["host_enqueue_ms"],
        phases_us=barrier_times(steps8["stamped"], steps8["stamps"], tl.n_layers),
        phases_us_int4=barrier_times(steps4["stamped"], steps4["stamps"], tl.n_layers),
        layers_as_half_layer_calls_ms=tl.n_layers * (attn_rec["ms"] + mlp_rec["ms"]),
        attn_blocks=dec["attn_blocks"])
    return dec, dec4, attn_rec, mlp_rec, phases


def skip_draws_before_decode(cfg: Config, gen) -> None:
    """Take from ``gen`` what phase 3's flash and log-mel cases take before
    the decode case, so that ``--decode-only`` checks the weights and inputs
    of the full run (the decode checks sit close to their tolerance)."""
    tl = cfg.token_lm
    flash_inputs(1, 256, tl.n_heads, tl.n_kv_heads, tl.head_dim, gen)
    flash_inputs(2, 256, tl.n_heads, 4, tl.head_dim, gen)
    for leg in ("16k", "24k"):
        noise_frames(cfg.audio, leg, 2, 4, gen)


# ----------------------------------------------------------------------------- log-mel


def log_mel_leg(audio, leg: str):
    """(sr, n_fft, hop, win, n_mels, fmax) of a prompt leg: '16k' feeds the
    tokenizer and the speaker encoder, '24k' the CFM prompt."""
    a = audio
    if leg == "16k":
        return (a.prompt_sample_rate, a.prompt_n_fft, a.prompt_hop_length, a.prompt_win_length,
                a.prompt_n_mels, a.prompt_fmax)
    return a.sample_rate, a.n_fft, a.hop_length, a.win_length, a.n_mels, a.fmax


def log_mel_bounds(frames, cos_b, fb, out) -> dict:
    """Least times for one call: every input read once (a strided view
    counts the signal it covers, not the overlapping frames), the output
    written once; the operations at the rate of the unit the kernel uses
    (TF32 tensor cores, LOGMEL_PASSES products each) and, beside it, at the
    f32 FMA rate."""
    B, T, win = frames.shape
    n_bins, n_mels = fb.shape
    covered = B * ((T - 1) * frames.stride(1) + win) if frames.stride(1) < win else frames.numel()
    nbytes = 4 * (covered + 2 * cos_b.numel() + fb.numel() + out.numel())
    ops = 2 * 2 * B * T * win * n_bins + 3 * B * T * n_bins + 2 * B * T * n_bins * n_mels
    b, by = bound_ms(nbytes, ops, TF32_FLOP_PER_S / LOGMEL_PASSES)
    return dict(bound_ms=b, bound_by=by, bound_unit=f"tf32 / {LOGMEL_PASSES} passes",
                bound_ms_f32=bound_ms(nbytes, ops, F32_FLOP_PER_S)[0],
                blocks=-(-B * T // log_mel.TILE_ROWS) * -(-n_bins // log_mel.TILE_BINS))


def kernel_device_ms(fn, name: str, calls: int = 20):
    """Mean device milliseconds of the kernels whose name holds ``name``
    over ``calls`` calls of fn(), from torch.profiler: the kernel alone,
    whatever the host needs to launch it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [u for n, u, _ in device_events(prof) if name in n]
    return sum(us) / len(us) / 1e3 if us else "not measured"


def noise_frames(audio, leg: str, B: int, seconds: int, gen) -> torch.Tensor:
    sr, n_fft, hop, win, _, _ = log_mel_leg(audio, leg)
    T = stft.num_frames(seconds * sr, n_fft, hop, win)
    return torch.randn((B, T, win), generator=gen, device="cuda") * 0.1


def log_mel_case(audio, leg: str, B: int, seconds: int, gen, iters: int = 200):
    """The fused log-mel kernel against its three-matmul plain version on
    white-noise frames (contiguous) of one prompt leg at one bucket."""
    dev = torch.device("cuda")
    sr, n_fft, hop, win, n_mels, fmax = log_mel_leg(audio, leg)
    frames = noise_frames(audio, leg, B, seconds, gen)
    T = frames.shape[1]
    cos_b, sin_b = stft._dft_basis_on(dev, n_fft, win)
    fb = stft._mel_filterbank_on(dev, sr, n_fft, n_mels, 0.0, fmax)
    got = log_mel.fused_log_mel(frames, cos_b, sin_b, fb)
    want = log_mel.fused_log_mel_plain(frames, cos_b, sin_b, fb)
    torch.cuda.synchronize()
    check(got.shape == (B, T, n_mels) and bool(torch.isfinite(got).all()), "log-mel shape / finiteness")
    err = float((got - want).abs().max())
    call = lambda: log_mel.fused_log_mel(frames, cos_b, sin_b, fb)
    ms = time_ms(call, iters)
    plain_ms = time_ms(lambda: log_mel.fused_log_mel_plain(frames, cos_b, sin_b, fb), max(iters // 4, 5))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                device_ms=kernel_device_ms(call, "log_mel"), host_enqueue_ms=time_host_ms(call, 50),
                **log_mel_bounds(frames, cos_b, fb, got), shape=[B, T, win, fb.shape[0], n_mels],
                bucket_s=seconds)


def log_mel_measure(frames, cos_b, sin_b, fb, eps) -> dict:
    """Error, times and bound of the log-mel kernel on inputs a path gave
    it (the strided frames as they were)."""
    call = lambda: log_mel.fused_log_mel(frames, cos_b, sin_b, fb, eps)
    got = call()
    err = float((got - log_mel.fused_log_mel_plain(frames, cos_b, sin_b, fb, eps)).abs().max())
    return dict(max_abs_err=err, ms=time_ms(call, 200),
                plain_ms=time_ms(lambda: log_mel.fused_log_mel_plain(frames, cos_b, sin_b, fb, eps), 50),
                library_ms=None, device_ms=kernel_device_ms(call, "log_mel"),
                **log_mel_bounds(frames, cos_b, fb, got), shape=[*frames.shape, *fb.shape],
                frame_stride=frames.stride(1))


def log_mel_tonal_case(cfg: Config, leg: str, gen):
    """The kernel on what ``featurize`` gives it: two synthetic 3 s prompts
    (tonal, near-empty bins) zero-tailed into the 4 s bucket, reflect-padded,
    the frames passed as the strided view of the padded signal. Held to the
    plain version on the same view; rows that see only zeros must be
    log(eps) exactly; two calls must agree bit for bit. On the 16 kHz leg
    the speech tokenizer (random weights) must give the same token from
    either mel wherever the plain codebook scores decide by VQ_MARGIN."""
    dev = torch.device("cuda")
    a = cfg.audio
    sr, n_fft, hop, win, n_mels, fmax = log_mel_leg(a, leg)
    wavs = np.zeros((2, 4 * a.prompt_sample_rate), np.float32)
    for i, seed in enumerate((7, 8)):
        w = synthetic_wav(seed)
        wavs[i, :len(w)] = w
    x = torch.from_numpy(wavs).to(dev)
    if leg == "24k":
        x = resample(x, a.prompt_sample_rate, sr)
    frames = stft.frame_signal(stft._reflect_pad(x, n_fft // 2), win, hop)
    check(frames.stride(1) == hop and not frames.is_contiguous(), f"log_mel {leg}: frames are not the strided view")
    cos_b, sin_b = stft._dft_basis_on(dev, n_fft, win)
    fb = stft._mel_filterbank_on(dev, sr, n_fft, n_mels, 0.0, fmax)
    eps = 1e-5
    n0 = log_mel.fused_log_mel.launches
    got = log_mel.fused_log_mel(frames, cos_b, sin_b, fb, eps)
    again = log_mel.fused_log_mel(frames, cos_b, sin_b, fb, eps)
    want = log_mel.fused_log_mel_plain(frames, cos_b, sin_b, fb, eps)
    torch.cuda.synchronize()
    check(log_mel.fused_log_mel.launches == n0 + 2, f"log_mel {leg}: the strided view did not launch the kernel")
    check(bool(torch.isfinite(got).all()), f"log_mel {leg} tonal: not finite")
    err = float((got - want).abs().max())
    check(err <= LOGMEL_ATOL, f"log_mel {leg} tonal: err {err} > {LOGMEL_ATOL}")
    check(torch.equal(got, again), f"log_mel {leg}: two calls on the same input differ")
    zero_rows = frames.abs().amax(-1) == 0
    floor = torch.log(torch.tensor(eps, dtype=torch.float32, device=dev))
    check(int(zero_rows.sum()) > 0 and bool((got[zero_rows] == floor).all()),
          f"log_mel {leg}: all-zero rows ({int(zero_rows.sum())}) are not exactly log(eps)")
    rec = dict(max_abs_err=err, shape=list(frames.shape), frame_stride=frames.stride(1),
               zero_rows=int(zero_rows.sum()), bitwise_repeat=True, mel_min=float(want.min()),
               mel_max=float(want.max()),
               ms=time_ms(lambda: log_mel.fused_log_mel(frames, cos_b, sin_b, fb, eps), 200),
               plain_ms=time_ms(lambda: log_mel.fused_log_mel_plain(frames, cos_b, sin_b, fb, eps), 50),
               plain_on_copy_ms=time_ms(
                   lambda: log_mel.fused_log_mel_plain(frames.contiguous(), cos_b, sin_b, fb, eps), 50),
               **log_mel_bounds(frames, cos_b, fb, got))
    if leg == "16k":
        tcfg = cfg.speech_tokenizer
        params = speech_tokenizer.init_params(tcfg, gen)
        length = torch.tensor([len(synthetic_wav(7))] * 2, device=dev)
        mask = (torch.arange(got.shape[1], device=dev)[None, :] < (length[:, None] // hop) + 1).float()
        tok_k = speech_tokenizer.apply(params, tcfg, got, mask)
        tok_p = speech_tokenizer.apply(params, tcfg, want, mask)
        top2 = torch.topk(speech_tokenizer.vq_scores(params["codebook"], tok_p.pre_vq), 2, dim=-1).values
        decisive = ((top2[..., 0] - top2[..., 1]) > VQ_MARGIN) & tok_p.token_mask.bool()
        n_real, n_dec = int(tok_p.token_mask.sum()), int(decisive.sum())
        check(n_dec >= 0.9 * n_real, f"speech tokens: only {n_dec} of {n_real} are decisive")
        check(torch.equal(tok_k.tokens[decisive], tok_p.tokens[decisive]),
              "speech tokens from the kernel's mel differ from the plain version's on decisive frames")
        rec.update(tokens_compared=n_dec, tokens_real=n_real,
                   tokens_equal_all=int((tok_k.tokens == tok_p.tokens)[tok_p.token_mask.bool()].sum()),
                   pre_vq_err=float((tok_k.pre_vq - tok_p.pre_vq).abs().max()))
    return rec


def log_mel_phase(cfg: Config, gen):
    """Every log-mel check and time of phase 3; returns the 24 kHz
    white-noise record (comparable across revisions) with the largest error
    of all four checked cases."""
    a = cfg.audio
    # the two legs of one prompt_features call on 3 s wavs in the 4 s bucket, B = 2
    noise = {leg: log_mel_case(a, leg, 2, 4, gen) for leg in ("16k", "24k")}
    for leg, r in noise.items():
        print(f"log_mel {leg}", json.dumps(r), flush=True)
        check(r["max_abs_err"] <= LOGMEL_ATOL, f"log_mel {leg}: err {r['max_abs_err']} > {LOGMEL_ATOL}")
    # the added cases draw from a generator of their own: the phases after this
    # one keep the weights and inputs they have always had from ``gen``
    own = torch.Generator(device="cuda").manual_seed(4321)
    tonal = {leg: log_mel_tonal_case(cfg, leg, own) for leg in ("16k", "24k")}
    for leg, r in tonal.items():
        print(f"log_mel {leg} tonal strided", json.dumps(r), flush=True)
    # recorded only: the latency floor (1 s bucket, B = 1) and the 30 s bucket at B = 2
    for B, seconds in ((1, 1), (2, 30)):
        for leg in ("16k", "24k"):
            r = log_mel_case(a, leg, B, seconds, own, iters=100)
            print(f"log_mel {leg} {seconds}s B={B}", json.dumps(r), flush=True)
            check(r["max_abs_err"] <= LOGMEL_ATOL, f"log_mel {leg} {seconds}s: err {r['max_abs_err']}")
    worst = max(r["max_abs_err"] for r in (*noise.values(), *tonal.values()))
    return dict(noise["24k"], max_abs_err=worst)


# ----------------------------------------------------------------------------- the paths' own inputs


def strided_copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` with its strides and alignment: a view into a
    contiguous tensor (the frames ``unfold`` cuts from a signal) is copied
    as the tensor it views."""
    base = x if x._base is None else x._base
    check(base.is_contiguous(), "strided_copy: the viewed tensor is not contiguous")
    return base.clone().as_strided(x.shape, x.stride(), x.storage_offset() - base.storage_offset())


class PathInputs:
    """The inputs of the first call of every distinct geometry (shapes and
    strides) a main path gives ``flash_attention`` or ``fused_log_mel``,
    copied on the device (no host sync), so that each kernel is held
    against its plain version on exactly what the paths gave it. While
    ``watch(path)`` is open the wrappers are wrapped where the port calls
    them (``transformer.flash_attention``, ``stft.fused_log_mel``); the
    launch counts are untouched."""

    def __init__(self):
        self.flash, self.mel = {}, {}

    @contextmanager
    def watch(self, path: str):
        flash0, mel0 = transformer.flash_attention, stft.fused_log_mel

        # a call is recorded once the wrapper took it (path L also gives one the wrapper must refuse)
        def flash(q, k, v, offset):
            out = flash0(q, k, v, offset)
            key = (path, tuple(q.shape), tuple(k.shape))
            if key not in self.flash:
                self.flash[key] = tuple(t.clone() for t in (q, k, v, offset))
            return out

        def mel(frames, cos_b, sin_b, fb, eps=1e-5):
            out = mel0(frames, cos_b, sin_b, fb, eps)
            key = (path, tuple(frames.shape), frames.stride(), eps)
            if key not in self.mel:
                self.mel[key] = (strided_copy(frames), cos_b, sin_b, fb, eps)
            return out

        transformer.flash_attention, stft.fused_log_mel = flash, mel
        try:
            yield
        finally:
            transformer.flash_attention, stft.fused_log_mel = flash0, mel0

    def replay(self) -> dict:
        """Each recorded call again through the kernel and its plain
        version (after the paths' counts were read: these launches are not
        counted), at the tolerances of phase 3."""
        flash = []
        for (path, shape, kshape), (q, k, v, off) in self.flash.items():
            err = flash_err(q, k, v, off)
            flash.append(dict(path=path, shape=[*shape, kshape[2]], offsets=off.tolist(), max_abs_err=err))
            check(err <= FLASH_ATOL, f"flash on path {path}'s inputs {flash[-1]}: err > {FLASH_ATOL}")
        mel = []
        for (path, shape, stride, _), (frames, cos_b, sin_b, fb, eps) in self.mel.items():
            got = log_mel.fused_log_mel(frames, cos_b, sin_b, fb, eps)
            want = log_mel.fused_log_mel_plain(frames, cos_b, sin_b, fb, eps)
            err = float((got - want).abs().max())
            mel.append(dict(path=path, shape=list(shape), frame_stride=stride[1], max_abs_err=err))
            check(bool(torch.isfinite(got).all()) and err <= LOGMEL_ATOL,
                  f"log-mel on path {path}'s inputs {mel[-1]}: not finite or err > {LOGMEL_ATOL}")
        return dict(flash_attention=flash, fused_log_mel=mel)

    def batch_flash(self):
        """Path D's B = 8 prefill inputs."""
        return next(t for (path, shape, _), t in self.flash.items() if path == "D" and shape[0] == 8)


# ----------------------------------------------------------------------------- main path


def synthetic_wav(seed: int, seconds: float = 3.0, sr: int = 16000) -> np.ndarray:
    """A seeded stand-in for a prompt recording: a few sinusoids with slow
    amplitude envelopes plus noise, in [-1, 1]."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = 0.02 * rng.standard_normal(t.shape)
    for _ in range(5):
        f0, a, fm = rng.uniform(90, 3000), rng.uniform(0.05, 0.2), rng.uniform(0.5, 4.0)
        x += a * (0.6 + 0.4 * np.sin(2 * np.pi * fm * t)) * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 6.28))
    return np.clip(x, -1.0, 1.0).astype(np.float32)


def build_store(eng: Engine, cfg: Config, rows: int, gen) -> StyleStore:
    """A style DB whose rows carry prompt artifacts featurized at insert
    time from synthetic 3 s wavs: 75 speech tokens, 150 x 80 prompt mel and
    a 192-d speaker embedding per row."""
    rng = np.random.default_rng(int(torch.randint(0, 2 ** 31, (1,), generator=gen, device="cuda")))
    store = StyleStore(dim=cfg.retrieval.dim, capacity=64)
    store.insert(rng.standard_normal((rows, cfg.retrieval.dim)).astype(np.float32),
                 [{"file_id": f"style_{i}", "text": f"This is style line number {i}."}
                  for i in range(rows)])
    store.artifacts = rag.prompt_artifacts(eng, [synthetic_wav(100 + i) for i in range(rows)], batch=2)
    a = store.artifacts
    check(a["speech_tokens"].shape == (rows, 75) and bool((a["speech_token_lens"] == 75).all()),
          f"store tokens {a['speech_tokens'].shape} / lens {a['speech_token_lens']}, expected 75 per row")
    check(a["prompt_mel"].shape == (rows, 150, cfg.cfm.n_mels) and bool((a["prompt_mel_lens"] == 150).all()),
          f"store mel {a['prompt_mel'].shape}, expected 150 frames per row")
    check(a["spk"].shape == (rows, cfg.speaker.emb_dim) and bool(np.isfinite(a["prompt_mel"]).all())
          and np.allclose(np.linalg.norm(a["spk"], axis=1), 1.0, atol=1e-3), "store spk / mel values")
    check(int(a["speech_tokens"].min()) >= 0 and int(a["speech_tokens"].max()) < cfg.speech_tokenizer.codebook_size,
          "store tokens outside the codebook")
    return store


TEXTS = [
    "The weather is lovely today, so we will walk to the park.",
    "Please read the next line with a little more energy.",
    "On March 3rd the train leaves at 10:45 from platform 2.",
    "I can't believe you finished the whole thing already!",
]


def reset_counts() -> None:
    flash_attn.flash_attention.launches = 0
    decode_step.mega_decode_step.launches = 0
    decode_step.mega_decode_step.launches_int4 = 0
    decode_step.attn_step.launches = 0
    decode_step.mlp_step.launches = 0
    log_mel.fused_log_mel.launches = 0


def read_counts() -> dict:
    return {"flash_attention": flash_attn.flash_attention.launches,
            "mega_decode_step": decode_step.mega_decode_step.launches,
            "mega_decode_step_int4": decode_step.mega_decode_step.launches_int4,
            "attn_step": decode_step.attn_step.launches,
            "mlp_step": decode_step.mlp_step.launches,
            "fused_log_mel": log_mel.fused_log_mel.launches}


def run_request(eng: Engine, cfg: Config, kind: str, call) -> dict:
    """Time one request, check its wav, and return its record."""
    t0 = time.perf_counter()
    wav = next(call())["tts_speech"]
    wall_ms = (time.perf_counter() - t0) * 1e3
    n = eng.last_gen_len
    tm = eng.last_timings
    check(wav.shape == (1, n * cfg.cfm.upsample * cfg.audio.hop_length),
          f"{kind}: wav shape {wav.shape} != gen_len {n} x {cfg.cfm.upsample * cfg.audio.hop_length}")
    check(n > 0 and bool(np.isfinite(wav).all()), f"{kind}: wav empty or not finite")
    rms = float(np.sqrt(np.mean(wav.astype(np.float64) ** 2)))
    check(rms > 1e-4, f"{kind}: wav is silent (rms {rms})")
    rec = dict(
        kind=kind, wall_ms=wall_ms, featurize_ms=tm.get("featurize"), prefill_ms=tm["prefill"],
        decode_ms=tm["decode"], decode_steps=eng.last_decode_steps,
        decode_ms_per_step=tm["decode"] / max(eng.last_decode_steps, 1),
        cfm_ms=tm["cfm"], vocoder_ms=tm["vocoder"], gen_len=n,
        audio_s=wav.shape[1] / cfg.audio.sample_rate, rms=rms)
    print("request", json.dumps(rec), flush=True)
    return rec


def engine_on_card(cfg: Config):
    dev = torch.device("cuda")
    mem0 = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    eng = Engine(cfg, seed=0)
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0, (torch.cuda.memory_allocated(dev) - mem0) / 1e9


def path_a(cfg: Config, gen):
    """Prompts from wavs: the DB's artifacts featurized at insert time, four
    DB-served requests, then raw-wav, zero-shot and registered-speaker
    requests."""
    reset_counts()
    eng, init_s, engine_gb = engine_on_card(cfg)
    store = build_store(eng, cfg, 4, gen)
    rng = np.random.default_rng(1)
    requests = []
    for text in TEXTS:
        hits = store.search(rng.standard_normal((1, cfg.retrieval.dim)).astype(np.float32), k=2)[0]
        sty, tim = eng.prompt_features_from_store(store, [hits[0].index, hits[1].index])
        requests.append(run_request(eng, cfg, "db_served", lambda: eng.inference_tts_with_st(
            text, hits[0].text, sty, tim, max_seconds=5)))
    n_mel0 = log_mel.fused_log_mel.launches
    style_wav, timbre_wav = synthetic_wav(7), synthetic_wav(8)
    requests.append(run_request(eng, cfg, "raw_wavs", lambda: eng.inference_tts_with_st(
        TEXTS[0], "A calm reading voice.", style_wav, timbre_wav, max_seconds=5)))
    check(log_mel.fused_log_mel.launches == n_mel0 + 2,
          "one prompt_features call must launch fused_log_mel twice (16 kHz leg, 24 kHz leg)")
    requests.append(run_request(eng, cfg, "zero_shot", lambda: eng.inference_zero_shot(
        TEXTS[1], "A calm reading voice.", style_wav, max_seconds=5)))
    eng.register_speaker("narrator", timbre_wav)
    requests.append(run_request(eng, cfg, "registered_speaker", lambda: eng.inference_sft(
        TEXTS[2], "narrator", max_seconds=5)))
    check(all(r["featurize_ms"] is not None for r in requests[4:6]) and requests[6]["featurize_ms"] is None,
          "featurize span missing from a wav request (or present in a registered-speaker one)")
    launches = read_counts()
    for name in ("flash_attention", "mega_decode_step", "fused_log_mel"):
        check(launches[name] > 0, f"path A never launched {name}: {launches}")
    return eng, store, dict(init_s=init_s, engine_gb=engine_gb, requests=requests, launches=launches,
                            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def path_b(eng: Engine, store: StyleStore, cfg: Config, gen, n_tokens: int = 32):
    """The per-layer decode flavour: one ``generate_speech`` over per-layer
    views of the engine's int8 weights, EOS masked throughout."""
    dev = torch.device("cuda")
    tl = cfg.token_lm
    layers = token_lm.unstack_decode_params(eng.params.token_lm, tl)
    check(layers[3]["wqkv"].data_ptr() == eng._mega_params["wqkv"][3].data_ptr(),
          "unstack_decode_params copied the weights instead of viewing them")
    text = torch.randint(16, 200, (1, 64), generator=gen, device=dev).to(torch.int32)
    sty = torch.tensor(store.artifacts["speech_tokens"][:1], dtype=torch.int32, device=dev)
    spk = torch.tensor(store.artifacts["spk"][:1], dtype=torch.float32, device=dev)
    clock = Stopwatch(dev)
    reset_counts()
    out = token_lm.generate_speech_from_ids(
        eng.params.token_lm, tl, text, torch.tensor([64], device=dev), sty,
        torch.tensor([sty.shape[1]], device=dev), spk, eng.generator, max_new_tokens=n_tokens,
        decode_params=layers, sampler=SamplerConfig(temperature=1.0, top_k=25), min_tokens=n_tokens,
        clock=clock)
    launches = read_counts()
    toks = out.tokens[0].tolist()
    check(int(out.lengths[0]) == n_tokens and all(0 <= t < 4096 for t in toks), f"list flavour tokens {toks}")
    check(launches["attn_step"] == n_tokens * tl.n_layers and launches["mlp_step"] == n_tokens * tl.n_layers
          and launches["mega_decode_step"] == 0, f"path B launches {launches}")
    return dict(tokens=n_tokens, prefill_ms=clock.ms["prefill"], decode_ms=clock.ms["decode"],
                decode_ms_per_token=clock.ms["decode"] / n_tokens, launches=launches)


def path_c(cfg: Config, store: StyleStore):
    """The int4 decode step: a second engine with ``quantize_lm_int4``."""
    cfg4 = serving_config()
    cfg4.quantize_lm_int4 = True
    reset_counts()
    eng4, init_s, engine_gb = engine_on_card(cfg4)
    check(decode_step.weight_bits(eng4._mega_params) == 4, "the int4 engine holds no int4 decode weights")
    requests = []
    for text, (a, b) in zip(TEXTS[:2], ((0, 1), (2, 3))):
        sty, tim = eng4.prompt_features_from_store(store, [a, b])
        requests.append(run_request(eng4, cfg4, "int4_db_served", lambda: eng4.inference_tts_with_st(
            text, store.meta[a]["text"], sty, tim, max_seconds=5)))
    launches = read_counts()
    check(launches["mega_decode_step_int4"] > 0 and launches["mega_decode_step"] == 0
          and launches["flash_attention"] > 0, f"path C launches {launches}")
    return dict(init_s=init_s, engine_gb=engine_gb, requests=requests, launches=launches)


BATCH_TEXTS = TEXTS + [
    "Turn left at the second light and keep going until the river.",
    "Nobody expected the meeting to run for three whole hours.",
    "Could you send me the report before lunch tomorrow?",
    "The children laughed as the kite climbed into the clouds.",
]


def check_wav(cfg: Config, kind: str, wav: np.ndarray, n_tokens: int) -> float:
    """The checks of ``run_request`` on one row: n tokens' worth of samples,
    finite, not silent. Returns the rms."""
    check(wav.shape == (n_tokens * cfg.cfm.upsample * cfg.audio.hop_length,),
          f"{kind}: wav shape {wav.shape} != gen_len {n_tokens} x {cfg.cfm.upsample * cfg.audio.hop_length}")
    check(n_tokens > 0 and bool(np.isfinite(wav).all()), f"{kind}: wav empty or not finite")
    rms = float(np.sqrt(np.mean(wav.astype(np.float64) ** 2)))
    check(rms > 1e-4, f"{kind}: wav is silent (rms {rms})")
    return rms


def run_batch(eng: Engine, cfg: Config, kind: str, texts, style_texts, styles, timbres) -> dict:
    """One ``synthesize_batch`` call: time it, check every wav, and return
    its record (requests/s = rows / wall seconds)."""
    t0 = time.perf_counter()
    wavs = eng.synthesize_batch(texts, style_texts, styles, timbres, max_seconds=5)
    wall_ms = (time.perf_counter() - t0) * 1e3
    check(len(wavs) == len(texts), f"{kind}: {len(wavs)} wavs for {len(texts)} rows")
    rms = [check_wav(cfg, f"{kind} row {i}", w, n) for i, (w, n) in enumerate(zip(wavs, eng.last_gen_lens))]
    tm = eng.last_timings
    audio_s = sum(len(w) for w in wavs) / cfg.audio.sample_rate
    rec = dict(kind=kind, B=len(texts), wall_ms=wall_ms, featurize_ms=tm.get("featurize"),
               prefill_ms=tm["prefill"], decode_ms=tm["decode"], decode_steps=eng.last_decode_steps,
               decode_ms_per_step=tm["decode"] / max(eng.last_decode_steps, 1), cfm_ms=tm["cfm"],
               vocoder_ms=tm["vocoder"], gen_lens=eng.last_gen_lens, audio_s=audio_s,
               requests_per_s=len(texts) / (wall_ms / 1e3), audio_s_per_wall_s=audio_s / (wall_ms / 1e3),
               rms_min=min(rms))
    print("batch", json.dumps(rec), flush=True)
    return rec


def dequant_ms(eng: Engine) -> dict:
    """What the scanned decode's int8 products widen to f32 in one step
    (``matmul_any``: every layer's four projections and the speech head),
    timed alone."""
    lm, L = eng.params.token_lm, eng.cfg.token_lm.n_layers
    names = ("wqkv", "wo", "w_gate_up", "w_down")

    def widen():
        for l in range(L):
            for n in names:
                lm["layers"][n].q[l].float()
        lm["speech_head"].q.float()

    n = sum(lm["layers"][k].q.numel() for k in names) + lm["speech_head"].q.numel()
    return dict(ms=time_ms(widen, 10, warmup=2), weights=n, bytes_written=4 * n)


def batch_args(eng: Engine, store: StyleStore):
    """(texts, style texts, styles, timbres) of 8 DB-served rows: row i
    takes its style from store row i % 4 and its timbre from row i + 1."""
    pairs = [(i % 4, (i + 1) % 4) for i in range(len(BATCH_TEXTS))]
    return (BATCH_TEXTS, [store.meta[a]["text"] for a, _ in pairs],
            [eng.prompt_features_from_store(store, [a])[0] for a, _ in pairs],
            [eng.prompt_features_from_store(store, [b])[0] for _, b in pairs])


def path_d(eng: Engine, store: StyleStore, cfg: Config) -> dict:
    """A flagship batch: 8 DB-served rows through the scanned decode with
    the int8 KV cache (a first call pays the batch shapes' set-up), the
    same batch with a bf16 cache, and one B=1 voice conversion through the
    staged path."""
    args = batch_args(eng, store)
    reset_counts()
    first = run_batch(eng, cfg, "int8 kv, first call", *args)
    int8 = run_batch(eng, cfg, "int8 kv", *args)
    check(cfg.quantize_lm_kv_int8, "path D's engine serves an int8 KV cache")
    eng.cfg.quantize_lm_kv_int8 = False
    try:
        bf16 = run_batch(eng, cfg, "bf16 kv", *args)
    finally:
        eng.cfg.quantize_lm_kv_int8 = True
    n_mel0 = log_mel.fused_log_mel.launches
    src, prm = synthetic_wav(9), synthetic_wav(8)
    t0 = time.perf_counter()
    wav = next(eng.inference_vc(src, prm))["tts_speech"]
    vc_ms = (time.perf_counter() - t0) * 1e3
    n_src = len(src) // (cfg.audio.prompt_hop_length * int(np.prod(cfg.speech_tokenizer.strides)))
    check(wav.shape[0] == 1 and eng.last_gen_len == n_src,
          f"inference_vc: {wav.shape}, {eng.last_gen_len} tokens ({n_src} in the source)")
    vc = dict(wall_ms=vc_ms, rms=check_wav(cfg, "inference_vc", wav[0], eng.last_gen_len),
              decode_steps=eng.last_decode_steps, timings=eng.last_timings)
    check(log_mel.fused_log_mel.launches == n_mel0 + 2 and eng.last_decode_steps == 0
          and "prefill" not in eng.last_timings, "inference_vc: one featurize call (two log-mel launches), no LM")
    launches = read_counts()
    check(launches["flash_attention"] > 0 and launches["mega_decode_step"] == 0
          and launches["mega_decode_step_int4"] == 0, f"path D launches {launches}")
    return dict(first_call=first, int8_kv=int8, bf16_kv=bf16, vc=vc, dequant_per_step=dequant_ms(eng),
                launches=launches)


def low_band_share(wav: np.ndarray, sr: int, below_hz: float = 4000.0) -> float:
    spec = np.abs(np.fft.rfft(wav * np.hanning(wav.size))) ** 2
    freqs = np.fft.rfftfreq(wav.size, 1 / sr)
    return float(spec[freqs < below_hz].sum() / max(spec.sum(), 1e-9))


def golden_stats(eng: Engine, wav: np.ndarray, g: dict) -> dict:
    """A converted row's statistics beside the golden ones and their limits."""
    a = eng.cfg.audio
    mel = stft.log_mel_spectrogram(torch.from_numpy(wav[None]).to(eng.device), a.sample_rate, a.n_fft,
                                   a.hop_length, a.win_length, n_mels=a.n_mels, fmax=a.fmax)[0].cpu().numpy()
    rms = float(np.sqrt((wav.astype(np.float64) ** 2).mean()))
    return dict(n_samples=wav.size, golden_n_samples=g["n_samples"], rms=rms, golden_rms=g["rms"],
                rms_limit=GOLDEN_RMS_REL * g["rms"] + GOLDEN_RMS_ABS,
                d_mel_mean=float(np.abs(mel.mean(0) - np.asarray(g["mel_mean"])).mean()),
                d_mel_std=float(np.abs(mel.std(0) - np.asarray(g["mel_std"])).mean()), d_mel_limit=GOLDEN_MEL,
                like_for_like_rms_limit=LIKE_RMS, like_for_like_mel_limit=LIKE_MEL)


def path_e() -> dict:
    """The trained demo engine on the card, held to the JAX package's
    thresholds (each value printed beside its own). Voice conversion of
    rows[:3] on the CFM noise the golden statistics were made with
    (``demo_vc_noise.npz``: the JAX engine's draws) gives the golden check,
    held also to the like-for-like bounds (``LIKE_RMS``, ``LIKE_MEL``), and
    the token round trip; the same rows on the card's own noise are
    printed beside them (the golden margins are not made for other draws);
    the zero-shot line is rows[-1]'s text on rows[0]'s prompt; then a B=4
    batch of rows 0-3, each row its own style and timbre."""
    cfg = demo_config()
    rows = json.loads((FIXTURES / "demo_corpus_sample" / "manifest.json").read_text())
    golden = json.loads((FIXTURES / "golden_quality.json").read_text())
    a = cfg.audio

    def load(row):
        wav, sr = read_wav(FIXTURES / "demo_corpus_sample" / row["wav"])
        check(sr == a.prompt_sample_rate, f"{row['wav']}: {sr} Hz")
        return wav

    reset_counts()
    eng = Engine(cfg, params=EngineParams.from_tree(from_jax_tree(load_npz(FIXTURES / "demo_engine.npz"), cfg)),
                 seed=0)
    check(eng._mega_params is None, "the demo LM is dense: no decode-kernel weights")
    vc, agrees, out_wavs = [], [], []
    with np.load(FIXTURES / "demo_vc_noise.npz") as noises:
        for row in rows[:3]:
            src = load(row)
            tokens = eng.prompt_features([src])[0].tokens
            g = golden[row["wav"]]
            t0 = time.perf_counter()
            wav = next(eng.inference_vc(src, src, cfm_noise=noises[Path(row["wav"]).stem]))["tts_speech"].ravel()
            wall_ms = (time.perf_counter() - t0) * 1e3
            out_wavs.append((f"vc {row['wav']}", row["text"], wav))
            agree, n = token_round_trip(eng, wav, tokens)
            own = golden_stats(eng, next(eng.inference_vc(src, src))["tts_speech"].ravel(), g)
            rec = dict(wav=row["wav"], wall_ms=wall_ms, **golden_stats(eng, wav, g), round_trip_agree=agree,
                       round_trip_n=n, round_trip_min_n=ROUND_TRIP_MIN_N,
                       own_noise={k: own[k] for k in ("n_samples", "rms", "d_mel_mean", "d_mel_std")})
            print("demo golden", json.dumps(rec), flush=True)
            check(rec["n_samples"] == g["n_samples"], f"demo {row['wav']}: {rec['n_samples']} samples != golden")
            check(abs(rec["rms"] - g["rms"]) < rec["rms_limit"], f"demo {row['wav']}: rms {rec['rms']} vs {g['rms']}")
            check(rec["d_mel_mean"] < GOLDEN_MEL and rec["d_mel_std"] < GOLDEN_MEL,
                  f"demo {row['wav']}: mel stats {rec['d_mel_mean']}, {rec['d_mel_std']}")
            check(abs(rec["rms"] - g["rms"]) < LIKE_RMS and rec["d_mel_mean"] < LIKE_MEL
                  and rec["d_mel_std"] < LIKE_MEL, f"demo {row['wav']}: not like for like with the JAX engine")
            check(n > ROUND_TRIP_MIN_N, f"demo {row['wav']}: round trip over {n} tokens")
            vc.append(rec)
            agrees.append(agree)
    round_trip = dict(mean_agree=float(np.mean(agrees)), limit=ROUND_TRIP_AGREE)
    print("demo round trip", json.dumps(round_trip), flush=True)
    check(round_trip["mean_agree"] > ROUND_TRIP_AGREE, f"demo token round trip {agrees}")

    t0 = time.perf_counter()
    wav = next(eng.inference_zero_shot(rows[-1]["text"], rows[0]["text"], load(rows[0])))["tts_speech"].ravel()
    zs = dict(wall_ms=(time.perf_counter() - t0) * 1e3, seconds=wav.size / a.sample_rate,
              min_seconds=ZERO_SHOT_MIN_S, finite=bool(np.isfinite(wav).all()),
              rms=float(np.sqrt((wav.astype(np.float64) ** 2).mean())), min_rms=ZERO_SHOT_RMS,
              low_band_share=low_band_share(wav, a.sample_rate), min_low_band_share=ZERO_SHOT_LOW_BAND,
              gen_len=eng.last_gen_len, decode_steps=eng.last_decode_steps, timings=eng.last_timings)
    print("demo zero-shot", json.dumps(zs), flush=True)
    out_wavs.append(("zero-shot", rows[-1]["text"], wav))
    check(zs["finite"] and zs["seconds"] > ZERO_SHOT_MIN_S and zs["rms"] > ZERO_SHOT_RMS
          and zs["low_band_share"] > ZERO_SHOT_LOW_BAND, f"demo zero-shot gates: {zs}")
    wavs = [load(r) for r in rows[:4]]
    batch = run_batch(eng, cfg, "demo B=4", [r["text"] for r in rows[:4]], [r["text"] for r in rows[:4]],
                      wavs, wavs)
    gates = demo_gates(eng, rows, load)
    launches = read_counts()
    check(launches["fused_log_mel"] > 0 and launches["flash_attention"] > 0
          and launches["mega_decode_step"] == 0, f"path E launches {launches}")
    return dict(golden=vc, round_trip=round_trip, zero_shot=zs, batch=batch, gates=gates, launches=launches,
                wavs=out_wavs)


def demo_gates(eng: Engine, rows, load) -> dict:
    """The other gates of the JAX package's ``tests/test_trained_demo.py``
    on the card, at its thresholds (``tests/test_torch_trained_demo.py``
    holds them on the CPU): phoneme purity of the speech tokens; speaker
    similarity on ``SpeakerScorer``; the trained iSTFT vocoder's mel-L1
    (``demo_vocoder_istft.npz``); the distilled 2-step CFM against its
    10-step teacher (``demo_cfm_distilled.npz``) from one noise draw of a
    seeded generator (the gate compares the three solves on the same draw)."""
    cfg, a = eng.cfg, eng.cfg.audio
    votes, total = {}, 0
    for row in rows:
        tokens = eng.prompt_features([load(row)])[0].tokens
        phn = np.load(FIXTURES / "demo_corpus_sample" / row["phn"])
        for t, p in zip(tokens[: len(phn)], phn[: len(tokens)]):
            votes.setdefault(int(p), {}).setdefault(int(t), 0)
            votes[int(p)][int(t)] += 1
            total += 1
    purity = sum(max(c.values()) for c in votes.values()) / max(total, 1)
    rec = dict(purity=purity, purity_limit=max(PURITY, 3.0 / max(len(votes), 1)), phonemes=len(votes),
               codes=len({t for c in votes.values() for t in c}))
    check(purity > rec["purity_limit"], f"demo tokenizer purity {rec}")

    by_spk = {}
    for r in rows:
        by_spk.setdefault(r["speaker"], r)
    spk_a, spk_b = list(by_spk.values())[:2]
    wav_a, wav_b = load(spk_a), load(spk_b)
    out = next(eng.inference_tts_with_st(rows[-1]["text"], spk_a["text"], wav_a, wav_a))["tts_speech"].ravel()
    wav16 = resample_poly_np(out, a.sample_rate, a.prompt_sample_rate)
    scorer = SpeakerScorer(eng)
    rec.update(sim_same_speaker=float(scorer.similarity([wav16], [wav_a])[0]),
               sim_other_speaker=float(scorer.similarity([wav16], [wav_b])[0]))
    check(rec["sim_same_speaker"] > rec["sim_other_speaker"], f"demo speaker similarity {rec}")

    vcfg = dataclasses.replace(cfg.vocoder, kind="istft", istft_channels=256, istft_blocks=6)
    voc = load_tree(FIXTURES / "demo_vocoder_istft.npz", vocoder.init_params(vcfg, torch.Generator(eng.device)))
    FB = 256
    wavs = np.zeros((len(rows), FB * a.hop_length), np.float32)
    masks = np.zeros((len(rows), FB), np.float32)
    for i, r in enumerate(rows):
        w = resample_poly_np(load(r), a.prompt_sample_rate, a.sample_rate)
        F = min(len(w) // a.hop_length, FB)
        wavs[i, : F * a.hop_length] = w[: F * a.hop_length]
        masks[i, :F] = 1
    mel_of = lambda x: stft.log_mel_spectrogram(x, a.sample_rate, a.n_fft, a.hop_length, a.win_length,
                                                n_mels=a.n_mels, fmax=a.fmax)
    mels = mel_of(torch.from_numpy(wavs).to(eng.device))[:, :FB]
    pred = mel_of(vocoder.apply(voc, vcfg, mels)[:, : FB * a.hop_length])[:, :FB]
    m = torch.from_numpy(masks).to(eng.device)[..., None]
    rec.update(istft_mel_l1=float(((pred - mels).abs() * m).sum() / (m.sum() * a.n_mels)), istft_limit=ISTFT_L1)
    check(rec["istft_mel_l1"] < ISTFT_L1, f"demo iSTFT vocoder {rec}")

    feats = eng.prompt_features([load(rows[-1])])[0]
    c, dev = cfg.cfm, eng.device
    F = len(feats.tokens) * c.upsample
    gt = torch.zeros((1, F, c.n_mels), device=dev)
    nm = min(feats.mel24.shape[0], F)
    gt[0, :nm] = torch.from_numpy(feats.mel24[:nm]).to(dev)
    pmask = (torch.arange(F, device=dev)[None, :] < F // 4).float()
    fmask = torch.ones((1, F), device=dev)
    noise = torch.randn((1, F, c.n_mels), generator=torch.Generator(dev).manual_seed(4), device=dev)
    tokens = torch.from_numpy(feats.tokens.astype(np.int64))[None].to(dev)
    spk = torch.from_numpy(feats.spk)[None].to(dev)
    student = load_tree(FIXTURES / "demo_cfm_distilled.npz", eng.params.cfm)
    fast = dataclasses.replace(c, n_steps=2, use_cfg=False)
    solve = lambda p, cc, guided: cfm.sample_mel(p, cc, None, cfm.upsample_tokens(p, tokens, c.upsample,
                                                                                  c.token_vocab_size),
                                                 spk, gt * pmask[..., None], pmask, fmask, use_cfg=guided, noise=noise)
    w = (fmask * (1 - pmask))[..., None]
    l1 = lambda x, y: float((w * (x - y).abs()).sum() / (w.sum() * c.n_mels))
    teacher = solve(eng.params.cfm, c, True)
    m_student, m_fast = solve(student, fast, False), solve(eng.params.cfm, fast, False)
    rec.update(d_student=l1(m_student, teacher), d_fast=l1(m_fast, teacher), g_teacher=l1(teacher, gt),
               g_student=l1(m_student, gt))
    check(rec["d_student"] < DISTILL_RATIO * rec["d_fast"] and rec["g_student"] < rec["g_teacher"] + DISTILL_SLACK,
          f"demo distilled CFM {rec}")
    print("demo gates", json.dumps(rec), flush=True)
    return rec


def hifigan_macs(vcfg: VocoderConfig, frames: int) -> int:
    """Multiply-adds of one HiFi-GAN pass over ``frames`` mel frames."""
    C, T = vcfg.base_channels, frames
    macs = 7 * vcfg.n_mels * C * T
    for rate, k in zip(vcfg.upsample_rates, vcfg.upsample_kernel_sizes):
        macs += k * C * (C // 2) * T          # the transposed conv, per input frame
        C, T = C // 2, T * rate
        taps = sum(kern * len(d) for kern, d in zip(vcfg.resblock_kernel_sizes, vcfg.resblock_dilations))
        macs += 2 * taps * C * C * T
    return macs + 7 * C * T


def path_f(gen) -> dict:
    """The HiFi-GAN kind at flagship widths (base 512, rates 5-4-4-3-2) on a
    5 s mel, random weights: device milliseconds (CUDA events) and the
    real-time factor (time / seconds of audio produced) at B=1 and B=8."""
    vcfg = VocoderConfig(kind="hifigan")
    params = vocoder.init_params(vcfg, gen)
    seconds, sr = 5, 24000
    frames = seconds * sr // vocoder.total_upsample(vcfg)
    out = {}
    for B in (1, 8):
        mel = torch.randn((B, frames, vcfg.n_mels), generator=gen, device=gen.device)
        wav = vocoder.apply(params, vcfg, mel)
        torch.cuda.synchronize()
        check(wav.shape == (B, frames * vocoder.total_upsample(vcfg)) and bool(torch.isfinite(wav).all())
              and float(wav.abs().max()) <= 1.0, f"hifigan B={B}: {tuple(wav.shape)}")
        ms = time_ms(lambda: vocoder.apply(params, vcfg, mel), 3 if B == 8 else 10, warmup=1)
        flop = 2 * hifigan_macs(vcfg, frames) * B
        out[f"B={B}"] = dict(ms=ms, audio_s=seconds * B, rtf=ms / 1e3 / (seconds * B), gflop=flop / 1e9,
                             tflop_per_s=flop / (ms / 1e3) / 1e12, bound_ms=flop / F32_FLOP_PER_S * 1e3)
    return out


# ----------------------------------------------------------------------------- paths G and H


@contextmanager
def decode_runs():
    """The ``SpeechGen`` of every decode loop the engine runs while open
    (``token_lm.start_decode`` wrapped where the engine calls it; the
    loop's yields and launches are untouched)."""
    seen, start = [], token_lm.start_decode

    def recording(*a, **k):
        loop = start(*a, **k)

        def run():
            gen = yield from loop
            seen.append(gen)
            return gen

        return run()

    token_lm.start_decode = recording
    try:
        yield seen
    finally:
        token_lm.start_decode = start


def run_stream(eng: Engine, cfg: Config, kind: str, call) -> dict:
    """One request unstreamed (``call(False)``), then streamed
    (``call(True)``) from the same generator state: the chunks must join to
    the unstreamed wav's length, from the same tokens."""
    state = eng.generator.get_state()
    with decode_runs() as runs:
        t0 = time.perf_counter()
        wav = next(call(False))["tts_speech"]
        unstreamed_ms = (time.perf_counter() - t0) * 1e3
        n_unstreamed, unstreamed_timings = eng.last_gen_len, eng.last_timings
        eng.generator.set_state(state)
        t0 = time.perf_counter()
        chunks = [c["tts_speech"] for c in call(True)]
        stream_ms = (time.perf_counter() - t0) * 1e3
    joined = np.concatenate(chunks, axis=1)
    check(joined.shape == wav.shape and eng.last_gen_len == n_unstreamed,
          f"{kind}: streamed {joined.shape} ({eng.last_gen_len} tokens), unstreamed {wav.shape} ({n_unstreamed})")
    if runs:
        check(len(runs) == 2 and torch.equal(runs[0].tokens, runs[1].tokens),
              f"{kind}: the streamed tokens differ from the unstreamed ones")
    per_token = cfg.cfm.upsample * cfg.audio.hop_length
    chunk = max(8, (2 * cfg.token_lm.token_rate) // 3)
    check(len(chunks) == -(-n_unstreamed // chunk) and all(c.shape[1] == chunk * per_token for c in chunks[:-1]),
          f"{kind}: {len(chunks)} chunks of {[c.shape[1] for c in chunks]} samples for {n_unstreamed} tokens")
    tm = eng.last_timings
    rec = dict(kind=kind, ttfa_ms=tm["ttfa"], chunks=len(chunks), chunk_render_ms=eng.last_chunk_ms,
               stream_wall_ms=stream_ms, tokens=n_unstreamed, audio_s=joined.shape[1] / cfg.audio.sample_rate,
               unstreamed_wall_ms=unstreamed_ms, tokens_equal_unstreamed=bool(runs) or None,
               decode_steps=eng.last_decode_steps, featurize_ms=tm.get("featurize"), prefill_ms=tm.get("prefill"),
               decode_ms=tm.get("decode"), cfm_ms=tm["cfm"], vocoder_ms=tm["vocoder"],
               unstreamed_timings=unstreamed_timings,
               rms=check_wav(cfg, kind, joined[0], n_unstreamed))
    print("stream", json.dumps(rec), flush=True)
    return rec


def path_g(eng: Engine, store: StyleStore, cfg: Config) -> dict:
    """Streaming, B=1: two DB-served ``inference_tts_with_st`` streams, a
    raw-wav zero-shot stream, a voice-conversion stream and a stream on an
    int4 engine, each beside the same request unstreamed from the same
    generator state."""
    reset_counts()
    streams = []
    for text, (a, b) in zip(TEXTS[:2], ((0, 1), (2, 3))):
        sty, tim = eng.prompt_features_from_store(store, [a, b])
        streams.append(run_stream(eng, cfg, "db_served", lambda stream: eng.inference_tts_with_st(
            text, store.meta[a]["text"], sty, tim, stream=stream, max_seconds=5)))
    prompt = synthetic_wav(7)
    streams.append(run_stream(eng, cfg, "zero_shot_raw_wav", lambda stream: eng.inference_zero_shot(
        TEXTS[2], "A calm reading voice.", prompt, stream=stream, max_seconds=5)))
    src, prm = synthetic_wav(9), synthetic_wav(8)
    streams.append(run_stream(eng, cfg, "vc", lambda stream: eng.inference_vc(src, prm, stream=stream)))
    cfg4 = serving_config()
    cfg4.quantize_lm_int4 = True
    eng4 = Engine(cfg4, seed=0)
    check(decode_step.weight_bits(eng4._mega_params) == 4, "the int4 engine holds no int4 decode weights")
    sty, tim = eng4.prompt_features_from_store(store, [1, 2])
    streams.append(run_stream(eng4, cfg4, "int4_db_served", lambda stream: eng4.inference_tts_with_st(
        TEXTS[3], store.meta[1]["text"], sty, tim, stream=stream, max_seconds=5)))
    launches = read_counts()
    for name in ("flash_attention", "mega_decode_step", "mega_decode_step_int4", "fused_log_mel"):
        check(launches[name] > 0, f"path G never launched {name}: {launches}")
    return dict(streams=streams, launches=launches)


@contextmanager
def timed(module, name: str, out: list):
    """Each call of ``module.name`` while open, synchronized and timed:
    (batch rows, milliseconds) appended to ``out``."""
    fn = getattr(module, name)

    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*a, **k)
        torch.cuda.synchronize()
        rows = a[2].embeds.shape[0] if name == "prefill_prefix" else a[3].shape[0]
        out.append((rows, (time.perf_counter() - t0) * 1e3))
        return r

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


# per-request token caps of path H's batch: with EOS masked up to the largest,
# every request runs to its cap, so the admissions are B = 4 (the first
# four), 2 (the two shortest finish in the same chunk), then 1s
H_CAPS = (24, 30, 60, 125, 40, 72, 96, 110)
H_CHUNK = 16


def path_h(eng: Engine, store: StyleStore, cfg: Config) -> dict:
    """Continuous batching: ``ContinuousBatcher(slots=4, chunk=16,
    p_max=384)`` with the int8 KV cache serves 8 DB-served requests of
    ``H_CAPS`` tokens (all submitted at once), each tick's finished requests
    rendered through the staged batch path (``synthesize_from_tokens``) as
    they finish; per-request latency is submit to audio on the host. Then
    ``StreamingScheduler(slots=4)`` serves 4 concurrent sessions: each
    session's time to its first chunk, and every first chunk before the
    first session ends."""
    up_hop = cfg.cfm.upsample * cfg.audio.hop_length
    reset_counts()
    prefills, decodes = [], []
    with timed(token_lm, "prefill_prefix", prefills), timed(token_lm, "decode_chunk", decodes):
        bat = ContinuousBatcher(eng, slots=4, chunk=H_CHUNK, p_max=384, min_tokens=max(H_CAPS))
        check("k_scale" in bat.cache, "path H's batcher serves the int8 KV cache")
        reqs = []
        for i, cap in enumerate(H_CAPS):
            a, b = i % 4, (i + 1) % 4
            reqs.append(dict(id=f"h{i}", text=BATCH_TEXTS[i], style_text=store.meta[a]["text"],
                             style_feat=eng.prompt_features_from_store(store, [a])[0],
                             flow_feat=eng.prompt_features_from_store(store, [b])[0], max_tokens=cap))
        t0 = time.perf_counter()
        for r in reqs:
            bat.submit(r)
        latency, ticks = {}, 0
        while not bat.idle:
            finished = bat.step()
            ticks += 1
            if finished:
                wavs = eng.synthesize_from_tokens(finished, max_seconds=5)
                for r, w in zip(finished, wavs):
                    latency[r["id"]] = (time.perf_counter() - t0) * 1e3
                    check(len(r["tokens"]) == r["max_tokens"], f"{r['id']}: {len(r['tokens'])} tokens, cap {r['max_tokens']}")
                    check_wav(cfg, f"continuous {r['id']}", w, len(r["tokens"]))
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(sorted(latency) == sorted(r["id"] for r in reqs) and not bat.take_rejected(), f"served {sorted(latency)}")
    lat = np.asarray(sorted(latency.values()))
    cont = dict(requests=len(reqs), caps=list(H_CAPS), ticks=ticks, wall_ms=wall_ms,
                latency_ms=dict(sorted(latency.items())), latency_p50_ms=float(np.percentile(lat, 50)),
                latency_p95_ms=float(np.percentile(lat, 95)), requests_per_s=len(reqs) / (wall_ms / 1e3),
                audio_s=sum(H_CAPS) * up_hop / cfg.audio.sample_rate,
                decode_ms_per_step=sum(ms for _, ms in decodes) / (len(decodes) * H_CHUNK),
                decode_chunk_ms=[ms for _, ms in decodes],
                admission_prefill_ms=[dict(B=b, ms=ms) for b, ms in prefills])
    print("continuous", json.dumps(cont), flush=True)

    caps = (48, 64, 80, 96)     # 3-6 chunks a session, EOS masked up to them as above
    sch = StreamingScheduler(eng, slots=4, min_tokens=max(caps))
    t0 = time.perf_counter()
    sids = [sch.submit(dict(text=TEXTS[i], style_text=store.meta[i]["text"],
                            style_feat=eng.prompt_features_from_store(store, [i])[0],
                            flow_feat=eng.prompt_features_from_store(store, [(i + 1) % 4])[0], max_tokens=cap))
            for i, cap in enumerate(caps)]
    order, samples = [], {s: 0 for s in sids}
    while not sch.idle:
        for ev in sch.step():
            order.append((ev.session, ev.kind, (time.perf_counter() - t0) * 1e3))
            samples[ev.session] += len(ev.wav)
            check(ev.kind != "error", f"session {ev.session}: {ev.error}")
    sessions = sch.take_finished()
    first_chunk = {s: next(t for sid, k, t in order if sid == s and k == "chunk") for s in sids}
    first_done = min(t for _, k, t in order if k == "done")
    at = {s: next(i for i, (sid, k, _) in enumerate(order) if sid == s and k == "chunk") for s in sids}
    check(max(at.values()) < min(i for i, (_, k, _) in enumerate(order) if k == "done"),
          f"a session's first chunk came after another session ended: {order}")
    for s in sids:
        check(samples[s] == len(sessions[s].tokens) * up_hop > 0, f"session {s}: {samples[s]} samples "
              f"for {len(sessions[s].tokens)} tokens")
    sched = dict(sessions=len(sids), caps=list(caps), first_chunk_ms=first_chunk, first_done_ms=first_done,
                 wall_ms=(time.perf_counter() - t0) * 1e3, tokens={s: len(sessions[s].tokens) for s in sids},
                 chunk_events=sum(1 for _, k, _ in order if k == "chunk"))
    print("scheduler", json.dumps(sched), flush=True)
    launches = read_counts()
    check(launches["flash_attention"] > 0 and launches["mega_decode_step"] == 0
          and launches["mega_decode_step_int4"] == 0, f"path H launches {launches}")
    return dict(continuous=cont, scheduler=sched, launches=launches)


# ----------------------------------------------------------------------------- path I

ADAPTER = Path(__file__).resolve().parent / "artifacts" / "ft3b" / "adapter_f16.npz"
RAG_SAMPLES = [   # (speaker, line): the style DB's 8 utterances of 2 speakers
    ("w1", "I can't believe you remembered my birthday, this is wonderful!"),
    ("m1", "We have to leave now or we will miss the last train home."),
    ("w1", "Honestly, I am tired of explaining the same thing every single day."),
    ("m1", "That's fine, take your time, there is no rush at all."),
    ("w1", "Oh no, I think I left the keys inside the car again."),
    ("m1", "Stop shouting at me, I did exactly what you asked for!"),
    ("w1", "Let me read you the letter she sent last week."),
    ("m1", "The results came back and everything looks perfectly normal."),
]
RAG_DIALOG = [    # (speaker, line): the dialog whose turns are served from the DB
    ("w1", "Did you hear the news about the concert tonight?"),
    ("m1", "Yes, and I still can't find my ticket anywhere."),
    ("w1", "You lost it again? That is the third time this month."),
    ("m1", "Please, just help me look under the sofa."),
]


@contextmanager
def rag_timings():
    """Each ``transformer.generate`` and ``transformer.embed_text`` call the
    embedder service makes while open, synchronized and timed (a generate's
    prefill apart: its ``forward`` over the prompt's tokens into the
    cache): dicts appended to the yielded lists."""
    gens, embeds = [], []
    gen0, emb0, fwd0 = transformer.generate, transformer.embed_text, transformer.forward
    prefill = []

    def forward(*a, **k):
        tokens = a[2] if len(a) > 2 else k.get("tokens")
        if tokens is None or tokens.shape[1] == 1 or k.get("cache") is None:
            return fwd0(*a, **k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fwd0(*a, **k)
        torch.cuda.synchronize()
        prefill.append((time.perf_counter() - t0) * 1e3)
        return out

    def generate(params, cfg, prompt, prompt_len, cache, generator, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = gen0(params, cfg, prompt, prompt_len, cache, generator, **k)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n, eos = k["max_new_tokens"], k["eos_id"]
        toks, lens = res.tokens.cpu(), res.lengths.cpu()
        # steps the loop ran: it stops after the step where every row is done
        ends = [int(l) + 1 if int(l) < n and int(toks[b, int(l)]) == eos else n for b, l in enumerate(lens)]
        steps = min(n, max(ends))
        pre = prefill.pop()
        gens.append(dict(B=prompt.shape[0], P=prompt.shape[1], max_new=n, steps=steps, ms=ms, prefill_ms=pre,
                         decode_ms_per_step=(ms - pre) / max(steps - 1, 1), lengths=lens.tolist()))
        return res

    def embed_text(params, cfg, tokens, attn_mask, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = emb0(params, cfg, tokens, attn_mask, **k)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(bool(torch.isfinite(out).all()), f"embed_text at {tuple(tokens.shape)}: not finite")
        embeds.append(dict(rows=tokens.shape[0], T=tokens.shape[1], ms=ms, ms_per_row=ms / tokens.shape[0]))
        return out

    transformer.generate, transformer.embed_text, transformer.forward = generate, embed_text, forward
    try:
        yield gens, embeds
    finally:
        transformer.generate, transformer.embed_text, transformer.forward = gen0, emb0, fwd0


def rag_clis(d: Path) -> dict:
    """The three retrieval CLIs through their ``main`` at ``--tiny``
    geometry with their default device (the card): insert (with the style
    wavs' artifacts) -> search_json -> tts_with_rag --style_db."""
    from autostyle_tts_tpu_torch.cli import insert_embeddings, search_json, tts_with_rag
    from autostyle_tts_tpu_torch.utils.config import tiny_config

    sr = tiny_config().audio.prompt_sample_rate
    (d / "styles").mkdir()
    manifest = []
    for i, (spk, text) in enumerate(RAG_SAMPLES[:4]):
        write_wav(d / "styles" / f"style_{i}.wav", synthetic_wav(300 + i, 1.0, sr), sr)
        manifest.append({"speaker": spk, "zh_text": text, "file_id": f"style_{i}.wav"})
    (d / "styles.json").write_text(json.dumps(manifest))
    (d / "turns.jsonl").write_text("".join(json.dumps({"zh_text": t, "speaker": s}) + "\n" for s, t in RAG_DIALOG))
    for spk, seed in (("w1", 310), ("m1", 311)):
        write_wav(d / f"timbre_{spk}.wav", synthetic_wav(seed, 1.0, sr), sr)
    t0 = time.perf_counter()
    insert_embeddings.main(["--tiny", "--input_json", str(d / "styles.json"), "--db_path", str(d / "store"),
                            "--capacity", "16", "--style_wav_dir", str(d / "styles")])
    search_json.main(["--tiny", "--input_json", str(d / "turns.jsonl"), "--db_path", str(d / "store"),
                      "--output_file", str(d / "rows.jsonl"), "--file_prefix_path", str(d / "styles")])
    tts_with_rag.main(["--tiny", "--corresponding_json", str(d / "rows.jsonl"), "--result_dir", str(d / "out"),
                       "--timbre_map", f"w1={d / 'timbre_w1.wav'},m1={d / 'timbre_m1.wav'}",
                       "--style_db", str(d / "store")])
    rows = [json.loads(l) for l in (d / "rows.jsonl").read_text().splitlines()]
    wavs = sorted((d / "out").glob("*/*.wav"))
    check(len(rows) == len(RAG_DIALOG) and all(0 <= r["retrieved_index"] < 4 for r in rows),
          f"tiny search_json rows {rows}")
    check(len(wavs) == len(RAG_DIALOG), f"tiny tts_with_rag wrote {len(wavs)} wavs for {len(RAG_DIALOG)} rows")
    for w in wavs:
        x, _ = read_wav(w)
        check(x.size > 0 and bool(np.isfinite(x).all()), f"tiny tts_with_rag wav {w.name} empty or not finite")
    return dict(rows=len(rows), wavs=len(wavs), wall_s=time.perf_counter() - t0)


def path_i(eng: Engine, cfg: Config) -> dict:
    """The retrieval workflow at full width: ``Config().embedder``
    (Llama-3.2-3B geometry) as the int8 base drawn on the card from
    ``PRNGKey(42)``, the adapter's own, with the ft3b LoRA adapter (alpha / r = 4, chat-format labels);
    ``build_style_db`` over 8 style samples of 2 speakers whose synthetic
    wavs path A's engine featurizes, ``self_verify`` over every row,
    ``search_dialog`` over 4 turns with a +-5-turn labelling context, each
    retrieved row served as ``tts_with_rag --style_db`` serves it
    (``prompt_features_from_store`` then one ``synthesize_batch``); then the
    three CLIs once more through their ``main`` at ``--tiny`` geometry on
    the card."""
    from autostyle_tts_tpu_torch.utils.manifest import StyleSample
    from autostyle_tts_tpu_torch.weights import load_lora

    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ecfg, lcfg = cfg.embedder, cfg.train.lora
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    # the base the adapter was trained over: init_params_quantized(PRNGKey(42), bits=8) (artifacts/ft3b/meta.json)
    params = transformer.init_params_quantized(ecfg, rng.PRNGKey(42, "cuda"), bits=8)
    lora = load_lora(str(ADAPTER), ecfg, lcfg.r, device="cuda")
    emb = rag.EmbedderService(ecfg, params, lora=lora, lora_scale=lcfg.alpha / lcfg.r)
    torch.cuda.synchronize()
    init_s, embedder_gb = time.perf_counter() - t0, (torch.cuda.memory_allocated() - mem0) / 1e9
    check(emb.erc_chat and emb.device.type == "cuda", "path I's embedder: chat-format labels on the card")
    samples = [StyleSample(speaker=spk, zh_text=text, file_id=f"style_{i}") for i, (spk, text) in enumerate(RAG_SAMPLES)]
    turns = [rag.DialogTurn(zh_text=t, speaker=s) for s, t in RAG_DIALOG]
    with tempfile.TemporaryDirectory() as tmp, rag_timings() as (gens, embeds):
        d = Path(tmp)
        for i in range(len(samples)):     # at 22.05 kHz: the loader resamples to the prompt rate
            write_wav(d / f"style_{i}.wav", synthetic_wav(400 + i, 3.0, 22050), 22050)
        t0 = time.perf_counter()
        store = rag.build_style_db(emb, samples, capacity=64, batch=16, engine=eng, wav_dir=str(d))
        build_s = time.perf_counter() - t0
        check(len(store) == len(samples) and store.self_verify(), "path I: self_verify over every row")
        n_build = len(gens), len(embeds)
        searches = []
        search0 = store.search

        def search(q, k=1, speaker=None):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = search0(q, k, speaker)
            searches.append((time.perf_counter() - t1) * 1e3)
            return out

        store.search = search
        turn_labels = []
        labels0 = emb.emotion_labels

        def emotion_labels(texts, contexts=None, names=None):
            out = labels0(texts, contexts, names)
            turn_labels.extend(out)
            return out

        emb.emotion_labels = emotion_labels
        t0 = time.perf_counter()
        rows = rag.search_dialog(emb, store, turns, context_window=5)
        search_s = time.perf_counter() - t0
        del store.search, emb.emotion_labels
    check(len(rows) == len(turns) and all(0 <= r.retrieved_index < len(store) for r in rows),
          f"path I rows {[r.to_dict() for r in rows]}")
    a = store.artifacts
    check(a["speech_tokens"].shape[0] == len(samples) and bool((a["prompt_mel_lens"] > 0).all()),
          "path I's DB artifacts")
    # tts_with_rag --style_db: each speaker's timbre featurized once, the rows' styles from the DB
    timbre = dict(zip(("w1", "m1"), eng.prompt_features([synthetic_wav(410), synthetic_wav(411)])))
    t0 = time.perf_counter()
    wavs = eng.synthesize_batch([r.zh_text for r in rows], [r.retrieved_text for r in rows],
                                [eng.prompt_features_from_store(store, [r.retrieved_index])[0] for r in rows],
                                [timbre[r.speaker] for r in rows], max_seconds=5)
    synth_ms = (time.perf_counter() - t0) * 1e3
    rms = []
    for r, w in zip(rows, wavs):
        check(w.size > 0 and bool(np.isfinite(w).all()), f"path I turn {r.zh_text!r}: wav empty or not finite")
        rms.append(float(np.sqrt(np.mean(w.astype(np.float64) ** 2))))
        check(rms[-1] > 1e-4, f"path I turn {r.zh_text!r}: wav is silent (rms {rms[-1]})")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches_full = read_counts()
    with tempfile.TemporaryDirectory() as tmp:
        cli = rag_clis(Path(tmp))
    launches = read_counts()
    for name in ("flash_attention", "fused_log_mel"):
        check(launches_full[name] > 0, f"path I never launched {name}: {launches_full}")
    bio = [g for g in gens if g["max_new"] == rag.BIO_MAX_NEW]
    lab = [g for g in gens if g["max_new"] == rag.EMOTION_MAX_NEW]
    rec = dict(
        embedder=dict(dim=ecfg.dim, layers=ecfg.n_layers, heads=ecfg.n_heads, kv_heads=ecfg.n_kv_heads,
                      vocab=ecfg.vocab_size, lora_r=lcfg.r, lora_scale=lcfg.alpha / lcfg.r, gb=embedder_gb,
                      init_s=init_s),
        build_s=build_s, search_s=search_s, synth_ms=synth_ms, wav_rms=rms,
        biography=bio, biography_ms_per_token=[g["decode_ms_per_step"] for g in bio],
        labels=lab, embeds=embeds, search_ms=searches,
        build_calls=dict(generate=n_build[0], embed=n_build[1]),
        rows=[dict(speaker=r.speaker, retrieved_index=r.retrieved_index, distance=r.distance) for r in rows],
        emotions=[m["emotion"] for m in store.meta], turn_labels=turn_labels, peak_mem_gb=peak_gb, tiny_clis=cli,
        launches_full_width=launches_full)
    return dict(rag=rec, launches=launches, embedder=emb, store=store)


# ----------------------------------------------------------------------------- path J

# serving_config() as the CLIs' flags (Config() with these overrides)
SERVE_FLAGS = ["--set", "quantize_lm_int8=true", "--set", "quantize_lm_kv_int8=true", "--set", "cfm.n_steps=2",
               "--set", "cfm.use_cfg=false", "--seed", "0"]
NEAR_TIE = 1e-3       # greedy tokens may part only where the standard path's top-2 masked logits lie this close


def serve_lines(argv) -> list:
    """``cli/serve.py``'s ``main`` in-process: its JSON response lines."""
    from autostyle_tts_tpu_torch.cli import serve

    buf = io.StringIO()
    with redirect_stdout(buf):
        serve.main(argv)
    return [json.loads(l) for l in buf.getvalue().splitlines() if l.startswith("{")]


def serve_record(kind: str, lines: list, wall_s: float, served: int, errors: list, rate: int) -> dict:
    """Check a serve run's response lines (ids, every wav on disk finite,
    not silent, at the engine's ``rate``, as many samples as the line says)
    and return its record: latency p50 / p95, requests/s over the run's
    wall."""
    from autostyle_tts_tpu_torch.utils import native_audio

    done = [l for l in lines if "wav" in l and "chunk" not in l]
    check(len(done) == served and [l.get("id") for l in lines if "error" in l] == errors
          and lines[-1] == {"served": served, "done": True}, f"serve {kind}: response lines {lines}")
    rms = []
    for l in done:
        x, sr = read_wav(l["wav"])
        check(sr == rate and x.size == l["samples"] > 0 and bool(np.isfinite(x).all()),
              f"serve {kind} {l['id']}: {x.size} samples at {sr} Hz, line {l}")
        rms.append(float(np.sqrt(np.mean(x.astype(np.float64) ** 2))))
        check(rms[-1] > 1e-4, f"serve {kind} {l['id']}: silent (rms {rms[-1]})")
    lat = [l["latency_ms"] for l in done]
    return dict(kind=kind, served=len(done), errors=errors, wall_s=wall_s, requests_per_s=len(done) / wall_s,
                latency_ms_p50=float(np.percentile(lat, 50)), latency_ms_p95=float(np.percentile(lat, 95)),
                audio_s=sum(l["audio_s"] for l in done), rms_min=min(rms),
                loader="native" if native_audio.available() else "numpy")


def serve_paths(d: Path, store: StyleStore) -> dict:
    """J1-J3: ``serve`` at the flagship serving point (``SERVE_FLAGS``) on
    a JSONL of 8 requests (4 DB rows of path A's store, 2 wav pairs, one
    registered timbre, one bad path): batched (``--batch 8``), then the 7
    good ones through ``--continuous`` (slots 4, chunk 16, p_max 384) and 4
    of them through ``--continuous --stream``. The engine ``serve`` builds
    in J1 (timed apart) serves J2 and J3 as well."""
    from autostyle_tts_tpu_torch.cli import serve
    from autostyle_tts_tpu_torch.utils import native_audio

    store.save(d / "db")
    for name, seed in (("style", 500), ("timbre", 501), ("style2", 502)):
        write_wav(d / f"{name}.wav", synthetic_wav(seed), 16000)
    wav = lambda name: str(d / f"{name}.wav")
    reqs = [{"id": f"db{i}", "text": TEXTS[i], "style_text": store.meta[i]["text"], "style_index": i,
             "timbre_wav": wav("timbre")} for i in range(4)]
    reqs += [{"id": "wav0", "text": BATCH_TEXTS[4], "style_text": "A calm reading voice.", "style_wav": wav("style"),
              "timbre_wav": wav("timbre")},
             {"id": "wav1", "text": BATCH_TEXTS[5], "style_wav": wav("style2"), "timbre_wav": wav("style")},
             {"id": "reg0", "text": BATCH_TEXTS[6], "style_text": "A calm reading voice.", "style_wav": wav("style"),
              "timbre_id": "w1"},
             {"id": "bad", "text": BATCH_TEXTS[7], "style_wav": str(d / "missing.wav"), "timbre_wav": wav("timbre")}]
    (d / "all.jsonl").write_text("".join(json.dumps(r) + "\n" for r in reqs))
    (d / "good.jsonl").write_text("".join(json.dumps(r) + "\n" for r in reqs[:7]))
    (d / "four.jsonl").write_text("".join(json.dumps(r) + "\n" for r in reqs[2:6]))
    common = ["--style_db", str(d / "db"), "--timbre_map", f"w1={wav('timbre')}", "--max_seconds", "5"] + SERVE_FLAGS
    built, build0 = {}, serve.build_engine

    def build(args):
        t0 = time.perf_counter()
        built["engine"] = build0(args)
        torch.cuda.synchronize()
        built["s"] = time.perf_counter() - t0
        return built["engine"]

    out, loads, load0 = {}, [], serve.load_wav_fast

    def timed_load(path, sr):
        t0 = time.perf_counter()
        try:
            return load0(path, sr)
        finally:
            loads.append((time.perf_counter() - t0) * 1e3)

    n_mel0, n_flash0 = log_mel.fused_log_mel.launches, flash_attn.flash_attention.launches
    serve.build_engine, serve.load_wav_fast = build, timed_load
    try:
        t0 = time.perf_counter()
        lines = serve_lines(["--requests", str(d / "all.jsonl"), "--result_dir", str(d / "batched"),
                             "--batch", "8"] + common)
        rate = built["engine"].cfg.audio.sample_rate
        out["batched"] = serve_record("batched", lines, time.perf_counter() - t0 - built["s"], 7, ["bad"], rate)
        out["batched"].update(loader_calls=len(loads), loader_ms=sum(loads))
        serve.load_wav_fast = load0
        check(built["engine"]._mega_params is not None and built["engine"].device.type == "cuda",
              "serve's engine: the flagship int8 LM on the card")
        check(native_audio.available(), "the native audio loader is not live on the card's machine")
        check(log_mel.fused_log_mel.launches > n_mel0 and flash_attn.flash_attention.launches > n_flash0,
              "serve --batch 8 launched no log-mel or no flash kernel")
        serve.build_engine = lambda args: built["engine"]
        for kind, extra, src, n in (("continuous", ["--continuous", "--slots", "4", "--chunk", "16"], "good", 7),
                                    ("stream", ["--continuous", "--stream", "--slots", "4"], "four", 4)):
            t0 = time.perf_counter()
            lines = serve_lines(["--requests", str(d / f"{src}.jsonl"), "--result_dir", str(d / kind),
                                 "--p_max", "384"] + extra + common)
            out[kind] = serve_record(kind, lines, time.perf_counter() - t0, n, [], rate)
            if kind == "stream":
                finals = {l["id"]: l for l in lines if "chunks" in l}
                firsts = {l["id"]: l["ttfb_ms"] for l in lines if l.get("chunk") == 0}
                for rid, f in finals.items():
                    n_chunks = [l for l in lines if l.get("id") == rid and "chunk" in l]
                    check(len(n_chunks) == f["chunks"] and sum(c["samples"] for c in n_chunks) == f["samples"],
                          f"serve stream {rid}: chunks {n_chunks} against {f}")
                out[kind]["ttfb_ms"] = firsts
                out[kind]["chunks"] = {rid: f["chunks"] for rid, f in finals.items()}
    finally:
        serve.build_engine, serve.load_wav_fast = build0, load0
    out["engine_build_s"] = built["s"]
    out["loaders"] = wav_loaders(d, built["engine"])
    return out


def wav_loaders(d: Path, eng: Engine) -> dict:
    """The native wav loader (``utils/native_audio.load_wav_fast``) against
    the numpy one (``utils/audio_io.load_wav``) on the card's host, each
    output equal to the other's within 1e-6
    (``tests/test_torch_native_audio.py``'s bound):

    - per wav, loaded at the engine's prompt rate: a 3-s prompt
      (``synthetic_wav``) written at 16 kHz (J1's prompts: decode only) and
      at 22.05, 24, 44.1 and 48 kHz (decode and resample), and 30 s at 48
      kHz; the median ms of 7 calls after a warm one; also the two
      decodes alone (``read_wav_native`` against ``audio_io.read_wav``:
      ``load_wav_fast`` takes numpy's);
    - end to end, the entry point that loads the most audio per unit of
      device work: ``simeval.score_meta_lst`` (``score_similarity``) on 64
      rows of 5-s wavs at the engine's output rate and 2 timbre wavs, run
      native, numpy, numpy, native after a warm run (the similarities
      equal within 1e-5)."""
    from autostyle_tts_tpu_torch.pipeline import simeval
    from autostyle_tts_tpu_torch.utils import audio_io, native_audio

    check(native_audio.available(), "the native audio loader is not live on the card's machine")
    target_sr, out_sr = eng.cfg.audio.prompt_sample_rate, eng.cfg.audio.sample_rate
    rows = []
    for sr, seconds in ((16000, 3.0), (22050, 3.0), (24000, 3.0), (44100, 3.0), (48000, 3.0), (48000, 30.0)):
        path = str(d / f"loader_{sr}_{int(seconds)}s.wav")
        write_wav(path, synthetic_wav(560, seconds, sr), sr)
        a, b = native_audio.load_wav_fast(path, target_sr), audio_io.load_wav(path, target_sr)
        err = float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
        check(err <= 1e-6, f"wav loaders at {sr} Hz: shapes {a.shape} / {b.shape}, max |native - numpy| {err}")
        ms = {}
        for name, load in (("native", lambda: native_audio.load_wav_fast(path, target_sr)),
                           ("numpy", lambda: audio_io.load_wav(path, target_sr)),
                           ("decode_native", lambda: native_audio.read_wav_native(path)),
                           ("decode_numpy", lambda: audio_io.read_wav(path))):
            times = []
            for _ in range(7):
                t0 = time.perf_counter()
                load()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[name] = float(np.median(times))
        rows.append(dict(sr=sr, seconds=seconds, native_ms=ms["native"], numpy_ms=ms["numpy"],
                         numpy_over_native=ms["numpy"] / ms["native"], decode_native_ms=ms["decode_native"],
                         decode_numpy_ms=ms["decode_numpy"], max_abs_err=err))
    sim = d / "similarity"
    sim.mkdir()
    for k in range(2):
        write_wav(sim / f"timbre{k}.wav", synthetic_wav(570 + k), 16000)
    lines = []
    for i in range(64):
        write_wav(sim / f"row{i}.wav", synthetic_wav(600 + i, 5.0, out_sr), out_sr)
        lines.append(f"row{i}|style|{sim / f'timbre{i % 2}.wav'}|text\n")
    (sim / "meta.lst").write_text("".join(lines))
    fast = simeval.load_wav_fast
    walls, sims = {"native": [], "numpy": []}, {}
    try:
        for name in ("native", "native", "numpy", "numpy", "native"):
            simeval.load_wav_fast = fast if name == "native" else audio_io.load_wav
            t0 = time.perf_counter()
            report = simeval.score_meta_lst(eng, sim / "meta.lst", sim)
            walls[name].append((time.perf_counter() - t0) * 1e3)
            sims.setdefault(name, np.array([r["similarity"] for r in report["rows"]]))
    finally:
        simeval.load_wav_fast = fast
    gap = float(np.abs(sims["native"] - sims["numpy"]).max())
    check(report["summary"]["n"] == 64 and gap <= 1e-5, f"score_meta_lst: native against numpy loader {gap}")
    native_ms, numpy_ms = walls["native"][1:], walls["numpy"]
    return dict(target_sr=target_sr, rows=rows, score_meta_lst=dict(
        rows=64, seconds_each=5.0, sr=out_sr, native_ms=native_ms, numpy_ms=numpy_ms,
        numpy_over_native=float(np.mean(numpy_ms) / np.mean(native_ms)), max_similarity_gap=gap))


def engine_clis(d: Path) -> dict:
    """J3b: every engine CLI once through its ``main`` at ``--tiny`` on the
    card (the flagship's work is paths A-I's): each output's file count and
    rate checked; ``vc_from_dir --cal_sim`` and ``score_similarity`` on its
    ``meta.lst``; ``export_engine`` out, then back in through ``basic
    --checkpoint`` with every weight equal to the file's."""
    from autostyle_tts_tpu_torch.cli import (basic, export_engine, score_similarity, tts_for_dialog,
                                             tts_from_lines, tts_with_style_and_timbre, vc_from_dir,
                                             vc_from_dir_seed)
    from autostyle_tts_tpu_torch.cli.common import add_common_args, build_engine
    from autostyle_tts_tpu_torch.utils.config import tiny_config

    sr = tiny_config().audio.prompt_sample_rate
    for sub in ("styles", "timbres", "swav"):
        (d / sub).mkdir()
    for i in range(2):
        write_wav(d / "styles" / f"sty{i}.wav", synthetic_wav(510 + i, 1.0, sr), sr)
        write_wav(d / "timbres" / f"tim{i}.wav", synthetic_wav(520 + i, 1.0, sr), sr)
    write_wav(d / "swav" / "s1.wav", synthetic_wav(530, 1.0, sr), sr)
    style, timbre = str(d / "styles" / "sty0.wav"), str(d / "timbres" / "tim0.wav")
    (d / "lines.txt").write_text(f"{TEXTS[0]}\n{TEXTS[1]}\n")
    (d / "style.json").write_text(json.dumps([{"file_id": f"denoise_sty{i}", "zh_text": f"style {i}"} for i in (0, 1)]))
    seed_wav = d / "timbres-wavs-x.wav"
    write_wav(d / "timbres_temp-x_16k.wav", synthetic_wav(540, 1.0, sr), sr)   # what the rewrite rules point at
    (d / "seed_meta.lst").write_text(f"x|seed text|{seed_wav}|target text\n")
    (d / "dialog.jsonl").write_text("".join(json.dumps({"zh_text": t}) + "\n" for t in TEXTS[:2]))
    (d / "styledb.jsonl").write_text(json.dumps({"file_id": "s1", "zh_text": "style one"}) + "\n")
    (d / "correspond.json").write_text(json.dumps({"1": {"value": 1, "speaker": "w1", "emotion": "happy"},
                                                   "2": "null"}))
    runs = [
        ("basic", basic, ["--prompt_wav", style, "--result_dir", str(d / "basic")], "basic/*.wav", 1),
        ("tts_from_lines", tts_from_lines, ["--txt_path", str(d / "lines.txt"), "--prompt_wav", style,
                                           "--prompt_text", "p", "--result_dir", str(d / "lines")], "lines/*.wav", 2),
        ("style_timbre_infer", tts_with_style_and_timbre,
         ["--style_wav_path", style, "--timbre_wav_path", timbre, "--style_wav_text", "style 0", "--txt_path",
          str(d / "lines.txt"), "--result_dir", str(d / "st")], "st/*_st_0.wav", 2),
        ("style_timbre_exp", tts_with_style_and_timbre,
         ["--style_wav_path", style, "--timbre_wav_path", timbre, "--style_wav_text", "style 0", "--txt_path",
          str(d / "lines.txt"), "--result_dir", str(d / "exp"), "--is_exp", "true"], "exp/*_exp_0_0.wav", 2),
        ("tts_for_dialog", tts_for_dialog,
         ["--corresponding_json", str(d / "correspond.json"), "--dialogue_json", str(d / "dialog.jsonl"),
          "--style_wav_json", str(d / "styledb.jsonl"), "--style_wav_dir", str(d / "swav"), "--result_dir",
          str(d / "dialog"), "--timbre_map", f"w1={timbre}"], "dialog/*/1_s1_to_w1_0.wav", 1),
        ("vc_from_dir", vc_from_dir,
         ["--txt_path", str(d / "lines.txt"), "--style_dir", str(d / "styles"), "--timbre_dir", str(d / "timbres"),
          "--result_dir", str(d / "vc"), "--style_num", "2", "--timbre_num", "1", "--style_json",
          str(d / "style.json"), "--cal_sim"], "vc/*_new.wav", 4),
        ("score_similarity", score_similarity,
         ["--meta_lst", str(d / "vc" / "meta.lst"), "--wav_dir", str(d / "vc"), "--output_json",
          str(d / "similarity.json")], None, 0),
        ("vc_from_dir_seed", vc_from_dir_seed,
         ["--txt_path", str(d / "lines.txt"), "--style_dir", str(d / "styles"), "--result_dir", str(d / "seed"),
          "--style_num", "1", "--timbre_num", "1", "--style_json", str(d / "style.json"), "--seed_meta_lst",
          str(d / "seed_meta.lst")], "seed/*_new.wav", 2),
        ("export_engine", export_engine, ["--output", str(d / "engine.npz"), "--seed", "7"], None, 0),
        ("basic_from_export", basic, ["--prompt_wav", style, "--result_dir", str(d / "basic_ckpt"),
                                      "--checkpoint", str(d / "engine.npz")], "basic_ckpt/*.wav", 1),
    ]
    rec = {}
    for name, mod, argv, pattern, n in runs:
        t0 = time.perf_counter()
        with redirect_stdout(io.StringIO()):
            mod.main(["--tiny"] + argv)
        rec[name] = dict(s=time.perf_counter() - t0)
        if pattern:
            wavs = sorted(d.glob(pattern))
            check(len(wavs) == n, f"{name} wrote {[w.name for w in wavs]}, expected {n} wavs")
            for w in wavs:
                x, rate = read_wav(w)
                check(rate == 2400 and x.size > 0 and bool(np.isfinite(x).all()),
                      f"{name} {w.name}: {x.size} samples at {rate} Hz")
            rec[name]["wavs"] = len(wavs)
    rows = (d / "vc" / "meta.lst").read_text().splitlines()
    for report in (d / "vc" / "similarity.json", d / "similarity.json"):
        r = json.loads(report.read_text())
        check(r["summary"]["n"] == len(rows) == 4 and all(np.isfinite(x["similarity"]) for x in r["rows"]),
              f"{report.name}: {r['summary']} over {len(rows)} meta.lst rows")
    rec["score_similarity"]["summary"] = r["summary"]
    p = argparse.ArgumentParser()
    add_common_args(p)
    eng = build_engine(p.parse_args(["--tiny", "--checkpoint", str(d / "engine.npz")]))
    like = EngineParams.init(torch.Generator(device=eng.device).manual_seed(0), eng.cfg).tree()
    saved = load_tree(str(d / "engine.npz"), like)
    want, got = _flat_keys(saved), _flat_keys(eng.params.tree())
    check(got.keys() == want.keys() and all(torch.equal(v.float(), want[k].to(v.dtype).float()) for k, v in got.items()),
          "export_engine -> --checkpoint: the weights differ from the file's")
    rec["export_round_trip_leaves"] = len(got)
    return rec


def spec_decode(eng: Engine, text: str, style_text: str, sty, tim, clock: Stopwatch, max_seconds: float = 5):
    """The engine's speculative decode of one B=1 request, called directly
    (the engine itself serves such a request on the decode kernel where
    that kernel serves its LM): ``generate_speech_spec_from_ids`` on the
    engine's LM inputs, sampler, gamma and KV cache, the prefill under
    ``clock``'s "prefill" span and the verify loop under "decode"."""
    ids, max_new = eng._lm_inputs([text], [style_text], [sty], max_seconds)
    spk = eng._tensor(tim.spk[None], torch.float32)
    spec = token_lm.generate_speech_spec_from_ids(
        eng.params.token_lm, eng.cfg.token_lm, *ids, spk, eng._lm_generator(), max_new_tokens=max_new,
        gamma=eng.cfg.speculative_gamma, kv_int8=eng.cfg.quantize_lm_kv_int8,
        sampler=SamplerConfig(temperature=1.0, top_k=25), clock=clock)
    n = int(spec.lengths[0])
    check(spec.n_commit == n > 0 and spec.n_verify > 0 and spec.tokens.shape == (1, max_new),
          f"speculative decode: {spec.n_verify} verifies, {spec.n_commit} commits, length {n}")
    return spec


def speculative_flagship(store: StyleStore, cfg: Config) -> dict:
    """J4: A's engine config with ``speculative_gamma=4`` (same seed, same
    weights). The decode kernel serves the flagship LM, so the engine
    ignores gamma: its 2 DB-served B=1 requests must launch the decode-step
    kernel and leave ``last_spec`` empty. The speculative decode is then
    driven on each request's LM inputs (``spec_decode``; flash prefill, the
    verify loop, no decode-step launch) beside the kernel path's prefill
    and decode of the same request. The speculative engine is returned for
    a profile outside the path's counts."""
    spec_eng, init_s, _ = engine_on_card(dataclasses.replace(cfg, speculative_gamma=4))
    reqs = []
    for i, (a, b) in enumerate(((0, 1), (2, 3))):
        sty, tim = spec_eng.prompt_features_from_store(store, [a, b])
        n_mega = decode_step.mega_decode_step.launches
        kernel = run_request(spec_eng, cfg, "gamma 4, kernel path", lambda: spec_eng.inference_tts_with_st(
            TEXTS[i], store.meta[a]["text"], sty, tim, max_seconds=5))
        check(decode_step.mega_decode_step.launches > n_mega and spec_eng.last_spec is None,
              "speculative_gamma=4 on the flagship int8 LM: the request did not take the decode kernel")
        n_mega, n_flash = decode_step.mega_decode_step.launches, flash_attn.flash_attention.launches
        clock = Stopwatch(spec_eng.device)
        spec = spec_decode(spec_eng, TEXTS[i], store.meta[a]["text"], sty, tim, clock)
        check(decode_step.mega_decode_step.launches == n_mega and flash_attn.flash_attention.launches > n_flash,
              "the speculative decode launched the decode-step kernel, or its prefill no flash kernel")
        reqs.append(dict(n_verify=spec.n_verify, n_commit=spec.n_commit,
                         verify_ms=clock.ms["decode"] / spec.n_verify,
                         commits_per_verify=spec.n_commit / spec.n_verify,
                         spec_ms_per_token=clock.ms["decode"] / spec.n_commit,
                         spec_lm_ms=clock.ms["prefill"] + clock.ms["decode"], spec_prefill_ms=clock.ms["prefill"],
                         kernel_lm_ms=kernel["prefill_ms"] + kernel["decode_ms"], kernel_wall_ms=kernel["wall_ms"],
                         kernel_ms_per_token=kernel["decode_ms"] / max(kernel["gen_len"], 1),
                         kernel_gen_len=kernel["gen_len"]))
    return dict(init_s=init_s, requests=reqs), spec_eng


def speculative_demo() -> dict:
    """J5: the trained demo engine's LM (``demo_engine.npz``) on its 3
    held-out rows, greedy, ``min_tokens=128`` (EOS masked throughout),
    gamma 4, beside the standard greedy decode (the scanned decode: the
    demo LM is dense): the tokens equal but where the standard path's top-2
    masked logits lie within ``NEAR_TIE``, commits per verify above 1.5
    (the reference's threshold), ms a token of each."""
    dcfg = demo_config()
    eng = Engine(dcfg, params=EngineParams.from_tree(from_jax_tree(load_npz(FIXTURES / "demo_engine.npz"), dcfg)),
                 seed=0)
    tl, tp = dcfg.token_lm, eng.params.token_lm
    rows = json.loads((FIXTURES / "demo_corpus_sample" / "manifest.json").read_text())
    out = []
    for row in rows[:3]:
        wav, _ = read_wav(FIXTURES / "demo_corpus_sample" / row["wav"])
        feat = eng.prompt_features([wav])[0]
        ids = frontend.encode(row["text"], tokenizer=eng.text_tokenizer)
        n_s = min(len(feat.tokens), 64)
        sty = np.zeros((1, 64), np.int32)
        sty[0, :n_s] = feat.tokens[:n_s]
        inputs = [eng._tensor(x, torch.int32) for x in (np.asarray(ids)[None], [len(ids)], sty, [n_s])]
        spk = eng._tensor(feat.spk[None], torch.float32)
        spec_clock, std_clock = Stopwatch(eng.device), Stopwatch(eng.device)
        spec = token_lm.generate_speech_spec_from_ids(tp, tl, *inputs, spk, max_new_tokens=128, gamma=4,
                                                      min_tokens=128, clock=spec_clock)
        tops, sample0 = [], token_lm.sample

        def record(logits, sampler, generator=None):
            tops.append(torch.topk(logits[0].float(), 2).values)
            return sample0(logits, sampler, generator)

        token_lm.sample = record
        try:
            std = token_lm.generate_speech_from_ids(tp, tl, *inputs, spk, None, max_new_tokens=128,
                                                    sampler=SamplerConfig(greedy=True), min_tokens=128,
                                                    clock=std_clock)
        finally:
            token_lm.sample = sample0
        got, want = spec.tokens[0].tolist(), std.tokens[0].tolist()
        diff = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y), None)
        gap = None if diff is None else float(tops[diff][0] - tops[diff][1])
        check(diff is None or gap < NEAR_TIE,
              f"J5 {row['wav']}: speculative tokens part from the greedy decode at {diff} (top-2 gap {gap})")
        out.append(dict(wav=row["wav"], n_verify=spec.n_verify, n_commit=spec.n_commit,
                        commits_per_verify=spec.n_commit / spec.n_verify, first_difference=diff, near_tie_gap=gap,
                        spec_ms_per_token=spec_clock.ms["decode"] / spec.n_commit,
                        verify_ms=spec_clock.ms["decode"] / spec.n_verify,
                        standard_ms_per_token=std_clock.ms["decode"] / max(std.decode_steps, 1),
                        standard_steps=std.decode_steps))
    mean = float(np.mean([r["commits_per_verify"] for r in out]))
    check(mean > 1.5, f"J5: commits per verify {mean} <= 1.5")
    return dict(rows=out, mean_commits_per_verify=mean, limit=1.5)


def path_j(eng: Engine, store: StyleStore, cfg: Config) -> dict:
    """The serving surface: ``serve`` batched, continuous and streamed
    (J1-J3), every engine CLI at ``--tiny`` (J3b), speculative decoding at
    the flagship (J4) and on the trained demo engine (J5)."""
    reset_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        (d / "serve").mkdir()
        (d / "clis").mkdir()
        srv = serve_paths(d / "serve", store)
        for kind in ("batched", "continuous", "stream"):
            print(f"serve {kind}", json.dumps(srv[kind]), flush=True)
        print("wav loader", json.dumps(srv["loaders"]), flush=True)
        clis = engine_clis(d / "clis")
    print("engine clis", json.dumps(clis), flush=True)
    spec, spec_eng = speculative_flagship(store, cfg)
    print("speculative flagship", json.dumps(spec), flush=True)
    demo = speculative_demo()
    print("speculative demo", json.dumps(demo), flush=True)
    launches = read_counts()
    for name in ("flash_attention", "fused_log_mel"):
        check(launches[name] > 0, f"path J never launched {name}: {launches}")
    return dict(serve=srv, clis=clis, speculative=spec, demo=demo, launches=launches, wall_s=time.perf_counter() - t0,
                spec_engine=spec_eng)


# ----------------------------------------------------------------------------- path K

# CosyVoice-300M's published widths (FunAudioLLM/CosyVoice,
# pretrained_models/CosyVoice-300M/cosyvoice.yaml) in SynthGeometry's terms.
# Not expressible there (PERF.md §4): one n_heads (16) and one FFN width
# (4096) for every wenet stack (the flow encoder's are 8 and 2048); the text
# encoder built macaron + conv; the source resblocks' kernels (7, 7) for
# (7, 11); the tokenizer at the flow's width (512) with 2 blocks.
COSYVOICE_300M = SynthGeometry(
    text_vocab=51866, text_in=512, text_dim=1024, n_text_layers=6, llm_dim=1024, n_llm_layers=14, n_heads=16,
    ffn=4096, speech_vocab=4096, spk_dim=192, flow_emb=512, flow_dim=512, n_flow_layers=6, n_mels=80,
    est_channels=(256, 256), n_tf=4, n_mid=12, hift_channels=512, up_rates=(8, 8), resblock_kernels=(3, 7, 11),
    n_res_convs=3, istft_n_fft=16, nb_harmonics=8, n_positions=1500, s3_mels=128)
COSY_HEADS_EST, COSY_STEPS = 8, 10            # the estimator's heads and Euler steps (n_timesteps)
COSY_PROMPT_TOKENS, COSY_MAX_NEW = 150, 128   # a 3 s prompt at 50 Hz; new tokens a request
COSY_RULE_ARTIFACTS = ("llm.pt", "flow.pt", "hift.pt", "speech_tokenizer_v1.onnx")
COSY_NEAR_TIE = 1e-3    # f32 logits of the cached decode and of one causal pass: a top-2 gap below it may part them


def compat_convert(d: Path, geo: SynthGeometry) -> dict:
    """K1: a synthetic release at ``geo`` in the upstream key names (drawn
    at fan-in scale: at 0.3, the tiny geometry's scale, the 1024-wide
    trunk's attention saturates and its greedy decode parts from one
    causal pass at large logit gaps; PERF.md) ->
    ``convert_cosyvoice --strict --output`` through its ``main`` (the
    snapshot load-checked on the card) -> coverage and times."""
    from autostyle_tts_tpu_torch.cli import convert_cosyvoice

    t0 = time.perf_counter()
    torch.manual_seed(0)     # the weight-norm gains draw from the global stream
    release = build_release_dir(d / "release", geo, seed=0, scale="fan_in")
    write_s = time.perf_counter() - t0
    snap, report = d / "snapshot.npz", d / "report.json"
    t0 = time.perf_counter()
    convert_cosyvoice.main(["--model_dir", str(release), "--strict", "--report_json", str(report),
                            "--output", str(snap)])
    convert_s = time.perf_counter() - t0
    rep = json.loads(report.read_text())
    coverage = {a: dict(mapped=len(rep[a]["mapped"]), unmapped=len(rep[a]["unmapped_src"]),
                        unfilled=len(rep[a]["unfilled_dst"])) for a in COSY_RULE_ARTIFACTS}
    check(all(c["mapped"] > 0 and c["unmapped"] == 0 and c["unfilled"] == 0 for c in coverage.values()),
          f"path K conversion coverage {coverage}")
    camp = rep["campplus.onnx"]
    check(camp["mode"] == "graph-executed" and camp["unsupported_ops"] == [], f"path K campplus {camp}")
    coverage["campplus.onnx"] = dict(mode=camp["mode"], nodes=sum(camp["ops"].values()),
                                     unsupported=len(camp["unsupported_ops"]))
    return dict(snapshot=snap, coverage=coverage, write_s=write_s, convert_s=convert_s,
                release_mb=sum(p.stat().st_size for p in release.iterdir()) / 1e6,
                snapshot_mb=snap.stat().st_size / 1e6)


def greedy_vs_full_pass(eng, text, prompt, spk, n_new: int = 32) -> dict:
    """The greedy KV-cache decode against one causal pass of the trunk
    over [prefix | its tokens] (``prefill`` over the whole sequence, which,
    like the decode, leaves out the trunk's after_norm): each token is the
    pass's argmax at its position but at a top-2 near-tie (COSY_NEAR_TIE),
    where the comparison ends."""
    from autostyle_tts_tpu_torch.models.compat import cosy_llm, wenet_conformer

    dev = eng.device
    args = (torch.tensor([text], dtype=torch.int32, device=dev), torch.tensor([len(text)], device=dev),
            torch.tensor([prompt], dtype=torch.int32, device=dev), torch.tensor([len(prompt)], device=dev),
            torch.as_tensor(np.asarray(spk, np.float32)[None]).to(dev))
    gen = cosy_llm.generate(eng.llm, eng.llm_cfg, *args, max_new_tokens=n_new, sampler=SamplerConfig(greedy=True))
    n = int(gen.lengths[0])
    toks = gen.tokens[0, :n].long()
    with torch.no_grad():
        emb, _, lens = cosy_llm.build_prefix(eng.llm, eng.llm_cfg, *args)
        full = torch.cat([emb[:, : int(lens[0])], eng.llm["speech_embedding"][toks][None]], 1)
        h, _ = wenet_conformer.prefill(eng.llm["llm"], eng.llm_cfg.llm, full,
                                       torch.ones(full.shape[:2], device=dev), full.shape[1])
        logits = h[0] @ eng.llm["llm_decoder"]["w"] + eng.llm["llm_decoder"]["b"]
    start = int(lens[0]) - 1
    equal, tie_at, min_gap = 0, None, float("inf")
    for i in range(n):
        row = logits[start + i]
        top2 = torch.topk(row, 2).values
        gap = float(top2[0] - top2[1])
        min_gap = min(min_gap, gap)
        if int(torch.argmax(row)) != int(toks[i]):
            check(gap < COSY_NEAR_TIE, f"path K greedy token {i} ({int(toks[i])}) is not the causal pass's "
                  f"argmax ({int(torch.argmax(row))}) at top-2 gap {gap}")
            tie_at = i
            break
        equal += 1
    check(n > 0 and equal >= min(n, 8), f"path K greedy decode: {equal} of {n} tokens compared")
    return dict(n_tokens=n, equal=equal, near_tie_at=tie_at, min_top2_gap=min_gap)


def s3_tokens_kernel_vs_plain(eng, wav16: np.ndarray) -> dict:
    """The speech tokens of one 16 kHz wav from the kernel's log-mel (128
    mels) and from the plain version's, on the same strided frames: equal
    wherever the plain mel's two nearest codebook rows differ by more than
    VQ_MARGIN in squared distance."""
    from autostyle_tts_tpu_torch.models.compat import s3_tokenizer

    dev = eng.device
    x = stft._reflect_pad(torch.from_numpy(wav16).to(dev)[None], 200)
    frames = stft.frame_signal(x.contiguous(), 400, 160)
    cos_b, sin_b = stft._dft_basis_on(dev, 400, 400)
    fb = stft._mel_filterbank_on(dev, 16000, 400, eng.s3_cfg.n_mels, 0.0, 8000.0)
    mask = torch.ones((1, frames.shape[1]), device=dev)
    mels = {"kernel": log_mel.fused_log_mel(frames, cos_b, sin_b, fb),
            "plain": log_mel.fused_log_mel_plain(frames, cos_b, sin_b, fb)}
    d2 = {k: s3_tokenizer.vq_distances(eng.s3["codebook"], s3_tokenizer.encode_hidden(eng.s3, eng.s3_cfg, m, mask)[0])
          for k, m in mels.items()}
    tok = {k: torch.argmin(d, dim=-1) for k, d in d2.items()}
    near2 = torch.topk(d2["plain"], 2, dim=-1, largest=False).values
    decisive = (near2[..., 1] - near2[..., 0]) > VQ_MARGIN
    n_dec, n_all = int(decisive.sum()), decisive.numel()
    check(n_dec >= 0.9 * n_all, f"path K speech tokens: only {n_dec} of {n_all} are decisive")
    check(torch.equal(tok["kernel"][decisive], tok["plain"][decisive]),
          "path K: speech tokens from the kernel's 128-mel log-mel differ from the plain version's")
    return dict(tokens=n_all, compared=n_dec, equal_all=int((tok["kernel"] == tok["plain"]).sum()),
                mel_err=float((mels["kernel"] - mels["plain"]).abs().max()))


def compat_request(eng, kind: str, call, n_prompt: int) -> dict:
    """One B=1 request: finite 22,050 Hz audio of gen_len x 512 samples."""
    t0 = time.perf_counter()
    wav = next(call())["tts_speech"]
    wall_ms = (time.perf_counter() - t0) * 1e3
    n = eng.last_gen_len
    spf = eng.hift_cfg.samples_per_frame * eng.flow_cfg.token_mel_ratio
    check(eng.hift_cfg.sampling_rate == 22050, f"path K: HiFT at {eng.hift_cfg.sampling_rate} Hz")
    check(wav.shape == (1, n * spf) and n > 0 and bool(np.isfinite(wav).all()),
          f"path K {kind}: wav {wav.shape} for {n} tokens x {spf}, or not finite")
    tm = eng.last_timings
    rms = float(np.sqrt(np.mean(wav.astype(np.float64) ** 2)))
    check(rms > 1e-4, f"path K {kind}: wav is silent (rms {rms})")
    return dict(kind=kind, prompt_tokens=n_prompt, gen_len=n, audio_s=wav.shape[1] / 22050, rms=rms, wall_ms=wall_ms,
                llm_ms=tm["llm"], llm_ms_per_token=tm["llm"] / n, flow_ms=tm["flow"], hift_ms=tm["hift"])


def compat_serve(snapshot: Path, geo: SynthGeometry) -> dict:
    """K2: the converted release on the card (``CosyEngine``, the
    published estimator heads and steps), B=1 requests through both entry
    points from pre-tokenized prompts and from 3 s 16 kHz wavs (the
    tokenizer's log-mel through the kernel, the x-vector through the
    campplus graph)."""
    from autostyle_tts_tpu_torch.models.compat import CosyEngine

    t0 = time.perf_counter()
    eng = CosyEngine.load(snapshot, n_heads_est=COSY_HEADS_EST, n_steps=COSY_STEPS, seed=0)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(eng.device.type == "cuda" and eng.s3 is not None and eng.campplus is not None, "path K engine")
    check(eng.llm_cfg.speech_vocab == geo.speech_vocab and eng.llm_cfg.llm.n_layers == geo.n_llm_layers
          and eng.s3_cfg.n_mels == geo.s3_mels, f"path K geometry {eng.llm_cfg} {eng.s3_cfg}")
    rng = np.random.default_rng(9)
    texts = [rng.integers(0, geo.text_vocab, 40).astype(np.int32) for _ in range(2)]
    prompt = rng.integers(0, geo.speech_vocab, COSY_PROMPT_TOKENS).astype(np.int32)
    style = rng.integers(0, geo.speech_vocab, COSY_PROMPT_TOKENS).astype(np.int32)
    mel = (rng.standard_normal((2 * COSY_PROMPT_TOKENS, geo.n_mels)) * 0.5 - 5.0).astype(np.float32)
    spk = rng.standard_normal(geo.spk_dim).astype(np.float32)
    reqs = [compat_request(eng, "zero_shot", lambda: eng.inference_zero_shot(
                texts[0], prompt, mel, spk, max_new=COSY_MAX_NEW), len(prompt)),
            compat_request(eng, "tts_with_st", lambda: eng.inference_tts_with_st(
                texts[1], style, prompt, mel, spk, max_new=COSY_MAX_NEW), len(prompt))]
    wav_reqs, featurize = [], []
    for i, seed in enumerate((510, 511)):
        w16 = synthetic_wav(seed)
        toks = eng.tokenize_wav16(w16)
        xvec = eng.embed_speaker_wav16(w16)
        check(len(toks) == 1 + len(w16) // 320 and int(toks.max()) < geo.speech_vocab,
              f"path K wav prompt tokens {len(toks)}")
        check(xvec.shape == (geo.spk_dim,) and bool(np.isfinite(xvec).all()), "path K x-vector")
        featurize.append(dict(tokenize_ms=eng.last_timings["tokenize"], xvector_ms=eng.last_timings["xvector"],
                              tokens=len(toks)))
        # the flow's prompt mel comes with a prompt (CosyEngine takes it precomputed): zeros here
        zeros = np.zeros((2 * len(toks), geo.n_mels), np.float32)
        call = ((lambda: eng.inference_zero_shot(texts[0], toks, zeros, xvec, max_new=COSY_MAX_NEW)) if i == 0 else
                (lambda: eng.inference_tts_with_st(texts[1], toks, toks, zeros, xvec, max_new=COSY_MAX_NEW)))
        wav_reqs.append(compat_request(eng, "wav_" + ("zero_shot" if i == 0 else "tts_with_st"), call, len(toks)))
    greedy = greedy_vs_full_pass(eng, texts[0].tolist(), prompt.tolist(), spk)
    n0 = log_mel.fused_log_mel.launches
    tokens_kp = s3_tokens_kernel_vs_plain(eng, synthetic_wav(510))
    log_mel.fused_log_mel.launches = n0      # a comparison with the plain version is not the path's launch
    return dict(load_s=load_s, requests=reqs + wav_reqs, featurize=featurize, greedy=greedy,
                s3_kernel_vs_plain=tokens_kp,
                gpu_gb=torch.cuda.memory_allocated() / 1e9)


def hf_state_dict(ecfg, gen, dtype=torch.bfloat16) -> dict:
    """A Llama-architecture state dict in Hugging Face key names at
    ``ecfg``'s widths, drawn on ``gen``'s device (std 0.02, norms at one,
    embeddings tied as Llama-3.2-3B's)."""
    D, F, hd = ecfg.dim, ecfg.ffn_dim, ecfg.head_dim
    dev = gen.device

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

    sd = {"model.embed_tokens.weight": w(ecfg.vocab_size, D),
          "model.norm.weight": torch.ones(D, device=dev, dtype=dtype)}
    for i in range(ecfg.n_layers):
        p = f"model.layers.{i}."
        sd.update({p + "self_attn.q_proj.weight": w(ecfg.n_heads * hd, D),
                   p + "self_attn.k_proj.weight": w(ecfg.n_kv_heads * hd, D),
                   p + "self_attn.v_proj.weight": w(ecfg.n_kv_heads * hd, D),
                   p + "self_attn.o_proj.weight": w(D, ecfg.n_heads * hd),
                   p + "mlp.gate_proj.weight": w(F, D), p + "mlp.up_proj.weight": w(F, D),
                   p + "mlp.down_proj.weight": w(D, F),
                   p + "input_layernorm.weight": torch.ones(D, device=dev, dtype=dtype),
                   p + "post_attention_layernorm.weight": torch.ones(D, device=dev, dtype=dtype)})
    return sd


def hf_config_json(ecfg, tie: bool = True) -> dict:
    """A Hugging Face ``config.json`` of Llama architecture at ``ecfg``'s widths."""
    return dict(architectures=["LlamaForCausalLM"], model_type="llama", vocab_size=ecfg.vocab_size,
                hidden_size=ecfg.dim, intermediate_size=ecfg.ffn_dim, num_hidden_layers=ecfg.n_layers,
                num_attention_heads=ecfg.n_heads, num_key_value_heads=ecfg.n_kv_heads,
                max_position_embeddings=131072, rope_theta=ecfg.rope_theta, rms_norm_eps=ecfg.norm_eps,
                tie_word_embeddings=tie, torch_dtype="bfloat16")


def hf_tiny_round_trip(d: Path) -> dict:
    """A ``--tiny`` Hugging Face directory (config.json + model.safetensors
    in bf16, drawn from a seed, written by ``hf_convert.write_safetensors``)
    through ``load_hf_checkpoint`` on the card: params equal to the
    conversion of the same state dict, an embed finite."""
    from autostyle_tts_tpu_torch.utils.config import tiny_config

    tcfg = tiny_config().embedder
    sd = hf_state_dict(tcfg, torch.Generator(device="cpu").manual_seed(4324))
    (d / "config.json").write_text(json.dumps(hf_config_json(tcfg, tie=False)))
    sd["lm_head.weight"] = sd["model.embed_tokens.weight"].clone() * 0.5
    hf_convert.write_safetensors(d / "model.safetensors", sd)
    cfg, params = hf_convert.load_hf_checkpoint(d)
    want = hf_convert.convert_state_dict(sd, cfg)
    got, want = _flat_keys(params), _flat_keys(want)
    check(sorted(got) == sorted(want) and all(torch.equal(got[k].cpu(), v) for k, v in want.items()),
          "path K tiny HF round trip: params differ from the conversion of the written state dict")
    e = rag.EmbedderService(cfg, params).embed(["a tiny checkpoint", "read back"], width=32)
    check(e.shape == (2, cfg.dim) and bool(np.isfinite(e).all()), "path K tiny HF embed")
    return dict(dim=cfg.dim, layers=cfg.n_layers, tensors=len(sd),
                bytes=(d / "model.safetensors").stat().st_size, equal=True)


def hf_embedder(d: Path) -> dict:
    """K3: a state dict in Hugging Face key names at ``Config().embedder``'s
    published Llama-3.2-3B geometry, bf16, drawn on the card; converted by
    ``config_from_hf`` + ``convert_state_dict`` on the card; served as a
    dense ``EmbedderService``: an embed at B=16, T=512 and one left-padded
    prefill (B=2, P=512; flash in each layer); then the tiny directory."""
    ecfg = Config().embedder
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sd = hf_state_dict(ecfg, torch.Generator(device="cuda").manual_seed(4325))
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = hf_convert.config_from_hf(hf_config_json(ecfg))
    params = hf_convert.convert_state_dict(sd, cfg)
    del sd
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    check((cfg.dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim, cfg.vocab_size) == (
        ecfg.dim, ecfg.n_layers, ecfg.n_heads, ecfg.n_kv_heads, ecfg.ffn_dim, ecfg.vocab_size)
        and cfg.tie_embeddings and "lm_head" not in params, f"path K HF config {cfg}")
    torch.cuda.empty_cache()
    gb = (torch.cuda.memory_allocated() - mem0) / 1e9
    emb = rag.EmbedderService(cfg, params)
    texts = [f"{s}: {t}" for s, t in RAG_SAMPLES] * 2
    emb.embed(texts[:2])       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e = emb.embed(texts)
    embed_ms = (time.perf_counter() - t0) * 1e3
    check(e.shape == (16, cfg.dim) and bool(np.isfinite(e).all()), "path K HF embed")
    seqs = [emb._encode(t, 512) for t in (RAG_DIALOG[0][1], RAG_SAMPLES[2][1] * 3)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = emb._generate_ids(seqs, 1, SamplerConfig.label(), 512)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    check(len(out) == 2, "path K HF prefill")
    del emb, params
    torch.cuda.empty_cache()
    tiny = hf_tiny_round_trip(d)
    return dict(geometry=dict(dim=cfg.dim, layers=cfg.n_layers, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
                              ffn=cfg.ffn_dim, vocab=cfg.vocab_size, tied=cfg.tie_embeddings),
                masters_gb=gb, draw_s=draw_s, convert_s=convert_s, embed_B=16, embed_T=512, embed_ms=embed_ms,
                embed_ms_per_row=embed_ms / 16, prefill_B=2, prefill_P=512, prefill_ms=prefill_ms, tiny_dir=tiny)


def path_k() -> dict:
    """The compat stack (K1-K3)."""
    reset_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        conv = compat_convert(d, COSYVOICE_300M)
        print("compat convert", json.dumps({k: v for k, v in conv.items() if k != "snapshot"}), flush=True)
        serve = compat_serve(conv.pop("snapshot"), COSYVOICE_300M)
        torch.cuda.empty_cache()
        compat_s = time.perf_counter() - t0
        (d / "hf").mkdir()
        hf = hf_embedder(d / "hf")
    launches = read_counts()
    for name in ("flash_attention", "fused_log_mel"):
        check(launches[name] > 0, f"path K never launched {name}: {launches}")
    return dict(convert=conv, serve=serve, hf=hf, launches=launches, compat_s=compat_s,
                wall_s=time.perf_counter() - t0)


def profile_embedder(emb, steps: int = 16) -> dict:
    """The embedder's decode loop under torch.profiler: a sampled
    generation (the biography sampler) of ``steps`` tokens at B=2 from a
    16-token prompt, whose prefill costs about one step: the device's idle
    share, device time by kernel, the host's own time by operator, and
    kernels a step (over the prefill and the steps)."""
    from torch.profiler import ProfilerActivity, profile

    seq = emb._encode("A: hello there, how are you today?", 16)
    emb._generate_ids([seq, seq], steps, SamplerConfig.biography(), 16)      # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        emb._generate_ids([seq, seq], steps, SamplerConfig.biography(), 16)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evts = device_events(prof)
    by_name = {}
    for name, us, _ in evts:
        total, n = by_name.get(name, (0.0, 0))
        by_name[name] = (total + us, n + 1)
    busy_us = sum(us for _, us, _ in evts)
    ops = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                 key=lambda e: -e.self_cpu_time_total)[:12]
    return dict(B=2, P=16, steps=steps, wall_ms=wall_us / 1e3, wall_ms_per_step=wall_us / 1e3 / (steps + 1),
                device_busy_ms=busy_us / 1e3,
                device_idle_share=(1.0 - busy_us / wall_us) if busy_us else "not measured",
                device_kernels=len(evts), kernels_per_step=len(evts) / (steps + 1),
                top_kernels=[dict(name=k, ms=us / 1e3, calls=n)
                             for k, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]],
                top_host_ops=[dict(name=e.key, self_cpu_ms=e.self_cpu_time_total / 1e3, calls=e.count)
                              for e in ops])


def device_events(prof):
    """(short kernel name, microseconds, start) of every device event of a
    profile, in start order."""
    evts = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    evts.sort(key=lambda e: e.time_range.start)
    return [(e.name.replace("(anonymous namespace)::", "").split("(")[0][:60],
             e.time_range.elapsed_us(), e.time_range.start) for e in evts]


def featurize_warm(eng: Engine):
    """``prompt_features`` at a bucket it has already seen (two 3 s wavs, the
    4 s bucket): the span of a second call, and from a third call under the
    profiler the device time of its log-mel launches and the kernel that
    ran just before each (a copy of the frames would show there). Every
    call must launch the kernel twice (the wrappers' count). The profiler
    can lose a kernel's record (one H100 host recorded one of the two
    log-mel launches in every profile of a run): the profiled call is made
    up to three times, and a profile that still lacks one is reported as
    such, with the records it has."""
    from torch.profiler import ProfilerActivity, profile

    wavs = [synthetic_wav(7), synthetic_wav(8)]
    eng.prompt_features(wavs)
    n0 = log_mel.fused_log_mel.launches
    clock = Stopwatch(torch.device("cuda"))
    eng.prompt_features(wavs, clock)
    check(log_mel.fused_log_mel.launches == n0 + 2, "a warm prompt_features call must launch fused_log_mel twice")
    for attempt in range(1, 4):
        torch.cuda.synchronize()
        n0 = log_mel.fused_log_mel.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.prompt_features(wavs)
            torch.cuda.synchronize()
        check(log_mel.fused_log_mel.launches == n0 + 2, "a profiled prompt_features call must launch fused_log_mel twice")
        evts = device_events(prof)
        at = [i for i, (name, _, _) in enumerate(evts) if "log_mel" in name]
        check(len(at) <= 2, f"{len(at)} log-mel kernels in the profile of one call")
        if len(at) == 2 or not evts:
            break
    return dict(span_ms=clock.ms["featurize"], log_mel_device_ms=[evts[i][1] / 1e3 for i in at],
                kernel_before_log_mel=[evts[i - 1][0] if i else None for i in at],
                log_mel_records=f"{len(at)} of 2", profiled_calls=attempt,
                device_busy_ms=sum(us for _, us, _ in evts) / 1e3 if evts else "not measured",
                device_kernels=len(evts))


def profile_request(eng: Engine, style, timbre):
    """One more request (prompts as given: store features or raw wavs) under
    torch.profiler: device time per kernel name and the device's idle share
    of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        next(eng.inference_tts_with_st(TEXTS[0], "style", style, timbre, max_seconds=5))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for name, us, _ in device_events(prof):
        total, n = by_name.get(name, (0.0, 0))
        by_name[name] = (total + us, n + 1)
    busy_us = sum(us for us, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    top = ranked[:12] + [kv for kv in ranked[12:] if "log_mel" in kv[0]]
    return dict(
        wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
        device_idle_share=(1.0 - busy_us / wall_us) if busy_us else "not measured",
        decode_steps=eng.last_decode_steps, device_kernels=sum(n for _, n in by_name.values()),
        top_kernels=[dict(name=k, ms=us / 1e3, calls=n) for k, (us, n) in top])


class MarkedStopwatch(Stopwatch):
    """A ``Stopwatch`` that launches a spin kernel at both edges of each
    span's body: on a profile's device timeline (one stream) each span's
    device work lies between two marks."""

    @contextmanager
    def span(self, name: str):
        with super().span(name):
            torch.cuda._sleep(1)
            try:
                yield
            finally:
                torch.cuda._sleep(1)


def profile_speculative(eng: Engine, store: StyleStore) -> dict:
    """J4's speculative decode of one DB-served request (``spec_decode``)
    under torch.profiler, its prefill and verify-loop spans marked on the
    device timeline (``MarkedStopwatch``): the loop's device kernels and
    copies alone, per verify, and the device's idle share of the loop's
    span. Made up to three times where the profile lost a mark (the
    profiler can lose a kernel's record, see ``featurize_warm``)."""
    from torch.profiler import ProfilerActivity, profile

    sty, tim = eng.prompt_features_from_store(store, [0, 1])
    for attempt in range(1, 4):
        torch.cuda.synchronize()
        clock = MarkedStopwatch(eng.device)
        # device activity only (all this reads): a verify loop is ~190,000 device events, and late in a
        # full run the profiler lost a mark of three such profiles that also held their host events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            spec = spec_decode(eng, TEXTS[0], store.meta[0]["text"], sty, tim, clock)
            torch.cuda.synchronize()
        evts = device_events(prof)
        marks = [i for i, (name, _, _) in enumerate(evts) if "spin_kernel" in name]
        if len(marks) == 4:
            break
    check(len(marks) == 4, f"profile speculative: {len(marks)} span marks of 4 after {attempt} profiles")
    prefill, loop = evts[marks[0] + 1: marks[1]], evts[marks[2] + 1: marks[3]]
    is_copy = lambda e: e[0].startswith(("Memcpy", "Memset"))
    copies = [e for e in loop if is_copy(e)]
    busy_ms = sum(us for _, us, _ in loop) / 1e3
    by_name = {}
    for name, us, _ in loop:
        total, n = by_name.get(name, (0.0, 0))
        by_name[name] = (total + us, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(n_verify=spec.n_verify, n_commit=spec.n_commit, loop_span_ms=clock.ms["decode"],
                prefill_span_ms=clock.ms["prefill"], prefill_kernels=sum(not is_copy(e) for e in prefill),
                kernels_per_verify=(len(loop) - len(copies)) / spec.n_verify,
                copies_per_verify=len(copies) / spec.n_verify, device_ms_per_verify=busy_ms / spec.n_verify,
                loop_device_idle_share=1.0 - busy_ms / clock.ms["decode"], profiled_calls=attempt,
                top_kernels=[dict(name=k, ms=us / 1e3, calls=n) for k, (us, n) in top])


def profile_batch(eng: Engine, store: StyleStore) -> dict:
    """Path D's batch with a 1 s bucket (64 decode steps at most) under
    torch.profiler: the device's idle share, device time by kernel and the
    host's own time by operator, and launches per scanned step."""
    from torch.profiler import ProfilerActivity, profile

    args = batch_args(eng, store)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.synthesize_batch(*args, max_seconds=1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evts = device_events(prof)
    by_name = {}
    for name, us, _ in evts:
        total, n = by_name.get(name, (0.0, 0))
        by_name[name] = (total + us, n + 1)
    busy_us = sum(us for _, us, _ in evts)
    ops = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                 key=lambda e: -e.self_cpu_time_total)[:15]
    steps = max(eng.last_decode_steps, 1)
    return dict(
        wall_ms=wall_us / 1e3, timings=eng.last_timings, decode_steps=eng.last_decode_steps,
        device_busy_ms=busy_us / 1e3,
        device_idle_share=(1.0 - busy_us / wall_us) if busy_us else "not measured",
        device_kernels=len(evts), kernels_per_decode_step=len(evts) / steps,
        top_kernels=[dict(name=k, ms=us / 1e3, calls=n)
                     for k, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]],
        top_host_ops=[dict(name=e.key, self_cpu_ms=e.self_cpu_time_total / 1e3, calls=e.count) for e in ops])


# ----------------------------------------------------------------------------- path L

L_STEPS = 3                # steps a stage on path L1 (ms a step: steps 2..L_STEPS)
SFT_SAMPLES = 40           # L2's synthetic chat samples, about 0.9 of seq 1024 each
SFT_EVAL = 8
FT3B_ADAPTER_PARAMS = 40370176    # artifacts/ft3b/meta.json "adapter_params"
UNREAD = {"token_lm": {"lm_head"}}    # trained trees' leaves the stage's loss never reads


def snapshot(tree) -> dict:
    """Copies of a tree's tensors by flat key."""
    return {k: v.detach().clone() for k, v in _flat_keys(tree).items()}


def changed(before: dict, tree) -> set:
    now = _flat_keys(tree)
    return {k for k, v in before.items() if not torch.equal(v, now[k])}


def run_stage(name: str, steps, trained_before: dict, trained_after, extra=None) -> dict:
    """Drive ``steps`` (a list of callables, one a step, each returning its
    loss and the pre-clip grad norm), time them, and check the losses and
    which tensors moved. -> the stage's ``train stage`` record."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    losses, norms, ms = [], [], []
    for step in steps:
        t0 = time.perf_counter()
        loss, norm = step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        norms.append(float(norm))
    tree = trained_after()
    moved = changed(trained_before, tree)
    still = set(trained_before) - moved
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)), f"train {name}: loss or grad norm not finite")
    check(still == UNREAD.get(name, set()), f"train {name}: tensors that did not move {sorted(still)}")
    rec = dict(stage=name, ms_per_step=ms[1:], first_step_ms=ms[0], peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               held_at_start_gb=held_gb,
               losses=losses, grad_norms=norms, tensors=len(trained_before), unchanged=sorted(still), **(extra or {}))
    print("train stage", json.dumps(rec), flush=True)
    return rec


def mel_term_check(cfg: Config, params, batch) -> dict:
    """Trap 1 on the card: the vocoder loss's weight-45 mel term has a
    nonzero gradient (the plain spectrogram; the log-mel kernel does not
    launch for it), and the kernel's wrapper refuses a waveform that
    requires grad rather than cut its gradient."""
    from autostyle_tts_tpu_torch.train import optim

    a = cfg.audio
    n0 = log_mel.fused_log_mel.launches
    _, _, g = optim.value_and_grad(lambda q: vocoder.mel_l1_loss(
        vocoder.apply(q, cfg.vocoder, batch["mel"]), batch["wav"], a.sample_rate, a.n_fft, a.hop_length,
        cfg.vocoder.n_mels), params)
    norm = float(optim.global_norm(g))
    check(norm > 0 and np.isfinite(norm), f"path L1: the mel loss's gradient norm is {norm}")
    check(log_mel.fused_log_mel.launches == n0, "path L1: the mel loss launched the log-mel kernel")
    w = batch["wav"].clone().requires_grad_(True)
    try:
        stft.log_mel_spectrogram(w, a.sample_rate, a.n_fft, a.hop_length, n_mels=cfg.vocoder.n_mels)
    except RuntimeError as e:
        check("no backward" in str(e), f"path L1: the log-mel wrapper raised {e}")
    else:
        check(False, "path L1: the log-mel kernel's wrapper took a waveform that requires grad")
    return dict(mel_loss_grad_norm=norm)


def path_l1(d: Path) -> dict:
    """L1: every acoustic stage at ``Config()``'s flagship widths (token LM
    1024 x 14, CFM 512 x 8, the iSTFT vocoder), 3 steps each, on batches of
    4 that ``make_acoustic_batches`` featurizes on the card (the log-mel
    kernel) from a 32-utterance synthcorpus; one distillation step. The
    engine's own weights must not move."""
    from autostyle_tts_tpu_torch.models import discriminator
    from autostyle_tts_tpu_torch.train import acoustic, cfm_distill
    from autostyle_tts_tpu_torch.train.data import load_acoustic_manifest, make_acoustic_batches
    from autostyle_tts_tpu_torch.train.synthcorpus import N_PHONEME_CLASSES, generate_corpus

    cfg = Config()
    a = cfg.audio
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4400)
    t0 = time.perf_counter()
    manifest = generate_corpus(d / "corpus", n_utts=32, n_speakers=4, seed=0)
    corpus_s = time.perf_counter() - t0
    masters = EngineParams.init(gen, cfg)
    eng = Engine(cfg, params=masters, seed=0)
    engine_before = snapshot(masters.tree())
    items = load_acoustic_manifest(manifest, str(d / "corpus"))
    t0 = time.perf_counter()
    batches = list(itertools.islice(make_acoustic_batches(eng, items, 4, 3.0, seed=0), L_STEPS))
    torch.cuda.synchronize()
    featurize_s = time.perf_counter() - t0
    check(len(batches) == L_STEPS, f"path L1: {len(batches)} batches of 4 from 32 items")
    opt = lambda: acoustic.default_optimizer(1e-4, 100)
    stages = []

    def factory_steps(step_fn, state: dict, call):
        """L_STEPS steps of ``call(state, batch)``, which updates ``state``."""
        def one(b):
            def run():
                loss = call(state, b)
                return loss, step_fn.grad_norm
            return run
        return [one(b) for b in batches]

    # tokenizer: VQ + phoneme head, usage EMA and restarts
    o = opt()
    st = {"p": {"tok": masters.speech_tokenizer,
                "head": acoustic.init_tokenizer_head(gen, cfg.speech_tokenizer, N_PHONEME_CLASSES)},
          "usage": acoustic.init_usage(cfg.speech_tokenizer, dev)}
    st["o"] = o.init(st["p"])
    tok_step = acoustic.make_tokenizer_step(cfg.speech_tokenizer, a, o, N_PHONEME_CLASSES)

    def tok_call(s, b):
        s["p"], s["o"], s["usage"], loss, ce, acc, n_used = tok_step(s["p"], s["o"], s["usage"], b["tokenizer"], gen)
        s["n_used"] = int(n_used)
        return loss
    before = snapshot(st["p"])
    stages.append(run_stage("tokenizer", factory_steps(tok_step, st, tok_call), before, lambda: st["p"]))
    stages[-1]["codes_used"] = st["n_used"]

    # token LM, CFM, vocoder: the engine's f32 weights (the LM's masters, not its served copy)
    for name in ("token_lm", "cfm", "vocoder"):
        o = opt()
        if name == "token_lm":
            step_fn = acoustic.make_token_lm_step(cfg.token_lm, o)
        elif name == "cfm":
            step_fn = acoustic.make_cfm_step(cfg.cfm, o)
        else:
            step_fn = acoustic.make_vocoder_step(cfg.vocoder, o, sr=a.sample_rate, n_fft=a.n_fft, hop=a.hop_length)
        params = getattr(masters, name)
        s = {"p": params, "o": o.init(params)}

        def call(s, b, step_fn=step_fn, key=name):
            s["p"], s["o"], loss = step_fn(s["p"], s["o"], b[key], gen)
            return loss
        extra = mel_term_check(cfg, params, batches[0]["vocoder"]) if name == "vocoder" else None
        stages.append(run_stage(name, factory_steps(step_fn, s, call), snapshot(params), lambda s=s: s["p"], extra))
        if name == "cfm":
            cfm_trained = s["p"]

    # the vocoder against the discriminators: D then G on each batch
    go, do = opt(), opt()
    gen_step, disc_step = acoustic.make_vocoder_gan_steps(cfg.vocoder, go, do, sr=a.sample_rate, n_fft=a.n_fft,
                                                          hop=a.hop_length)
    s = {"g": masters.vocoder, "d": discriminator.init_params(gen)}
    s["go"], s["do"] = go.init(s["g"]), do.init(s["d"])

    def gan_call(s, b):
        s["d"], s["do"], d_loss = disc_step(s["d"], s["do"], s["g"], b["vocoder"], gen)
        s["g"], s["go"], g_loss = gen_step(s["g"], s["go"], s["d"], b["vocoder"], gen)
        s["d_loss"] = float(d_loss)
        return g_loss
    before = {**snapshot({"g": s["g"]}), **snapshot({"d": s["d"]})}
    gan = run_stage("vocoder_gan", [(lambda b=b: (gan_call(s, b), gen_step.grad_norm)) for b in batches], before,
                    lambda: {"g": s["g"], "d": s["d"]})
    gan["disc_grad_norm"] = float(disc_step.grad_norm)
    gan["disc_params"] = sum(v.numel() for v in _flat_keys(s["d"]).values())
    stages.append(gan)
    del s

    # the phoneme head alone on the frozen tokenizer
    o = opt()
    head = acoustic.init_tokenizer_head(gen, cfg.speech_tokenizer, N_PHONEME_CLASSES)
    ph_step = acoustic.make_phn_head_step(cfg.speech_tokenizer, a, o, N_PHONEME_CLASSES)
    s = {"p": head, "o": o.init(head)}

    def ph_call(s, b):
        s["p"], s["o"], ce, acc = ph_step(masters.speech_tokenizer, s["p"], s["o"], b["tokenizer"])
        return ce
    stages.append(run_stage("phn_head", factory_steps(ph_step, s, ph_call), {"": head.clone()}, lambda: s["p"]))

    # one distillation step: the trained CFM as the guided teacher, a 2-step student
    o = opt()
    dist_step = cfm_distill.make_distill_step(cfg.cfm, o, 2, cfg.cfm.cfg_scale)
    s = {"p": cfm_trained, "o": o.init(cfm_trained)}
    teacher_before = snapshot(cfm_trained)

    def dist_call(s, b):
        s["p"], s["o"], loss = dist_step(s["p"], cfm_trained, s["o"], b["cfm"], gen)
        return loss
    stages.append(run_stage("distill", factory_steps(dist_step, s, dist_call)[:1], teacher_before, lambda: s["p"]))
    check(not changed(teacher_before, cfm_trained), "path L1: the distillation teacher moved")
    check(not changed(engine_before, masters.tree()), "path L1: a step wrote the engine's own weights")
    del eng, masters, batches
    torch.cuda.empty_cache()
    return dict(stages=stages, corpus_s=corpus_s, featurize_s=featurize_s)


def sft_samples(n: int, seed: int, target_tokens: int = 920) -> list:
    """Synthetic ERC chat samples of about ``target_tokens`` byte tokens
    (0.9 of seq 1024, as the reference's +-5-turn prompts are)."""
    from autostyle_tts_tpu_torch.train.reformat import label_set

    rng = np.random.default_rng(seed)
    labels = label_set("en")
    words = ["okay", "really", "never", "again", "please", "listen", "what", "about", "that", "sorry", "fine",
             "we", "could", "go", "home", "now", "you", "said", "it", "was"]
    out = []
    for i in range(n):
        ctx = []
        while sum(len(c) + 8 for c in ctx) < target_tokens - 200:
            ctx.append(" MARY: " + " ".join(rng.choice(words, int(rng.integers(4, 14)))) + ".")
        out.append({"messages": [
            {"role": "system", "content": "### You are an expert at analyzing the emotion of utterances among "
                                          "speakers in a conversation.\n### Given the following conversation as a "
                                          "context \n" + "\n".join(ctx)},
            {"role": "user", "content": f'Based on above conversation, which emotional label of MARY in the '
                                        f'utterance "{ctx[-1][7:]}".'},
            {"role": "assistant", "content": labels[int(rng.integers(len(labels)))]}]})
    return out


def path_l2(d: Path) -> dict:
    """L2: the LoRA SFT at Llama-3.2-3B width (28 x 3072, GQA 24:8,
    128,256-token vocabulary) on an int8 base drawn on the card from a
    seed: ``lora_sft.train`` with ``TrainConfig``'s defaults (bs 4 x accum
    4, seq 1024, NEFTune 5, remat on, lr 3e-4 linear) for 2 applied steps
    with an eval at step 2, then a second call that resumes and stops; one
    micro-step at B=2 with remat on and off; 4 updates on one repeated
    batch."""
    from autostyle_tts_tpu_torch.train import lora_sft, optim
    from autostyle_tts_tpu_torch.train.reformat import label_set
    from autostyle_tts_tpu_torch.utils.config import TrainConfig

    ecfg = Config().embedder
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4500)
    t0 = time.perf_counter()
    base = transformer.init_params_quantized(ecfg, rng.PRNGKey(42, "cuda"), bits=8)
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t0
    base_before = {k: float(v.sum(dtype=torch.float64)) for k, v in _flat_keys(base).items()}
    tcfg = dataclasses.replace(TrainConfig(), eval_every=2, save_every=2, epochs=1)
    n_adapter = sum(v.numel() for v in _flat_keys(transformer.init_lora(ecfg, tcfg.lora.r, rng.PRNGKey(1, "cuda")))
                    .values())
    check(n_adapter == FT3B_ADAPTER_PARAMS, f"path L2: the adapter has {n_adapter} parameters")
    train, evals = sft_samples(SFT_SAMPLES, 0), sft_samples(SFT_EVAL, 1)
    rendered = lora_sft.render_samples(train, tcfg.max_seq_len)
    lens = [len(ids) for ids, _ in rendered]
    logs = []
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    flash0 = flash_attn.flash_attention.launches
    t0 = time.perf_counter()
    res = lora_sft.train(base, ecfg, tcfg, train, eval_samples=evals, labels=label_set("en"), out_dir=str(d / "ft"),
                         log_every=1, log=logs.append)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_peak = torch.cuda.max_memory_allocated() / 1e9
    flash_in_eval = flash_attn.flash_attention.launches - flash0
    check(flash_in_eval > 0, "path L2: the eval's prefill never launched flash_attention")
    check(not res["packing"] and any("packing auto-disabled" in m for m in logs),
          f"path L2: packing stayed on over samples of {min(lens)}-{max(lens)} tokens")
    check(res["steps"] == 2, f"path L2: {res['steps']} applied steps, expected 2")
    hist = json.loads((d / "ft" / "history.json").read_text())
    f1 = [h["eval_weighted_f1"] for h in hist if "eval_weighted_f1" in h]
    check(len(f1) == 1 and (d / "ft" / "best.npz").exists(), f"path L2: eval / best.npz missing: {hist}")
    t0 = time.perf_counter()
    res2 = lora_sft.train(base, ecfg, tcfg, train, out_dir=str(d / "ft"), log=logs.append)
    resume_s = time.perf_counter() - t0
    check(res2["steps"] == 2 and all(torch.equal(a, b) for a, b in zip(optim.tree_leaves(res2["lora"]),
                                                                          optim.tree_leaves(res["lora"]))),
          "path L2: the resumed call did not stop at the restored step 2 with the saved adapter")

    # one micro-step at B=2 with remat on and off (peak memory beside each other)
    batch = next(lora_sft.make_batches(train, tcfg.max_seq_len, 4, shuffle=False, rendered=rendered))
    args = [torch.as_tensor(x, device=dev) for x in (batch.tokens, batch.loss_mask, batch.length)]
    remat = {}
    for on in (True, False):
        c = dataclasses.replace(tcfg, remat=on)
        o = lora_sft.make_optimizer(c, 4)
        lora = transformer.init_lora(ecfg, c.lora.r, rng.PRNGKey(1, "cuda"))
        step = lora_sft.make_train_step(ecfg, c, o, packed=False)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 1e9
        t1 = time.perf_counter()
        step(lora, o.init(lora), base, *(x[:2] for x in args), gen)
        torch.cuda.synchronize()
        remat["on" if on else "off"] = dict(ms=(time.perf_counter() - t1) * 1e3,
                                            peak_gb=torch.cuda.max_memory_allocated() / 1e9, held_at_start_gb=held)
        del lora, step, o

    # 4 updates on one repeated batch (B=4): the loss must fall; ms a micro-step from updates 2-4
    o = lora_sft.make_optimizer(tcfg, 4)
    lora = transformer.init_lora(ecfg, tcfg.lora.r, rng.PRNGKey(1, "cuda"))
    state = o.init(lora)
    step = lora_sft.make_train_step(ecfg, tcfg, o, packed=False)
    losses, ms = [], []
    for _ in range(4):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lora, state, loss = step(lora, state, base, *args, gen)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t1) * 1e3)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"path L2: repeated-batch losses {losses}")
    check(all(float(v.sum(dtype=torch.float64)) == base_before[k] for k, v in _flat_keys(base).items()),
          "path L2: the frozen base moved")
    check(all(t.grad is None and not t.requires_grad for t in _flat_keys(base).values()),
          "path L2: the frozen base holds a gradient")
    ms_step = float(np.mean(ms[1:]))
    rec = dict(adapter_params=n_adapter, base_s=base_s, sample_tokens=[min(lens), max(lens)],
               train_s=train_s, resume_s=resume_s, train_peak_gb=train_peak, held_at_start_gb=held_gb,
               applied_steps=res["steps"],
               micro_steps=res["steps"] * tcfg.grad_accum, packing=res["packing"],
               train_losses=[h["loss"] for h in hist if "loss" in h], eval_f1=f1,
               flash_launches_in_train=flash_in_eval, repeated_batch_losses=losses, ms_per_micro_step=ms_step,
               tokens_per_s=batch.tokens.size / ms_step * 1e3,
               real_tokens_per_s=int(batch.length.sum()) / ms_step * 1e3, first_micro_step_ms=ms[0],
               micro_step_b2=remat)
    print("train sft", json.dumps(rec), flush=True)
    del base, lora, state
    torch.cuda.empty_cache()
    return rec


def path_l3(d: Path) -> dict:
    """L3: the training CLIs through their ``main`` at ``--tiny`` on the
    card: make_corpus -> train_acoustic for every stage (2 steps) ->
    export_engine --stage_ckpt for the four mergeable stages -> basic from
    the snapshot; distill_cfm, ft_llm --re_gen_data --do_train
    --do_eval_dev on a tiny ERC JSON, train_bpe, evaluate_base_model."""
    from autostyle_tts_tpu_torch.cli import (basic, distill_cfm, evaluate_base_model, export_engine, ft_llm,
                                             make_corpus, train_acoustic, train_bpe)
    from autostyle_tts_tpu_torch.utils.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    times = {}
    make_corpus.main(["--out_dir", str(d / "corpus"), "--n_utts", "8", "--n_speakers", "2"])
    corpus = ["--manifest", str(d / "corpus" / "manifest.json"), "--wav_dir", str(d / "corpus")]
    for stage in ("tokenizer", "token_lm", "cfm", "vocoder", "vocoder_gan", "phn_head"):
        t1 = time.perf_counter()
        train_acoustic.main(["--tiny", *corpus, "--stage", stage, "--out_dir", str(d / stage), "--batch_size", "4",
                             "--prompt_seconds", "0.4", "--log_every", "1"])
        times[stage] = time.perf_counter() - t1
        check(CheckpointManager(d / stage).latest_step() == 2, f"path L3: train_acoustic --stage {stage}")
    merged = ("tokenizer", "token_lm", "cfm", "vocoder")
    export_engine.main(["--tiny", "--output", str(d / "engine.npz")]
                       + [a for s in merged for a in ("--stage_ckpt", f"{s}={d / s}")])
    basic.main(["--tiny", "--checkpoint", str(d / "engine.npz"), "--prompt_wav",
                str(d / "corpus" / "wavs" / "utt00000.wav"), "--result_dir", str(d / "out")])
    wav, sr = read_wav(d / "out" / "zero_shot_0.wav")
    check(wav.size > 0 and bool(np.isfinite(wav).all()), "path L3: the snapshot's synthesis is empty or not finite")
    distill_cfm.main(["--tiny", *corpus, "--checkpoint", str(d / "engine.npz"), "--output", str(d / "dist.npz"),
                      "--schedule", "2", "--steps_per_phase", "2", "--batch_size", "2", "--prompt_seconds", "0.4",
                      "--eval_batches", "1"])
    erc = d / "erc"
    erc.mkdir()
    conv = {"labels": [0, 2, 5, 1], "sentences": ["I love this!", "Okay.", "This is hopeless.", "Oh no."],
            "genders": ["F", "M", "F", "M"]}
    for split, conv_ids in (("train", ("Ses01_a", "Ses02_b")), ("valid", ("Ses03_c",))):
        (erc / f"iemocap.{split}.json").write_text(json.dumps({c: conv for c in conv_ids}))
    flags = ["--tiny", "--set", "embedder.vocab_size=272", "--set", "train.max_seq_len=256", "--set",
             "train.epochs=1", "--set", "train.eval_every=1", "--set", "train.lora.r=4", "--set",
             "train.batch_size=2", "--set", "train.grad_accum=2"]
    ft_llm.main(flags + ["--data_folder", str(erc), "--re_gen_data", "--do_train", "--do_eval_dev", "--window", "1",
                         "--quantize_base", "--out_dir", str(d / "ft")])
    summary = json.loads((d / "ft" / "summary.json").read_text())
    check(summary["42"]["steps"] == 2 and "valid_f1" in summary["42"], f"path L3: ft_llm summary {summary}")
    evaluate_base_model.main(flags + ["--test_jsonl", str(erc / "iemocap.valid.0shot_w1_default.jsonl"),
                                      "--output_file", str(d / "base_eval.json")])
    (d / "text.txt").write_text("\n".join(["the cat sat on the mat", "the dog sat", "cats and dogs"] * 4))
    train_bpe.main(["--input", str(d / "text.txt"), "--output", str(d / "bpe.json"), "--merges", "8"])
    check(len(json.loads((d / "bpe.json").read_text())["merges"]) == 8, "path L3: train_bpe merges")
    return dict(stage_s=times, wall_s=time.perf_counter() - t0, wav_samples=int(wav.size), wav_rate=sr,
                ft_llm=summary["42"])


def path_l() -> dict:
    """Training (L1-L3)."""
    reset_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        (d / "l1").mkdir()
        l1 = path_l1(d / "l1")
        l1_s = time.perf_counter() - t0
        (d / "l2").mkdir()
        l2 = path_l2(d / "l2")
        l2_s = time.perf_counter() - t0 - l1_s
        (d / "l3").mkdir()
        with redirect_stdout(io.StringIO()):
            l3 = path_l3(d / "l3")
        print("train clis", json.dumps(l3), flush=True)
    launches = read_counts()
    for name in ("flash_attention", "fused_log_mel"):
        check(launches[name] > 0, f"path L never launched {name}: {launches}")
    return dict(l1=l1, l2=l2, l3=l3, launches=launches, l1_s=l1_s, l2_s=l2_s, wall_s=time.perf_counter() - t0)


# ----------------------------------------------------------------------------- path M

PROBE = FIXTURES / "jax_base_probe.npz"
MILVUS_ROWS, MILVUS_DIM = 130, 6144     # the reference corpus's shape (milvus/milvus_demo.db)
BIO_CONVERSATION = {"Ses01_m3": {       # one 4-utterance conversation of 2 speakers: one B=4 biography batch
    "sentences": ["Did you see the letter from the landlord?", "I did, and I am not paying that much.",
                  "We could at least call him tomorrow.", "Fine, but you are doing the talking."],
    "genders": ["F", "M", "F", "M"], "labels": [2, 3, 2, 5]}}


def tree_gb(tree) -> float:
    return sum(t.numel() * t.element_size() for t in _flat_keys(tree).values()) / 1e9


def path_m1(ecfg, pi_rag: dict) -> dict:
    """The embedder base the ft3b adapter was trained over, drawn on the
    card from ``PRNGKey(42)`` (int8), held to the JAX package's slices of
    it (``tests/fixtures/jax_base_probe.npz``); path I's labels on it."""
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = transformer.init_params_quantized(ecfg, rng.PRNGKey(42, "cuda"), bits=8)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    drawn_gb = (torch.cuda.memory_allocated() - mem0) / 1e9
    probe = np.load(PROBE)
    check(int(probe["seed"]) == 42, "the probe is of PRNGKey(42)")
    cols = [int(c) for c in probe["cols"]]
    n = probe["tok_emb"].shape[0]
    ulps = np.abs(params["tok_emb"][:n].cpu().numpy().view(np.int32).astype(np.int64)
                  - probe["tok_emb"].view(np.int32).astype(np.int64))
    slices = {}
    for name in ("wqkv", "w_down"):
        for l in (0, ecfg.n_layers - 1):
            t = params["layers"][name]
            q = t.q[l][:, cols].cpu().numpy().astype(np.int64)
            dq = np.abs(q - probe[f"{name}/{l}/q"].astype(np.int64))
            s, ps = t.s[l].cpu().numpy(), probe[f"{name}/{l}/s"]
            slices[f"{name}/{l}"] = dict(q_equal=float((dq == 0).mean()), q_max_diff=int(dq.max()),
                                         s_max_rel=float(np.abs(s - ps).max() / np.abs(ps).max()))
            check(slices[f"{name}/{l}"]["q_max_diff"] <= 1 and slices[f"{name}/{l}"]["q_equal"] >= 0.9999
                  and slices[f"{name}/{l}"]["s_max_rel"] <= 1e-6, f"M1: {name} layer {l} against the probe: {slices}")
    check(int(ulps.max()) <= 4, f"M1: tok_emb rows {int(ulps.max())} ulp from the probe")
    lay = params["layers"]
    rec = dict(draw_s=draw_s, drawn_gb=drawn_gb,
               layers_gb=tree_gb({k: lay[k] for k in ("wqkv", "wo", "w_gate_up", "w_down")}),
               lm_head_gb=tree_gb(params["lm_head"]), tok_emb_gb=tree_gb(params["tok_emb"]),
               tok_emb_max_ulp=int(ulps.max()), tok_emb_equal=float((ulps == 0).mean()), slices=slices,
               path_i_turn_labels=pi_rag["turn_labels"], path_i_db_labels=pi_rag["emotions"])
    del params
    torch.cuda.empty_cache()
    return rec


def path_m2(ecfg) -> dict:
    """The int4 embedder at full width (``bits=4`` from ``PRNGKey(0)``, as
    the JAX package's embedder benchmark draws it): one embed batch at
    B=16, T=512 and one biography batch at B=2 (P=1024) with 32 new tokens."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = transformer.init_params_quantized(ecfg, rng.PRNGKey(0, "cuda"), bits=4)
    torch.cuda.synchronize()
    draw_s, drawn_gb = time.perf_counter() - t0, (torch.cuda.memory_allocated() - mem0) / 1e9
    check(isinstance(params["layers"]["wqkv"], Q4Tensor), "M2: int4 projections")
    lay = params["layers"]
    sizes = dict(layers_gb=tree_gb({k: lay[k] for k in ("wqkv", "wo", "w_gate_up", "w_down")}),
                 lm_head_gb=tree_gb(params["lm_head"]), tok_emb_gb=tree_gb(params["tok_emb"]))
    emb = rag.EmbedderService(ecfg, params)
    texts = [" ".join([RAG_SAMPLES[(i + j) % len(RAG_SAMPLES)][1] for j in range(12)]) for i in range(16)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vecs = emb.embed(texts, width=512)
    embed_ms = (time.perf_counter() - t0) * 1e3
    check(vecs.shape == (16, ecfg.dim) and bool(np.isfinite(vecs).all()), f"M2: embed {vecs.shape}")
    items = [(" ".join(t for _, t in RAG_DIALOG), s) for s in ("w1", "m1")]
    prompts = [rag.BIOGRAPHY_PROMPT.format(conversation=c, speaker=s) for c, s in items]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bios = emb._generate(prompts, 32, SamplerConfig.biography())
    bio_ms = (time.perf_counter() - t0) * 1e3
    check(len(bios) == 2 and all(isinstance(b, str) for b in bios), "M2: biographies")
    rec = dict(draw_s=draw_s, **sizes, drawn_gb=drawn_gb, embed_b16_t512_ms=embed_ms,
               embed_ms_per_row=embed_ms / 16, bio_b2_p1024_32tok_ms=bio_ms, bio_chars=[len(b) for b in bios],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del emb, params
    torch.cuda.empty_cache()
    return rec


def path_m3(d: Path, store: StyleStore) -> dict:
    """The retrieval CLIs at full width: ``retrieval_report`` over path I's
    store and the CLI over its snapshot (``--fail_below_recall 1.0``);
    ``llm_bio_extract`` on the 3B int8 base (``--seed 42``) with the ft3b
    adapter over one 4-utterance conversation, then again: it resumes."""
    from autostyle_tts_tpu_torch.cli import llm_bio_extract, retrieval_report as report_cli

    report = simeval.retrieval_report(store, k=5)
    check(report["recall_at_k"] == 1.0 and report["n"] == len(store), f"M3: path I's store report {report}")
    store.save(d / "store")
    out = io.StringIO()
    with redirect_stdout(out):
        report_cli.main(["--db_path", str(d / "store"), "--k", "5", "--fail_below_recall", "1.0"])
    cli_report = json.loads(out.getvalue())
    check(cli_report["recall_at_k"] == 1.0, f"M3: retrieval_report CLI {cli_report}")
    (d / "conv.json").write_text(json.dumps(BIO_CONVERSATION))
    argv = ["--quantize_base", "--seed", "42", "--lora_checkpoint", str(ADAPTER), "--data_json", str(d / "conv.json"),
            "--output_json", str(d / "bios.json"), "--batch_ladder", "4", "2", "1"]
    calls = []
    bios0 = rag.EmbedderService.biographies

    def biographies(self, items):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bios0(self, items)
        calls.append(dict(B=len(items), ms=(time.perf_counter() - t0) * 1e3))
        return res

    rag.EmbedderService.biographies = biographies
    try:
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            with redirect_stdout(io.StringIO()) as log:
                llm_bio_extract.main(argv)
            walls.append(time.perf_counter() - t0)
    finally:
        rag.EmbedderService.biographies = bios0
    res = json.loads((d / "bios.json").read_text())
    check(list(res) == list(BIO_CONVERSATION) and len(res["Ses01_m3"]) == 4, f"M3: bios file {list(res)}")
    check(len(calls) == 1 and calls[0]["B"] == 4, f"M3: biography batches {calls}")
    check("resuming: 1 conversations already processed" in log.getvalue()
          and json.loads((d / "bios.json_backup.json").read_text()) == res, "M3: the second run did not resume")
    return dict(report=report, cli_recall=cli_report["recall_at_k"], bio_batches=calls, bio_walls_s=walls,
                bio_chars=[len(b) for b in res["Ses01_m3"]])


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | 0x80 if n else b)
        if not n:
            return bytes(out)


def milvus_record(vec, meta, nbytes=None) -> bytes:
    """One Milvus Lite insert record in the layout ``milvus_import`` parses:
    the ``vector`` FieldData, then the dynamic-field JSON."""
    out = b"\x0a\x05hdr\x12\x01\x00"
    if vec is not None:
        fv = vec.astype("<f4").tobytes()
        floats = b"\x0a" + _varint(len(fv) if nbytes is None else nbytes) + fv
        msg = b"\x08" + _varint(vec.size) + b"\x12" + _varint(len(floats)) + floats
        out += b"vector\x22" + _varint(len(msg)) + msg
    return out + b"\x1a" + json.dumps(meta, ensure_ascii=False).encode()


def path_m4(d: Path) -> dict:
    """A synthetic Milvus Lite file of the reference corpus's shape (130 x
    6144, plus rows the parser skips and a small second collection)
    through ``import_milvus --list``, an import to the card, ``self_verify``
    and ``retrieval_report``."""
    import sqlite3

    from autostyle_tts_tpu_torch.cli import import_milvus

    r = np.random.default_rng(5)
    vecs = r.standard_normal((MILVUS_ROWS, MILVUS_DIM)).astype(np.float32)
    rows = [milvus_record(v, {"file_id": f"denoise_{i}.wav", "text": f"style line {i} {{braced}} }}"})
            for i, v in enumerate(vecs)]
    rows += [None, milvus_record(None, {"file_id": "no_vector", "text": ""}),
             milvus_record(vecs[0], {"file_id": "short", "text": ""}, nbytes=MILVUS_DIM * 4 - 4)]
    path = d / "milvus_demo.db"
    con = sqlite3.connect(path)
    con.execute("CREATE TABLE collection_meta (name TEXT, schema BLOB)")
    for name, blobs in (("style_db", rows), ("small", rows[:3])):
        con.execute("INSERT INTO collection_meta VALUES (?, ?)", (name, b""))
        con.execute(f'CREATE TABLE "{name}" (id INTEGER PRIMARY KEY, milvus_id INTEGER, data BLOB)')
        con.executemany(f'INSERT INTO "{name}" (milvus_id, data) VALUES (?, ?)', list(enumerate(blobs)))
    con.commit()
    con.close()
    t0 = time.perf_counter()
    with redirect_stdout(io.StringIO()) as listed:
        import_milvus.main(["--milvus_db", str(path), "--out", str(d / "imported"), "--list"])
    with redirect_stdout(io.StringIO()) as imported:
        import_milvus.main(["--milvus_db", str(path), "--out", str(d / "imported")])
    cli_s = time.perf_counter() - t0
    check(listed.getvalue().split() == ["style_db", "small"], f"M4: --list printed {listed.getvalue()!r}")
    check(f"imported {MILVUS_ROWS} vectors (dim {MILVUS_DIM})" in imported.getvalue()
          and "self-verify ok" in imported.getvalue(), f"M4: import printed {imported.getvalue()!r}")
    store = StyleStore.load(d / "imported")
    check(store.device.type == "cuda" and len(store) == MILVUS_ROWS and store.self_verify(), "M4: the imported store")
    want = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    err = float(np.abs(store.db[:MILVUS_ROWS].cpu().numpy() - want).max())
    check(err <= 1e-6 and store.meta[7]["text"] == "style line 7 {braced} }", f"M4: vectors {err} / meta")
    t0 = time.perf_counter()
    report = simeval.retrieval_report(store, k=5)
    report_ms = (time.perf_counter() - t0) * 1e3
    check(report["recall_at_k"] == 1.0, f"M4: recall {report}")
    return dict(rows=len(store), dim=store.dim, skipped=3, max_abs_err=err, cli_s=cli_s, report_ms=report_ms,
                recall_at_5=report["recall_at_k"], cross_top1=report["cross_top1"])


def path_m5(e_wavs) -> dict:
    """The phoneme evaluation on the trained demo engine: ``fit_code_map``
    over the corpus sample's 6 utterances, ``PhonemeRecognizer`` with that
    map and with a drawn head over path E's wavs and the corpus wavs (PER
    against each text), each transcript also through the plain log-mel."""
    from autostyle_tts_tpu_torch.train.synthcorpus import N_PHONEME_CLASSES

    cfg = demo_config()
    a = cfg.audio
    eng = Engine(cfg, params=EngineParams.from_tree(from_jax_tree(load_npz(FIXTURES / "demo_engine.npz"), cfg)),
                 seed=0)
    rows = json.loads((FIXTURES / "demo_corpus_sample" / "manifest.json").read_text())
    wavs = [read_wav(FIXTURES / "demo_corpus_sample" / r["wav"])[0] for r in rows]
    phns = [np.load(FIXTURES / "demo_corpus_sample" / r["phn"]) for r in rows]
    t0 = time.perf_counter()
    code_map = simeval.fit_code_map(eng, wavs, phns)
    fit_ms = (time.perf_counter() - t0) * 1e3
    used = sorted({int(t) for f in eng.prompt_features(wavs) for t in f.tokens})
    st = cfg.speech_tokenizer
    head = (np.random.default_rng(0).standard_normal((st.dim, N_PHONEME_CLASSES)) * st.dim ** -0.5).astype(np.float32)
    recognizers = {"code_map": simeval.PhonemeRecognizer(eng, code_map=code_map),
                   "head": simeval.PhonemeRecognizer(eng, head=head)}
    cases = [(f"corpus {r['wav']}", r["text"], w, a.prompt_sample_rate) for r, w in zip(rows, wavs)]
    cases += [(f"path E {name}", text, w, a.sample_rate) for name, text, w in e_wavs]
    per, same = {k: [] for k in recognizers}, True
    t0 = time.perf_counter()
    for _, text, w, rate in cases:
        expected = simeval.text_to_phoneme_ids(text)
        for kind, rec in recognizers.items():
            got = rec.transcribe(w, rate)
            per[kind].append(simeval.levenshtein(got, expected) / len(expected))
            mel0 = stft.fused_log_mel
            stft.fused_log_mel = log_mel.fused_log_mel_plain
            try:
                same &= rec.transcribe(w, rate) == got
            finally:
                stft.fused_log_mel = mel0
    check(same, "M5: a transcript through the log-mel kernel differs from the plain log-mel's")
    check(all(np.isfinite(p) for v in per.values() for p in v), f"M5: PER {per}")
    return dict(codes_used=used, mapped_codes={str(c): int(code_map[c]) for c in used},
                map_nonzero=int((code_map != 0).sum()), fit_ms=fit_ms, cases=[c[0] for c in cases],
                per=per, mean_per={k: float(np.mean(v)) for k, v in per.items()},
                transcribe_ms=(time.perf_counter() - t0) * 1e3 / (2 * 2 * len(cases)), kernel_equals_plain=same)


def path_m6(device: str = "cuda") -> dict:
    """The training gates (``tests/test_torch_train_gates.py``) on the card,
    at the slow tests' sizes and thresholds."""
    import importlib.util

    src = Path(__file__).resolve().parent / "tests" / "test_torch_train_gates.py"
    spec = importlib.util.spec_from_file_location("train_gates", src)
    gates = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gates)
    out = {}
    for name in gates.CARD_GATES:     # the SFT gate in bf16: the flash kernel takes bf16 activations only
        t0 = time.perf_counter()
        try:
            res = gates.GATES[name](device)
        except AssertionError as e:
            raise SystemExit(f"chip_smoke: FAILED: M6 training gate {name}: {e}")
        losses = isinstance(res, list) and isinstance(res[0], float)
        out[name] = dict(s=time.perf_counter() - t0,
                         result=dict(first=res[0], last=res[-1], steps=len(res)) if losses else res)
    return out


def path_m(inputs: PathInputs, pi_rag: dict, store: StyleStore, e_wavs, ecfg) -> dict:
    """The key draw at full width (M1), the int4 embedder (M2), the
    retrieval CLIs at full width (M3), the Milvus import (M4), the phoneme
    evaluation (M5), the training gates (M6); the kernels' inputs recorded
    as path "M", M5's as "M5" and M6's as "M6"."""
    reset_counts()
    t0 = time.perf_counter()
    out = {}
    with inputs.watch("M"):
        out["m1"] = path_m1(ecfg, pi_rag)
        print("M1 key draw", json.dumps(out["m1"]), flush=True)
        out["m2"] = path_m2(ecfg)
        print("M2 int4 embedder", json.dumps(out["m2"]), flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            out["m3"] = path_m3(Path(tmp), store)
        print("M3 retrieval clis", json.dumps(out["m3"]), flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            out["m4"] = path_m4(Path(tmp))
        print("M4 milvus import", json.dumps(out["m4"]), flush=True)
    with inputs.watch("M5"):
        out["m5"] = path_m5(e_wavs)
    print("M5 phoneme eval", json.dumps(out["m5"]), flush=True)
    with inputs.watch("M6"):
        out["m6"] = path_m6()
    print("M6 training gates", json.dumps(out["m6"]), flush=True)
    launches = read_counts()
    for name in ("flash_attention", "fused_log_mel"):
        check(launches[name] > 0, f"path M never launched {name}: {launches}")
    return dict(out, launches=launches, wall_s=time.perf_counter() - t0)


# ----------------------------------------------------------------------------- path N: the device mesh

# every step's masked logits of the mesh LM, teacher-forced on one device's tokens, against one device's:
# the worst reading 0.0734 at dp 2 x tp 2 and 0.0606 at 1 x 1 (about 2 bf16 ulps of the largest |logit|, 4.5-5.0)
MESH_LOGIT_ATOL = 0.1
MESH_WAV_ATOL = 2e-2   # wavs from the same tokens: the bf16 CFM trunk's partial products summed in another order
N_MAX_SECONDS = 2.5    # path N's requests: a 64-token generation bucket (ranks sharing the card go slowly)


def rank_counts(fn, mesh):
    """Run ``fn`` under a span, with the kernels' counts set to 0 -> (its
    result, the counts, the collectives' calls and host ms: the counters
    of the spans that closed meanwhile, each collective counted on its
    innermost span)."""
    reset_counts()
    t0 = time.perf_counter()
    with Stopwatch(mesh.device).open("rank"):
        out = fn()
    torch.cuda.synchronize()
    done = [s for s in timing.spans() if s.t0 >= t0]
    return out, read_counts(), {"calls": sum(s.counters.get("collectives", 0) for s in done),
                                "ms": sum(s.counters.get("collective_ms", 0.0) for s in done)}


def greedy_mesh_tokens(eng: Engine, feats, max_new: int = 64):
    """Greedy tokens of the TEXTS batch on ``feats`` (the scanned decode,
    int8 KV cache), through the engine's own row split and gather; the
    masked logits of each step are what ``token_lm.sample`` sees."""
    B = len(TEXTS)
    rows = eng._rows(B)
    with eng._on_mesh():
        ids, _ = eng._lm_inputs(TEXTS, [""] * B, feats, N_MAX_SECONDS, rows)
        spk = eng._tensor(np.stack([f.spk for f in feats])[rows], torch.float32)
        gen = token_lm.generate_speech_from_ids(eng.params.token_lm, eng.cfg.token_lm, *ids, spk, None,
                                                max_new_tokens=max_new, sampler=SamplerConfig.label(),
                                                kv_int8=True)
        return eng._gather(gen.tokens, rows, B).cpu().numpy()


def tokens_reqs(tokens: np.ndarray, feats, eos: int):
    reqs = []
    for row, f in zip(tokens, feats):
        n = int(np.argmax(row == eos)) if (row == eos).any() else len(row)
        reqs.append({"tokens": row[: max(n, 1)], "flow_feat": f})
    return reqs


def from_tokens_noise(cfg: Config, reqs, seed: int = 7) -> np.ndarray:
    """The CFM's initial noise for ``synthesize_from_tokens(reqs)``, drawn
    once so that every engine renders from the same draw."""
    from autostyle_tts_tpu_torch.pipeline.engine import GEN_BUCKETS, TOKEN_BUCKETS, _bucket

    fp_w = _bucket(max(len(r["flow_feat"].tokens) for r in reqs), TOKEN_BUCKETS)
    max_new = _bucket(max(len(r["tokens"]) for r in reqs), GEN_BUCKETS)
    shape = (len(reqs), (fp_w + max_new) * cfg.cfm.upsample, cfg.cfm.n_mels)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def forced_mesh_logits(eng: Engine, feats, tokens: np.ndarray):
    """The decode of ``greedy_mesh_tokens`` with each step's token forced
    to ``tokens`` (one device's greedy tokens): -> (this rank's rows, the
    masked logits the sampler saw at each step [rows, steps, V])."""
    rows = eng._rows(len(TEXTS))
    logits = []
    sample0 = token_lm.sample

    def forced(lg, sc, g, **kw):
        logits.append(lg.float().cpu())
        return torch.as_tensor(tokens[rows, len(logits) - 1], dtype=torch.int32, device=lg.device)

    token_lm.sample = forced
    try:
        greedy_mesh_tokens(eng, feats)
    finally:
        token_lm.sample = sample0
    return rows, torch.stack(logits, 1).numpy()


def check_mesh_logits(rows: slice, got: np.ndarray, ref: dict, what: str):
    """Every step of every row of this rank: the same entries masked as one
    device's, the others within MESH_LOGIT_ATOL of its logits (the
    contexts are equal, so only sums in another order part them) -> (the
    readings, each step's worst error [rows, steps])."""
    want = ref["logits"][rows]
    check(got.shape[1] <= want.shape[1], f"{what}: {got.shape[1]} steps, one device took {want.shape[1]}")
    want = want[:, : got.shape[1]]
    live = want > -1e29
    check(bool(np.array_equal(live, got > -1e29)), f"{what}: the masked entries differ from one device's")
    err = np.where(live, np.abs(np.where(live, got, 0) - np.where(live, want, 0)), 0).max(axis=2)
    scale = np.where(live, np.abs(want), 0).max(axis=2)
    per_row = [dict(row=rows.start + j, steps=int(got.shape[1]), max_abs_err=float(err[j].max()),
                    at_step=int(err[j].argmax()), max_rel_err=float((err[j] / scale[j]).max()))
               for j in range(err.shape[0])]
    worst = float(err.max())
    check(worst <= MESH_LOGIT_ATOL, f"{what}: logits {worst} from one device's > {MESH_LOGIT_ATOL}")
    return dict(rows=per_row, max_abs_err=worst, max_logit=float(scale.max()), atol=MESH_LOGIT_ATOL), err


def check_mesh_tokens(got: np.ndarray, ref: dict, rows: slice, err: np.ndarray, what: str) -> dict:
    """Each row equal to one device's greedy tokens, or parting first at a
    step i where one device's two candidates lie within twice the
    teacher-forced logits' error at that step (``err``, this rank's rows;
    another rank's rows are its to check): up to step i the contexts are
    equal, so the free run's logits there are the forced run's, and an
    argmax can move only inside twice their error."""
    parted = []
    for b in range(got.shape[0]):
        diff = np.flatnonzero(got[b] != ref["tokens"][b])
        if diff.size:
            i = int(diff[0])
            lg = ref["logits"][b, i]
            gap = float(abs(lg[int(ref["tokens"][b, i])] - lg[int(got[b, i])]))
            parted.append(dict(row=b, step=i, gap=gap))
            if rows.start <= b < rows.stop:
                bound = 2 * float(err[b - rows.start, i])
                parted[-1]["bound"] = bound
                check(gap <= bound, f"{what}: row {b} parts from one device's greedy tokens at step {i}, "
                                    f"logit gap {gap} > {bound}, twice the forced logits' error there")
    return dict(rows_equal=got.shape[0] - len(parted), parted=parted)


def mesh_reference(cfg: Config, feats_db) -> dict:
    """One device's engine at the same seed (scanned decode): the greedy
    tokens with each step's masked logits, and the wavs it renders from
    them on a fixed noise."""
    eng = Engine(cfg, seed=0)
    logits = []
    sample0 = token_lm.sample
    token_lm.sample = lambda lg, sc, g, **kw: logits.append(lg.float().cpu()) or sample0(lg, sc, g, **kw)
    try:
        tokens = greedy_mesh_tokens(eng, feats_db)
    finally:
        token_lm.sample = sample0
    reqs = tokens_reqs(tokens, feats_db, cfg.token_lm.speech_eos)
    noise = from_tokens_noise(cfg, reqs)
    wavs = eng.synthesize_from_tokens(reqs, cfm_noise=noise)
    del eng
    torch.cuda.empty_cache()
    return dict(tokens=tokens, logits=torch.stack(logits, 1).numpy(), reqs=reqs, noise=noise, wavs=wavs)


def check_mesh_wavs(got, want, what: str) -> float:
    err = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"{what}: wav shape {g.shape} != one device's {w.shape}")
        err = max(err, float(np.abs(g - w).max()))
    check(err <= MESH_WAV_ATOL, f"{what}: wavs {err} from one device's > {MESH_WAV_ATOL}")
    return err


def path_n_engine_rank(data: int, model: int, backend: str, feats_db, wav_pairs, ref: dict,
                       dcp_dir=None) -> dict:
    """One rank of N1 (dp 2 x tp 2, gloo, ranks sharing the card) or N2
    (1 x 1, NCCL): the flagship engine on the mesh serves the TEXTS batch
    DB-served and from wavs (timed: wall, requests/s, collectives' ms),
    every step's logits teacher-forced on one device's tokens, its greedy
    tokens and its wavs from given tokens are held to one device's
    (``ref``), and the flash / log-mel kernels against their plain
    versions on the rank's own inputs; with ``dcp_dir`` also N0's
    collectives and N4's dcp round trip."""
    mesh = make_mesh(data, model, device="cuda", backend=backend)
    cfg = serving_config()
    t0 = time.perf_counter()
    eng = Engine(cfg, seed=0, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    inputs = PathInputs()
    out = dict(mesh=mesh.shape, rank=mesh.rank, backend=backend, init_s=init_s,
               engine_gb=torch.cuda.memory_allocated() / 1e9)

    def serve():
        rec = {}
        for kind, sty, tim in (("db_served", feats_db, feats_db), ("wav_prompts", *wav_pairs)):
            t = time.perf_counter()
            wavs = eng.synthesize_batch(TEXTS, [""] * len(TEXTS), sty, tim, max_seconds=N_MAX_SECONDS)
            wall = time.perf_counter() - t
            for w in wavs:
                check(w.size > 0 and bool(np.isfinite(w).all()), f"N {kind}: a wav is empty or not finite")
            rec[kind] = dict(wall_ms=wall * 1e3, requests_per_s=len(wavs) / wall, gen_lens=eng.last_gen_lens,
                             audio_s=[w.size / cfg.audio.sample_rate for w in wavs])
        return rec

    with inputs.watch("N"):
        (out["serve"], out["launches"], out["collectives"]) = rank_counts(serve, mesh)
        rows, forced = forced_mesh_logits(eng, feats_db, ref["tokens"])
        out["forced"], err = check_mesh_logits(rows, forced, ref, "N forced")
        out["greedy"] = check_mesh_tokens(greedy_mesh_tokens(eng, feats_db), ref, rows, err, "N greedy")
        wavs = eng.synthesize_from_tokens(ref["reqs"], cfm_noise=ref["noise"])
        out["from_tokens_max_abs_err"] = check_mesh_wavs(wavs, ref["wavs"], "N from tokens")
    for name in ("flash_attention", "fused_log_mel"):
        check(out["launches"][name] > 0, f"N rank {mesh.rank}: {name} never launched: {out['launches']}")
    out["kernels"] = inputs.replay()
    if dcp_dir is not None:
        out["collective_checks"] = collective_checks(mesh)
        out["dcp"] = dcp_round_trip(mesh, dcp_dir)
    if backend == "nccl":
        x = torch.full((4,), 3.0, device=mesh.device)
        torch.distributed.all_reduce(x)
        check(bool((x == 3.0).all()), "N2: NCCL all_reduce at world size 1")
        out["nccl_world"] = torch.distributed.get_world_size()
    return out


def collective_checks(mesh) -> dict:
    """N0: all_reduce, all_gather and broadcast of CUDA tensors over the
    world's gloo group, the ranks sharing the card."""
    dist = torch.distributed
    n, r = dist.get_world_size(), dist.get_rank()
    x = torch.full((1024,), float(r + 1), device=mesh.device)
    dist.all_reduce(x)
    check(bool((x == n * (n + 1) / 2).all()), "N0: gloo all_reduce of a CUDA tensor")
    parts = [torch.empty(3, device=mesh.device) for _ in range(n)]
    dist.all_gather(parts, torch.arange(3, device=mesh.device, dtype=torch.float32) + 10 * r)
    check(all(bool((p == torch.arange(3, device=mesh.device) + 10 * i).all()) for i, p in enumerate(parts)),
          "N0: gloo all_gather of CUDA tensors")
    y = torch.full((5,), float(r), device=mesh.device)
    dist.broadcast(y, src=n - 1)
    check(bool((y == n - 1).all()), "N0: gloo broadcast of a CUDA tensor")
    return dict(world=n, backend=dist.get_backend(), all_reduce=True, all_gather=True, broadcast=True)


def path_n3_rank(tokens: np.ndarray) -> dict:
    """N3: the 3B int8 embedder drawn from ``PRNGKey(42)`` on each rank,
    cut for tp 2 (heads 24:8 -> 12:4 a rank); rank 0 embeds the batch
    unsharded first; the embed on the mesh against it."""
    mesh = make_mesh(1, 2, device="cuda", backend="gloo")
    ecfg = Config().embedder
    t0 = time.perf_counter()
    base = transformer.init_params_quantized(ecfg, rng.PRNGKey(42, mesh.device), bits=8)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    toks = torch.as_tensor(tokens, device=mesh.device)
    mask = torch.ones_like(toks)
    ref = None
    if mesh.rank == 0:
        with torch.no_grad():
            ref = transformer.embed_text(base, ecfg, toks, mask)
    local = shard_params(mesh, base, (ecfg.n_heads, ecfg.n_kv_heads))
    del base
    torch.cuda.empty_cache()
    inputs = PathInputs()

    def embed():
        with torch.no_grad(), mesh:
            t = time.perf_counter()
            e = transformer.embed_text(local, ecfg, toks, mask)
            torch.cuda.synchronize()
            return e, (time.perf_counter() - t) * 1e3

    with inputs.watch("N3"):
        embed()     # the first call pays cuBLAS set-up
        (got, ms), launches, coll = rank_counts(embed, mesh)
    check(launches["flash_attention"] == ecfg.n_layers, f"N3: flash launched {launches['flash_attention']} times")
    out = dict(rank=mesh.rank, draw_s=draw_s, local_gb=tree_gb(local), embed_ms=ms, launches=launches,
               collectives=coll, kernels=inputs.replay(),
               local_heads=list(transformer.local_heads(local, ecfg)))
    if ref is not None:
        err = float((got - ref).abs().max())
        out.update(max_abs_err=err, ref_max=float(ref.abs().max()))
        check(err <= DECODE_RTOL * out["ref_max"], f"N3: tp 2 embed {err} from the unsharded > "
                                                    f"{DECODE_RTOL} x max |embed| {out['ref_max']}")
    return out


def dcp_round_trip(mesh, tmp: str) -> dict:
    """N4: an SFT LoRA at the 3B width (2 layers) and its optimizer state
    saved through ``dcp`` at ``mesh``'s tp 2, restored at tp 1, tp 2 (each
    rank reading its own pieces) and tp 4, on the card."""
    from autostyle_tts_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = dataclasses.replace(Config().embedder, n_layers=2)
    heads = (cfg.n_heads, cfg.n_kv_heads)
    lora = transformer.init_lora(cfg, 8, rng.PRNGKey(1, mesh.device))
    opt = lora_sft.make_optimizer(lora_sft.TrainConfig(), 10)
    state = {"lora": shard_params(mesh, lora, heads)}
    state["opt_state"] = opt.init(state["lora"])
    like = {"lora": abstract(lora), "opt_state": abstract(opt.init(abstract(lora)))}
    mgr = CheckpointManager(tmp, backend="dcp")
    t0 = time.perf_counter()
    with mesh:
        mgr.save(1, state, like=like, heads=heads)
    save_s = time.perf_counter() - t0
    full = gather_params(mesh, state, like, heads)
    out = dict(save_s=save_s)
    for name, (d, m) in (("tp1", (4, 1)), ("tp2", (2, 2)), ("tp4", (1, 4))):
        target = make_mesh(d, m, device="cuda", backend="gloo")
        want = shard_params(target, full, heads)
        with target:
            got = mgr.restore(tree_map(torch.zeros_like, want), heads=heads)
        same = all(bool(torch.equal(a, b)) for a, b in zip(_flat_keys(got).values(), _flat_keys(want).values()))
        check(same, f"N4: the dcp checkpoint saved at tp 2 restored at {name} differs")
        out[f"restore_{name}"] = same
    return out


def path_n(store_feats, wavs) -> dict:
    """The device mesh on the card: N0 gloo collectives of CUDA tensors
    among 4 ranks sharing it and NCCL at world size 1; N1 the flagship
    engine at dp 2 x tp 2 (4 ranks, gloo); N2 a 1 x 1 NCCL mesh engine;
    N3 the 3B int8 embedder at tp 2; N4 both dry runs and the dcp round
    trip. Each rank counts its own launches (one kernel launch a call, the
    main path's runs only) and holds the kernels against their plain
    versions on its inputs; a rank that fails fails the run."""
    t0 = time.perf_counter()
    cfg = serving_config()
    ref = mesh_reference(cfg, store_feats)
    pairs = (wavs[:4], wavs[4:8])
    engine_keys = ("rank", "mesh", "backend", "init_s", "engine_gb", "serve", "collectives", "forced", "greedy",
                   "from_tokens_max_abs_err", "launches")
    with tempfile.TemporaryDirectory() as tmp:
        n1 = launch(path_n_engine_rank, 4, 2, 2, "gloo", store_feats, pairs, ref, tmp, backend="gloo",
                    threads=2, join_s=400)
    print("N1 mesh engine dp2 tp2", json.dumps([{k: r[k] for k in engine_keys} for r in n1]), flush=True)
    n2 = launch(path_n_engine_rank, 1, 1, 1, "nccl", store_feats, pairs, ref, backend="nccl", threads=4,
                join_s=300)
    print("N2 mesh engine 1x1 nccl", json.dumps([{k: r[k] for k in engine_keys} for r in n2]), flush=True)
    print("N0 mesh backends", json.dumps(dict(gloo_cuda=n1[0]["collective_checks"], nccl_world=n2[0]["nccl_world"])),
          flush=True)
    toks = np.random.default_rng(11).integers(0, Config().embedder.vocab_size, (4, 512)).astype(np.int64)
    n3 = launch(path_n3_rank, 2, toks, backend="gloo", threads=4, join_s=300)
    print("N3 mesh embedder tp2", json.dumps([{k: v for k, v in r.items() if k != "kernels"} for r in n3]),
          flush=True)
    t4 = time.perf_counter()
    dry_engine = dryrun_engine(4, device="cuda")
    dry_train = lora_sft.dryrun_train_step(4, device="cuda")
    n4 = dict(dryrun_engine=dry_engine, dryrun_train_step=dry_train, dcp=n1[0]["dcp"], s=time.perf_counter() - t4)
    print("N4 dry runs and dcp", json.dumps(n4), flush=True)
    launches = {name: sum(r["launches"][name] for r in (*n1, *n2, *n3)) for name in ("flash_attention",
                                                                                     "fused_log_mel")}
    per_rank = [dict(path=p, rank=r["rank"], **{k: [dict(shape=x["shape"], max_abs_err=x["max_abs_err"])
                                                       for x in v] for k, v in r["kernels"].items()})
                for p, runs in (("N1", n1), ("N2", n2), ("N3", n3)) for r in runs]
    print("kernels path N", json.dumps(dict(launches=launches, per_rank=per_rank)), flush=True)
    return dict(n1=n1, n2=n2, n3=n3, n4=n4, launches=launches, wall_s=time.perf_counter() - t0)


def path_n_worst(pn: dict, name: str) -> list:
    return [x for runs in (pn["n1"], pn["n2"], pn["n3"]) for r in runs for x in r["kernels"][name]]


def serving_config() -> Config:
    """The flagship widths at the serving point: int8 LM, int8 KV cache (as
    served: the scanned decode of a batch uses it, the B=1 decode kernel
    keeps its bf16 cache), a 2-step guidance-free CFM."""
    cfg = Config()
    cfg.quantize_lm_int8 = True
    cfg.quantize_lm_kv_int8 = True
    cfg.cfm = CFMConfig(n_steps=2, use_cfg=False)
    return cfg


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)

    only_log_mel = "--log-mel-only" in sys.argv[1:]
    only_mesh = "--mesh-only" in sys.argv[1:]
    only_decode = "--decode-only" in sys.argv[1:]
    sources = ("log_mel",) if only_log_mel else ("decode_step",) if only_decode else cuda_build.KERNEL_SOURCES
    t0 = time.perf_counter()
    built = cuda_build.build(sources)
    print(f"build: {time.perf_counter() - t0:.1f} s {json.dumps(built)}", flush=True)
    for name in sources:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"ptxas {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(1234)
    cfg = serving_config()
    n_wavs = [synthetic_wav(20 + i) for i in range(8)]
    if only_mesh:
        feats = Engine(cfg, seed=0).prompt_features([synthetic_wav(i) for i in range(4)])
        path_n(feats, n_wavs)
        print("chip_smoke: --mesh-only, the other phases and the main paths were not run")
        return 0
    if only_log_mel:
        print("log_mel 24k, worst error of the four checked cases", json.dumps(log_mel_phase(cfg, gen)))
        print("chip_smoke: --log-mel-only, the other phases and the main paths were not run")
        return 0
    if only_decode:
        skip_draws_before_decode(cfg, gen)
        print("decode phases", json.dumps(decode_phase(cfg, gen)[-1]), flush=True)
        print("chip_smoke: --decode-only, the other phases and the main paths were not run")
        return 0
    tl = cfg.token_lm
    flash_main = flash_case(1, 256, tl.n_heads, tl.n_kv_heads, tl.head_dim, [62], gen)
    flash_gqa = flash_case(2, 256, tl.n_heads, 4, tl.head_dim, [0, 101], gen)
    emb = cfg.embedder     # the reference's kernel also serves the embedder trunk, at hd = 128
    flash_128 = flash_case(1, 256, emb.n_heads, emb.n_kv_heads, emb.head_dim, [62],
                           torch.Generator(device="cuda").manual_seed(1235))
    for name, r in (("prefill", flash_main), ("gqa", flash_gqa), ("embedder hd128", flash_128)):
        print(f"flash {name}", json.dumps(r), flush=True)
        check(r["max_abs_err"] <= FLASH_ATOL, f"flash {name}: err {r['max_abs_err']} > {FLASH_ATOL}")
    mel24 = log_mel_phase(cfg, gen)
    dec, dec4, attn_rec, mlp_rec, phases = decode_phase(cfg, gen)
    print("decode phases", json.dumps(dict(
        phases, flash_blocks=flash_main["blocks"], flash_ms=flash_main["ms"],
        flash_library_ms=flash_main["library_ms"])), flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    inputs = PathInputs()
    with inputs.watch("A"):
        eng, store, pa = path_a(cfg, gen)
    print("path A", json.dumps({k: v for k, v in pa.items() if k != "requests"}), flush=True)
    pb = path_b(eng, store, cfg, gen)
    print("path B", json.dumps(pb), flush=True)
    pc = path_c(cfg, store)
    print("path C", json.dumps({k: v for k, v in pc.items() if k != "requests"}), flush=True)
    with inputs.watch("D"):
        pd = path_d(eng, store, cfg)
    print("path D", json.dumps(pd), flush=True)
    with inputs.watch("E"):
        pe = path_e()
    print("path E", json.dumps({k: pe[k] for k in ("round_trip", "launches")}), flush=True)
    pf = path_f(torch.Generator(device="cuda").manual_seed(4322))
    print("path F hifigan", json.dumps(pf), flush=True)
    with inputs.watch("G"):
        pg = path_g(eng, store, cfg)
    print("path G", json.dumps({"launches": pg["launches"]}), flush=True)
    with inputs.watch("H"):
        ph = path_h(eng, store, cfg)
    print("path H", json.dumps({"launches": ph["launches"]}), flush=True)
    with inputs.watch("I"):
        pi = path_i(eng, cfg)
    print("path I", json.dumps({"launches": pi["launches"]}), flush=True)
    with inputs.watch("J"):
        pj = path_j(eng, store, cfg)
    print("path J", json.dumps({k: pj[k] for k in ("launches", "wall_s")}), flush=True)
    # outside the path's counts and recorded inputs; frees path I's embedder
    print("profile embedder", json.dumps(profile_embedder(pi.pop("embedder"))), flush=True)
    torch.cuda.empty_cache()
    with inputs.watch("K"):
        pk = path_k()
    print("compat", json.dumps(dict(convert=pk["convert"], **pk["serve"])), flush=True)
    print("hf embedder", json.dumps(pk["hf"]), flush=True)
    print("path K", json.dumps({k: pk[k] for k in ("launches", "compat_s", "wall_s")}), flush=True)
    with inputs.watch("L"):
        pl = path_l()
    print("path L", json.dumps(dict({k: pl[k] for k in ("launches", "l1_s", "l2_s", "wall_s")},
                                    **{k: pl["l1"][k] for k in ("corpus_s", "featurize_s")})), flush=True)
    pm = path_m(inputs, pi["rag"], pi.pop("store"), pe.pop("wavs"), cfg.embedder)
    print("path M", json.dumps({k: pm[k] for k in ("launches", "wall_s")}), flush=True)
    torch.cuda.empty_cache()
    pn = path_n(eng.prompt_features_from_store(store, [0, 1, 2, 3]), n_wavs)
    print("path N", json.dumps({k: pn[k] for k in ("launches", "wall_s")}), flush=True)
    admitted = sorted({shape[0] for (path, shape, _) in inputs.flash if path == "H" and shape[1] == 384})
    check(admitted == [1, 2, 4], f"path H's admissions prefilled B = {admitted} at T = 384, expected 1, 2 and 4")
    on_inputs = inputs.replay()
    print("kernels on the paths' inputs", json.dumps(on_inputs), flush=True)
    flash_batch = flash_measure(*inputs.batch_flash())
    print("flash batch (path D's prefill inputs)", json.dumps(flash_batch), flush=True)
    flash_admit = {shape[0]: flash_measure(*t) for (path, shape, _), t in inputs.flash.items() if path == "H"}
    for b, r in sorted(flash_admit.items()):
        print(f"flash admission B={b} (path H's prefill inputs)", json.dumps(r), flush=True)
    # the embedder's shapes on path I (hd = 128): embeds, biography and label prefills
    flash_rag = [flash_measure(*t) for (path, shape, _), t in inputs.flash.items() if path == "I" and shape[3] == 128]
    check(len(flash_rag) == 4, f"path I gave flash {len(flash_rag)} geometries at hd = 128, expected 4")
    for r in flash_rag:
        print("flash embedder B={} T={} (path I's inputs)".format(*r["shape"][:2]), json.dumps(r), flush=True)
    pi["rag"]["flash"] = [{k: r[k] for k in ("shape", "ms", "bound_ms", "bound_by", "library_ms", "plain_ms",
                                             "max_abs_err")} for r in flash_rag]
    print("rag", json.dumps(pi["rag"]), flush=True)
    # path K's new geometries: flash on the dense 3B embedder loaded from Hugging Face key names
    # (the embed and the left-padded prefill), the log-mel at the S3 tokenizer's 128 mels
    flash_k = [flash_measure(*t) for (path, shape, _), t in inputs.flash.items() if path == "K" and shape[3] == 128]
    check(len(flash_k) == 2, f"path K gave flash {len(flash_k)} geometries at hd = 128, expected 2")
    for r in flash_k:
        print("flash hf embedder B={} T={} (path K's inputs)".format(*r["shape"][:2]), json.dumps(r), flush=True)
    mel_k = [log_mel_measure(*t) for (path, shape, _, _), t in inputs.mel.items() if path == "K"]
    check(len(mel_k) == 1 and mel_k[0]["shape"][-1] == COSYVOICE_300M.s3_mels,
          f"path K gave the log-mel {[r['shape'] for r in mel_k]}, expected one geometry at 128 mels")
    print("log_mel 16k 128 mels (path K's inputs)", json.dumps(mel_k[0]), flush=True)
    # path L's new geometries: flash in the SFT eval's prefill (B = 8, P = 768, hd = 128), the log-mel on the
    # flagship featurization of the training batches and the tokenizer stage's input mel
    flash_l = [flash_measure(*t) for (path, shape, _), t in inputs.flash.items() if path == "L" and shape[3] == 128]
    check([r["shape"][:2] for r in flash_l] == [[8, 768]], f"path L gave flash {[r['shape'] for r in flash_l]} "
                                                           "at hd = 128, expected B = 8, P = 768")
    print("flash sft eval B=8 P=768 (path L's inputs)", json.dumps(flash_l[0]), flush=True)
    # of each flagship leg (win 400 at 16 kHz, 1024 at 24 kHz) the geometry with the most frames
    legs = {}
    for (path, shape, _, _), t in inputs.mel.items():
        if path == "L" and shape[2] >= 400 and shape[0] * shape[1] > legs.get(shape[2], (0,))[0]:
            legs[shape[2]] = (shape[0] * shape[1], t)
    check(sorted(legs) == [400, 1024], f"path L gave the log-mel at windows {sorted(legs)}, expected 400 and 1024")
    mel_l = [log_mel_measure(*t) for _, t in legs.values()]
    for r in mel_l:
        print("log_mel train B={} T={} win={} (path L's inputs)".format(*r["shape"][:3]), json.dumps(r), flush=True)
    # path M's new geometries: flash in the int4 embedder's embed and biography prefill and in the
    # llm_bio_extract batch (hd = 128), the log-mel on the phoneme recognizer's buckets (M5)
    flash_m = [flash_measure(*t) for (path, shape, _), t in inputs.flash.items() if path == "M" and shape[3] == 128]
    check(sorted(r["shape"][:2] for r in flash_m) == [[2, 1024], [4, 1024], [16, 512]],
          f"path M gave flash {[r['shape'] for r in flash_m]} at hd = 128, expected B=16 T=512, B=2 and B=4 at 1024")
    for r in flash_m:
        print("flash path M B={} T={} (M2/M3's inputs)".format(*r["shape"][:2]), json.dumps(r), flush=True)
    mel_m = [log_mel_measure(*t) for (path, shape, _, _), t in inputs.mel.items() if path == "M5"]
    check(len(mel_m) > 0, "M5 gave the log-mel no input")
    for r in mel_m:
        print("log_mel recognizer B={} T={} win={} (M5's inputs)".format(*r["shape"][:3]), json.dumps(r), flush=True)
    del inputs
    print("profile db_served", json.dumps(profile_request(
        eng, *eng.prompt_features_from_store(store, [0, 1]))), flush=True)
    print("profile raw_wavs", json.dumps(profile_request(eng, synthetic_wav(7), synthetic_wav(8))), flush=True)
    spec_eng = pj.pop("spec_engine")
    print("profile speculative (J4's engine)", json.dumps(profile_speculative(spec_eng, store)), flush=True)
    del spec_eng
    print("featurize warm", json.dumps(featurize_warm(eng)), flush=True)
    print("profile batch", json.dumps(profile_batch(eng, store)), flush=True)
    step8 = [r["decode_ms_per_step"] for r in pa["requests"][1:4]]
    step4 = [r["decode_ms_per_step"] for r in pc["requests"]]
    print("int4 vs int8", json.dumps(dict(
        engine_gb_int8=pa["engine_gb"], engine_gb_int4=pc["engine_gb"],
        decode_ms_per_step_int8=step8, decode_ms_per_step_int4=step4,
        kernel_ms_int8=phases["ms_in_turns_int8"], kernel_ms_int4=phases["ms_in_turns_int4"])), flush=True)

    def entry(name, source, replaces, launches, rec):
        return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                    **{k: rec[k] for k in KERNEL_KEYS})

    jax_decode = "autostyle_tts_tpu/ops/pallas_decode.py"
    # launches on every path that runs the kernel: flash on A, C, D, E, G, H, I, J, K, L, M, N; log-mel on A, D,
    # E, G, I, J, K, L, M, N (N: summed over its ranks); the decode step on A, G, J; its int4 build on C, G (the
    # other paths add 0)
    on_paths = lambda name: sum(p["launches"].get(name, 0) for p in (pa, pc, pd, pe, pg, ph, pi, pj, pk, pl, pm, pn))
    # max_abs_err: the largest of every case checked (phase 3 and the paths' own inputs)
    worst = lambda name, recs: max(r["max_abs_err"] for r in (*recs, *on_inputs[name]))
    flash_rec = dict(flash_main, max_abs_err=worst("flash_attention", (flash_main, flash_gqa, flash_128, flash_batch,
                                                                       *flash_admit.values(), *flash_rag, *flash_k,
                                                                       *flash_l, *flash_m,
                                                                       *path_n_worst(pn, "flash_attention"))))
    mel_rec = dict(mel24, max_abs_err=worst("fused_log_mel", (mel24, *mel_k, *mel_l, *mel_m,
                                                              *path_n_worst(pn, "fused_log_mel"))))
    kernels = [
        entry("flash_attention", FLASH_SRC, "autostyle_tts_tpu/ops/pallas_attn.py:76",
              on_paths("flash_attention"), flash_rec),
        entry("attn_step", DECODE_SRC, f"{jax_decode}:190", pb["launches"]["attn_step"], attn_rec),
        entry("mlp_step", DECODE_SRC, f"{jax_decode}:299", pb["launches"]["mlp_step"], mlp_rec),
        entry("mega_decode_step", DECODE_SRC, f"{jax_decode}:701", on_paths("mega_decode_step"), dec),
        entry("mega_decode_step_int4", DECODE_SRC, f"{jax_decode}:701", on_paths("mega_decode_step_int4"), dec4),
        entry("fused_log_mel", LOGMEL_SRC, "autostyle_tts_tpu/ops/pallas_mel.py:35",
              on_paths("fused_log_mel"), mel_rec),
    ]
    check(all(k["launches"] > 0 for k in kernels), f"a kernel never launched on its path: {kernels}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
