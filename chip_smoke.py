#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card's name and power limit (nvidia-smi); no CUDA -> exit 2;
2. build the CUDA kernels from ``autostyle_tts_tpu_torch/csrc`` (nvcc,
   one process per source, in parallel);
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it, and time both (CUDA events), beside one
   library call where one computes the same function;
4. drive the main path: the flagship configuration with an int8 token LM,
   random weights from a seeded generator, a style DB of 6144-d rows with
   precomputed prompt artifacts, and 4 B=1 requests through
   ``Engine.inference_tts_with_st``; check every wav and read the kernels'
   launch counts;
5. print ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

Float32 matrix products and convolutions run in full f32 (TF32 off).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from autostyle_tts_tpu_torch.ops import cuda_build, decode_step, flash_attn
from autostyle_tts_tpu_torch.models import token_lm
from autostyle_tts_tpu_torch.pipeline.engine import Engine
from autostyle_tts_tpu_torch.retrieval.store import StyleStore
from autostyle_tts_tpu_torch.utils.config import CFMConfig, Config
from autostyle_tts_tpu_torch.weights import quantize_tree

# H100 SXM peaks (NVIDIA data sheet, dense): the least time a function can
# take is max(bytes / HBM rate, operations / peak rate of their type)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12

# tolerances of the kernel-vs-plain phases (both on the card, same inputs)
FLASH_ATOL = 2e-2     # bf16 output, |out| < 4: two bf16 ulps
DECODE_RTOL = 2e-2    # bf16 residual over 14 layers: a few ulps of max|h|
LOGIT_GAP = 5e-2      # the greedy token must agree where the top-2 gap is wider

FLASH_SRC = "autostyle_tts_tpu_torch/csrc/flash_attn.cu"
DECODE_SRC = "autostyle_tts_tpu_torch/csrc/decode_step.cu"


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


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------------- flash


def flash_case(B, T, H, K, hd, offsets, gen):
    dev = torch.device("cuda")
    q = torch.randn((B, T, H, hd), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, T, K, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, T, K, hd), generator=gen, device=dev).to(torch.bfloat16)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    got = flash_attn.flash_attention(q, k, v, off)
    want = flash_attn.flash_attention_plain(q, k, v, off)
    torch.cuda.synchronize()
    real = (torch.arange(T, device=dev)[None, :] >= off[:, None].long())[:, :, None, None]
    err = float(((got.float() - want.float()).abs() * real).max())
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
                bound_ms=b, bound_by=by, shape=[B, T, H, K, hd], offsets=list(offsets))


# ----------------------------------------------------------------------------- decode step


def decode_case(cfg: Config, steps: int, gen):
    """Teacher-forced decode steps on flagship int8 weights: the kernel and
    the plain step each advance their own copy of one cache."""
    dev = torch.device("cuda")
    tl = cfg.token_lm
    lm = quantize_tree(token_lm.init_params(tl, gen))
    mp = token_lm.mega_decode_params(lm, tl)
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
    h_err = cache_err = 0.0
    h_scale = 0.0
    checked = {"greedy": 0, "sampled": 0}
    for i, tok in enumerate(toks):
        t = P + i
        tin = torch.tensor([tok], dtype=torch.int32, device=dev)
        for mode, skw in (("greedy", dict(greedy=True)), ("sampled", sampled)):
            # each mode writes row t again from the same inputs
            hk, tk = decode_step.mega_decode_step(tin, mp, k_kern, v_kern, t, off, i < 2, 1000 + i, **kw, **skw)
            hp, tp = decode_step.mega_decode_step_plain(tin, mp, k_plain, v_plain, t, off, i < 2, 1000 + i, **kw, **skw)
            torch.cuda.synchronize()
            y = decode_step.sample_scores_plain(
                decode_step.head_logits_plain(hp, mp, tl.norm_eps), pad_id=tl.speech_pad,
                bos_id=tl.speech_bos, eos_id=tl.speech_eos, suppress=i < 2, seed=1000 + i,
                **{"greedy": True, "temperature": 1.0, "top_k": 0, **skw})
            top2 = torch.topk(y, 2).values
            if float(top2[0] - top2[1]) > LOGIT_GAP:
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
    check(checked["greedy"] >= steps // 2, f"too few decisive greedy steps: {checked}")

    t = P + 64   # mid-generation
    tin = torch.tensor([toks[0]], dtype=torch.int32, device=dev)
    scratch = decode_step.decode_scratch(mp, tl.n_heads, tl.head_dim, dev)   # as the decode loop holds it
    ms = time_ms(lambda: decode_step.mega_decode_step(tin, mp, k_kern, v_kern, t, off, False, 7,
                                                      **kw, **sampled, scratch=scratch), 50)
    plain_ms = time_ms(lambda: decode_step.mega_decode_step_plain(tin, mp, k_plain, v_plain, t, off, False, 7, **kw, **sampled), 5, warmup=1)
    w_int8 = L * (3 * N * D + D * N + 2 * F * D + D * F) + V * D
    scales = 4 * (L * (3 * N + D + 2 * F + D) + V) + 4 * (2 * L * D + D)
    n_keys = t - off
    cache_bytes = 2 * L * n_keys * N * 2 + 2 * L * N * 2
    nbytes = w_int8 + scales + D * 2 + cache_bytes + D * 2 + 4
    ops = 2 * w_int8 + 4 * L * N * (n_keys + 1)
    b, by = bound_ms(nbytes, ops, INT8_OP_PER_S)
    return dict(max_abs_err=max(h_err, cache_err), ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b, bound_by=by, steps=steps, decisive=checked, h_max=h_scale,
                bytes_per_step=nbytes, cache_slots=S, t=t)


# ----------------------------------------------------------------------------- main path


def build_store(cfg: Config, rows: int, gen) -> StyleStore:
    """A style DB whose rows carry precomputed prompt artifacts: 75 speech
    tokens (3 s), 150 x 80 prompt mel, a 192-d speaker embedding."""
    rng = np.random.default_rng(int(torch.randint(0, 2 ** 31, (1,), generator=gen, device="cuda")))
    store = StyleStore(dim=cfg.retrieval.dim, capacity=64)
    store.insert(rng.standard_normal((rows, cfg.retrieval.dim)).astype(np.float32),
                 [{"file_id": f"style_{i}", "text": f"This is style line number {i}."}
                  for i in range(rows)])
    n_tok, n_mel, M = 75, 150, cfg.cfm.n_mels
    store.artifacts = {
        "speech_tokens": rng.integers(0, 4096, (rows, n_tok)).astype(np.int32),
        "speech_token_lens": np.full((rows,), n_tok, np.int64),
        "prompt_mel": (rng.standard_normal((rows, n_mel, M)) - 4.0).astype(np.float32),
        "prompt_mel_lens": np.full((rows,), n_mel, np.int64),
        "spk": rng.standard_normal((rows, cfg.speaker.emb_dim)).astype(np.float32),
    }
    return store


TEXTS = [
    "The weather is lovely today, so we will walk to the park.",
    "Please read the next line with a little more energy.",
    "On March 3rd the train leaves at 10:45 from platform 2.",
    "I can't believe you finished the whole thing already!",
]


def main_path(cfg: Config, gen):
    dev = torch.device("cuda")
    mem0 = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    eng = Engine(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine_gb = (torch.cuda.memory_allocated(dev) - mem0) / 1e9   # weights the engine holds
    store = build_store(cfg, 4, gen)
    rng = np.random.default_rng(1)
    requests = []
    flash_attn.flash_attention.launches = 0
    decode_step.mega_decode_step.launches = 0
    for text in TEXTS:
        t0 = time.perf_counter()
        hits = store.search(rng.standard_normal((1, cfg.retrieval.dim)).astype(np.float32), k=2)[0]
        sty, tim = eng.prompt_features_from_store(store, [hits[0].index, hits[1].index])
        out = next(eng.inference_tts_with_st(text, hits[0].text, sty, tim, max_seconds=5))
        wav = out["tts_speech"]
        wall_ms = (time.perf_counter() - t0) * 1e3
        n = eng.last_gen_len
        tm = eng.last_timings
        check(wav.shape == (1, n * cfg.cfm.upsample * cfg.audio.hop_length),
              f"wav shape {wav.shape} != gen_len {n} x {cfg.cfm.upsample * cfg.audio.hop_length}")
        check(n > 0 and bool(np.isfinite(wav).all()), "wav empty or not finite")
        rms = float(np.sqrt(np.mean(wav.astype(np.float64) ** 2)))
        check(rms > 1e-4, f"wav is silent (rms {rms})")
        requests.append(dict(
            wall_ms=wall_ms, prefill_ms=tm["prefill"], decode_ms=tm["decode"],
            decode_steps=eng.last_decode_steps,
            decode_ms_per_step=tm["decode"] / max(eng.last_decode_steps, 1),
            cfm_ms=tm["cfm"], vocoder_ms=tm["vocoder"], gen_len=n,
            audio_s=wav.shape[1] / cfg.audio.sample_rate, rms=rms))
        print("request", json.dumps(requests[-1]), flush=True)
    launches = {"flash_attention": flash_attn.flash_attention.launches,
                "mega_decode_step": decode_step.mega_decode_step.launches}
    check(all(v > 0 for v in launches.values()), f"a kernel of the main path never launched: {launches}")
    return dict(init_s=init_s, engine_gb=engine_gb, requests=requests, launches=launches,
                peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                profile=profile_request(eng, store, cfg))


def profile_request(eng: Engine, store: StyleStore, cfg: Config):
    """One more request under torch.profiler: device time per kernel name
    and the device's idle share of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    sty, tim = eng.prompt_features_from_store(store, [0, 1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        next(eng.inference_tts_with_st(TEXTS[0], "style", sty, tim, max_seconds=5))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = evt.name.replace("(anonymous namespace)::", "").split("(")[0][:60]
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + evt.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return dict(
        wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
        device_idle_share=(1.0 - busy_us / wall_us) if busy_us else "not measured",
        decode_steps=eng.last_decode_steps,
        top_kernels=[dict(name=k, ms=us / 1e3, calls=n) for k, (us, n) in top])


def serving_config() -> Config:
    """The flagship widths at the serving point: int8 LM (the kv-int8 flag
    is set, as served, and ignored by the decode kernel's bf16 cache), a
    2-step guidance-free CFM."""
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

    t0 = time.perf_counter()
    built = cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s {json.dumps(built)}", flush=True)
    for name in cuda_build.KERNEL_SOURCES:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(1234)
    cfg = serving_config()
    tl = cfg.token_lm
    flash_main = flash_case(1, 256, tl.n_heads, tl.n_kv_heads, tl.head_dim, [62], gen)
    flash_gqa = flash_case(2, 256, tl.n_heads, 4, tl.head_dim, [0, 101], gen)
    for name, r in (("prefill", flash_main), ("gqa", flash_gqa)):
        print(f"flash {name}", json.dumps(r), flush=True)
        check(r["max_abs_err"] <= FLASH_ATOL, f"flash {name}: err {r['max_abs_err']} > {FLASH_ATOL}")
    dec = decode_case(cfg, 16, gen)
    print("decode", json.dumps(dec), flush=True)
    torch.cuda.reset_peak_memory_stats()

    e2e = main_path(cfg, gen)
    print("e2e", json.dumps({k: v for k, v in e2e.items() if k not in ("requests", "profile")}), flush=True)
    print("profile", json.dumps(e2e["profile"]), flush=True)

    kernels = [
        dict(name="flash_attention", route="cuda", source=FLASH_SRC,
             replaces="autostyle_tts_tpu/ops/pallas_attn.py:76",
             launches=e2e["launches"]["flash_attention"],
             **{k: flash_main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="mega_decode_step", route="cuda", source=DECODE_SRC,
             replaces="autostyle_tts_tpu/ops/pallas_decode.py:701",
             launches=e2e["launches"]["mega_decode_step"],
             **{k: dec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
