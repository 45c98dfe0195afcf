"""Time the scanned decode's attention over one query (T = 1) in two
formulations, at the shapes of a flagship batch (B = 8, H = K = 16, hd 64),
on a CUDA card:

    python3 scripts/time_sdpa_decode.py

- ``one_query``: scores and output as batched products over the cache in
  its own ``[B, S, K, hd]`` layout, the masked softmax spelled out (max,
  exp, sum floored at 1e-30, division);
- ``general``: the formulation for any T (kv heads repeated, ``[B, H, T,
  S]`` logits, ``torch.softmax``).

Both take an int8 cache's scales (k's on the logits, v's on the
probabilities). For each: the largest difference between the two, device
ms per call (CUDA events) and host ms to enqueue a call, on a bf16 and an
int8 cache; then the whole scanned step of a B = 8 generation on the
flagship int8 LM (random weights, ``chip_smoke.serving_config``) with each
formulation in the transformer's decode attention, in turns (one_query,
general, general, one_query, after one untimed generation), ms per step
from the decode span. Prints one JSON line per measurement, the card's
name and power limit first.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

NEG_INF = -1e30


def one_query(q, k, v, mask, ks=None, vs=None):
    B, _, H, hd = q.shape
    K = k.shape[2]
    rep = H // K
    qf = q.float().reshape(B, K, rep, hd) * hd ** -0.5
    logits = torch.einsum("bkrd,bskd->bskr", qf, k.float())
    if ks is not None:
        logits = logits * ks[..., None]
    S = logits.shape[1]
    m = mask[:, :, 0, :]
    m = m[:, 0, :, None, None] if m.shape[1] == 1 else m.reshape(B, K, rep, S).permute(0, 3, 1, 2)
    logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    p = torch.exp(logits - logits.amax(dim=1, keepdim=True))
    denom = torch.clamp(p.sum(dim=1), min=1e-30)
    pv = p if vs is None else p * vs[..., None]
    out = torch.einsum("bskr,bskd->bkrd", pv, v.float()) / denom[..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)


def general(q, k, v, mask, ks=None, vs=None):
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * q.shape[-1] ** -0.5
    if ks is not None:
        logits = logits * ks.repeat_interleave(rep, dim=2).permute(0, 2, 1)[:, :, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    if vs is not None:
        probs = probs * vs.repeat_interleave(rep, dim=2).permute(0, 2, 1)[:, :, None, :]
    return torch.einsum("bhts,bshd->bthd", probs, v.float()).to(q.dtype)


FORMS = {"one_query": one_query, "general": general}


def main() -> int:
    import chip_smoke
    from autostyle_tts_tpu_torch.models import token_lm, transformer
    from autostyle_tts_tpu_torch.ops import attention, cuda_build
    from autostyle_tts_tpu_torch.pipeline.engine import Engine
    from autostyle_tts_tpu_torch.utils.timing import Stopwatch

    if not torch.cuda.is_available():
        print("time_sdpa_decode: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build(("flash_attn",))
    dev = torch.device("cuda")
    cfg = chip_smoke.serving_config()
    tl = cfg.token_lm
    B, S, H, K, hd = 8, 392, tl.n_heads, tl.n_kv_heads, tl.head_dim
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, 1, H, hd), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, S, K, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, K, hd), generator=gen, device=dev).to(torch.bfloat16)
    off = torch.randint(0, 120, (B,), generator=gen, device=dev)
    slot = torch.arange(S, device=dev)
    mask = ((slot[None, :] >= off[:, None]) & (slot[None, :] <= 300))[:, None, None, :]
    kq, ks = attention.quantize_kv(k)
    vq, vs = attention.quantize_kv(v)
    for cache, args in (("bf16", (q, k, v, mask)), ("int8", (q, kq, vq, mask, ks, vs))):
        a, b = one_query(*args), general(*args)
        rec = dict(cache=cache, shape=[B, S, H, K, hd], max_abs_diff=float((a.float() - b.float()).abs().max()))
        for name, fn in FORMS.items():
            rec[f"{name}_ms"] = chip_smoke.time_ms(lambda: fn(*args), 200)
            rec[f"{name}_host_ms"] = chip_smoke.time_host_ms(lambda: fn(*args), 200)
        print("sdpa call", json.dumps(rec), flush=True)

    eng = Engine(cfg, seed=0)
    rng = torch.Generator().manual_seed(1)
    text = torch.randint(16, tl.text_vocab_size, (B, 64), generator=rng).to(torch.int32).to(dev)
    text_len = torch.randint(20, 65, (B,), generator=rng).to(torch.int32).to(dev)
    sty = torch.randint(0, 4096, (B, 75), generator=rng).to(torch.int32).to(dev)
    sty_len = torch.randint(40, 76, (B,), generator=rng).to(torch.int32).to(dev)
    spk = torch.randn((B, tl.spk_dim), generator=rng).to(dev)
    saved = transformer.sdpa, transformer.sdpa_quant
    for kv_int8 in (True, False):
        token_lm.generate_speech_from_ids(eng.params.token_lm, tl, text, text_len, sty, sty_len, spk,
                                          eng.generator, max_new_tokens=128, kv_int8=kv_int8)
        per_step = {name: [] for name in FORMS}
        for name in ("one_query", "general", "general", "one_query"):
            fn = FORMS[name]
            transformer.sdpa = lambda q, k, v, mask: fn(q, k, v, mask)
            transformer.sdpa_quant = lambda q, kq, ks, vq, vs, mask: fn(q, kq, vq, mask, ks, vs)
            try:
                clock = Stopwatch(dev)
                out = token_lm.generate_speech_from_ids(
                    eng.params.token_lm, tl, text, text_len, sty, sty_len, spk, eng.generator,
                    max_new_tokens=128, kv_int8=kv_int8, clock=clock)
            finally:
                transformer.sdpa, transformer.sdpa_quant = saved
            per_step[name].append(clock.ms["decode"] / max(out.decode_steps, 1))
        print("scanned step", json.dumps(dict(B=B, kv_int8=kv_int8, ms_per_step=per_step)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
