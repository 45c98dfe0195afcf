"""Time the B=1 decode step kernel (``csrc/decode_step.cu``) at the
flagship widths, int8 and int4, on a CUDA card; alone or against another
checkout of the repository on the same card:

    python3 scripts/time_decode_step.py [--against DIR]

DIR holds another checkout (for example the parent commit, unpacked with
``git archive`` into a gitignored directory such as ``_checkout/``). The
two packages share a name, so each checkout runs in a process of its own,
in turns: DIR, this checkout, this checkout, DIR. A run builds the kernel
from its checkout's sources, draws the flagship token LM (random int8
weights from a seed; the int4 ones made 4-bit exact, as ``chip_smoke.py``
makes them, then re-quantized) and times one decode state: slot 320 of
392, 220 live keys, top-k 25 sampling (``chip_smoke.py``'s timing state).
It prints one JSON line: ms a step by CUDA events (100 steps, int8 and
int4 in turns: 8, 4, 4, 8) and each width's phases from the kernel's own
stamps (``decode_scratch(..., stamps=True)``; means over 10 steps); the two
half-layers (``attn_step``, ``mlp_step``) at both widths, per call over
all 14 layers in turn (``chip_smoke.half_layer_times``: CUDA-event ms,
host enqueue and profiler device microseconds, kernels a call; public and,
where the checkout has them, planned calls, and their phases from the
kernels' stamps, ``chip_smoke.half_layer_laps``); and the per-layer decode
flavour's ms a token (``generate_speech_from_ids`` with per-layer decode
params, 32 tokens, top-k 25 sampling, three runs: chip_smoke.py's path B
on a bare LM). The weights, the timers and the phase split are
``chip_smoke.py``'s, from this checkout, for every checkout timed. The
card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def smoke():
    """This checkout's ``chip_smoke.py`` as a module, its imports resolved on
    ``sys.path`` (the checkout being timed): the one copy of the 4-bit-exact
    weights, the CUDA-event timer and the phase split that the full run's
    ``decode phases`` line uses."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from autostyle_tts_tpu_torch.models import token_lm
    from autostyle_tts_tpu_torch.ops import cuda_build, decode_step
    from autostyle_tts_tpu_torch.ops.sampling import SamplerConfig
    from autostyle_tts_tpu_torch.utils.config import Config
    from autostyle_tts_tpu_torch.utils.timing import Stopwatch
    from autostyle_tts_tpu_torch.weights import quantize_tree

    cs = smoke()
    cuda_build.build(("decode_step", "flash_attn"))
    dev = torch.device("cuda")
    tl = Config().token_lm
    gen = torch.Generator(device="cuda").manual_seed(1234)
    lm = quantize_tree(token_lm.init_params(tl, gen))
    mps = {8: token_lm.mega_decode_params(lm, tl, bits=8),
           4: token_lm.mega_decode_params(cs.four_bit_exact(lm), tl, bits=4)}
    lm = token_lm.share_decode_weights(lm, mps[8])   # the per-layer flavour's views of the int8 rows
    L, N, P, off, t = tl.n_layers, tl.dim, 256, 100, 320
    S = 392
    k = torch.zeros((L, S, N), dtype=torch.bfloat16, device=dev)
    k[:, off:P] = (torch.randn((L, P - off, N), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    v = k.clone()
    tin = torch.tensor([17], dtype=torch.int32, device=dev)
    kw = dict(n_heads=tl.n_heads, head_dim=tl.head_dim, eps=tl.norm_eps, pad_id=tl.speech_pad,
              bos_id=tl.speech_bos, eos_id=tl.speech_eos, greedy=False, temperature=1.0, top_k=25)

    def stepper(bits, stamps=False):
        sc = decode_step.decode_scratch(mps[bits], tl.n_heads, tl.head_dim, dev, stamps=stamps)
        return sc, lambda: decode_step.mega_decode_step(tin, mps[bits], k, v, t, off, False, 7, **kw, scratch=sc)

    steps = {bits: stepper(bits)[1] for bits in (8, 4)}
    ms = {8: 0.0, 4: 0.0}
    for bits in (8, 4, 4, 8):
        ms[bits] += 0.5 * cs.time_ms(steps[bits], 50)
    rec = dict(root=root, ms_int8=ms[8], ms_int4=ms[4])
    for bits in (8, 4):
        sc, fn = stepper(bits, stamps=True)
        rec[f"phases_int{bits}"] = cs.barrier_times(fn, sc["stamps"], L)
    for bits in (8, 4):
        rec[f"half_layers_int{bits}"] = cs.half_layer_times(tl, mps[bits], (k, v, t, off))
        if hasattr(decode_step, "plan_half_layers"):   # one kernel a half-layer, with stamps
            rec[f"half_layer_phases_int{bits}"] = cs.half_layer_laps(tl, mps[bits], (k, v, t, off))
    layers = token_lm.unstack_decode_params(lm, tl)
    text = torch.randint(16, 200, (1, 64), generator=gen, device=dev).to(torch.int32)
    sty = torch.randint(0, 4000, (1, 150), generator=gen, device=dev).to(torch.int32)
    spk = torch.randn((1, tl.spk_dim), generator=gen, device=dev)
    per_token = []
    for run in range(3):
        clock = Stopwatch(dev)
        out = token_lm.generate_speech_from_ids(
            lm, tl, text, torch.tensor([64], device=dev), sty, torch.tensor([150], device=dev), spk,
            torch.Generator(device="cuda").manual_seed(run), max_new_tokens=32, decode_params=layers,
            sampler=SamplerConfig(temperature=1.0, top_k=25), min_tokens=32, clock=clock)
        assert int(out.lengths[0]) == 32
        per_token.append(clock.ms["decode"] / 32)
    rec["per_layer_decode_ms_per_token"] = per_token
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another checkout, timed in turns with this one")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_decode_step: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed", flush=True)
    roots = [str(REPO)] if not args.against else [args.against, str(REPO), str(REPO), args.against]
    for root in roots:
        run = subprocess.run([sys.executable, __file__, "--child", root], timeout=900)
        if run.returncode != 0:
            return run.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
