"""Random engine weights drawn from the seed, in the port's parameter tree.

The tree has the structure of the port's flat-key checkpoint layout
(``token_lm/layers/wqkv``, ``vocoder/blocks/0/conv/w``, ...): nested dicts
and lists of float32 tensors. Every leaf is drawn from one standard-normal
draw of a ``torch.Generator`` seeded with ``--seed`` on the run's device,
scaled to fan-in (std ``1 / sqrt(fan_in)``); norm scales are ones and norm
biases zeros. Unlike the port's own init, the CFM's adaLN modulation and
output projection are drawn too (the port starts them at zero, which would
leave the CFM an identity on its noise), the iSTFT head's log-magnitude
bias is the configuration's ``weights.vocoder_log_mag_bias``, which keeps
the random vocoder's samples inside [-1, 1] rather than on its clamp, and
the speech head's EOS column is scaled by ``weights.speech_head_eos_scale``:
at 0 the EOS logit is 0, below every top-25 of the other 4,096, so each
request runs to the target its traffic gives (a random head drew EOS early
in 0-43% of a seed's requests, which made the work a seed's accident).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

# a leaf: ("normal", shape, std) | ("ones", shape) | ("zeros", shape) | ("half_const", shape, value):
# its first half ``value``, the rest zero
Spec = Tuple


def _n(shape, fan_in: int) -> Spec:
    return ("normal", tuple(shape), 1.0 / math.sqrt(fan_in))


def _conv(k: int, c_in: int, c_out: int) -> Dict:
    return {"w": _n((k, c_in, c_out), k * c_in), "b": _n((c_out,), k * c_in)}


def _ln(c: int) -> Dict:
    return {"scale": ("ones", (c,)), "bias": ("zeros", (c,))}


def specs(cfg: Dict) -> Dict:
    """The tree of leaf specs of a configuration (the configuration file's dict)."""
    t, c, v, s, st = cfg["token_lm"], cfg["cfm"], cfg["vocoder"], cfg["speaker"], cfg["speech_tokenizer"]
    L, D, Ff = t["n_layers"], t["dim"], t["ffn_dim"]
    hd = D // t["n_heads"]
    qkv = (t["n_heads"] + 2 * t["n_kv_heads"]) * hd
    token_lm = {
        "tok_emb": _n((t["text_vocab_size"], D), D),
        "layers": {"attn_norm": ("ones", (L, D)), "wqkv": _n((L, D, qkv), D),
                   "wo": _n((L, t["n_heads"] * hd, D), t["n_heads"] * hd), "mlp_norm": ("ones", (L, D)),
                   "w_gate_up": _n((L, D, 2 * Ff), D), "w_down": _n((L, Ff, D), Ff)},
        "final_norm": ("ones", (D,)),
        "lm_head": _n((D, t["text_vocab_size"]), D),
        "speech_emb": _n((t["speech_vocab_size"], D), D),
        "speech_head": _n((D, t["speech_vocab_size"]), D),
        "spk_proj": _n((t["spk_dim"], D), t["spk_dim"]),
    }
    Dc, M, Lc = c["dim"], c["n_mels"], c["n_layers"]
    cfm = {
        "in_proj": _n((2 * M + 1, Dc), 2 * M + 1),
        "tok_emb": _n((c["token_vocab_size"], Dc), Dc),
        "spk_proj": _n((c["spk_dim"], Dc), c["spk_dim"]),
        "t_proj1": _n((256, Dc), 256),
        "t_proj2": _n((Dc, Dc), Dc),
        "layers": {"mod": _n((Lc, Dc, 6 * Dc), Dc), "wq": _n((Lc, Dc, Dc), Dc), "wk": _n((Lc, Dc, Dc), Dc),
                   "wv": _n((Lc, Dc, Dc), Dc), "wo": _n((Lc, Dc, Dc), Dc),
                   "w_up": _n((Lc, Dc, c["ffn_dim"]), Dc), "w_down": _n((Lc, c["ffn_dim"], Dc), c["ffn_dim"])},
        "out_norm_scale": ("ones", (Dc,)),
        "out_proj": _n((Dc, M), Dc),
    }
    if v["kind"] != "istft":
        raise ValueError("the benchmark draws the iSTFT vocoder only")
    C, n_bins = v["istft_channels"], v["istft_n_fft"] // 2 + 1
    bias = cfg["weights"]["vocoder_log_mag_bias"]
    vocoder = {
        "pre": _conv(7, v["n_mels"], C),
        "blocks": [{"conv": _conv(v["istft_kernel"], C, C), "ln": _ln(C),
                    "pw1": {"w": _n((C, 3 * C), C), "b": _n((3 * C,), C)},
                    "pw2": {"w": _n((3 * C, C), 3 * C), "b": _n((C,), 3 * C)}}
                   for _ in range(v["istft_blocks"])],
        "head": {"w": _n((C, 2 * n_bins), C),
                 "b": ("half_const", (2 * n_bins,), bias)},
    }
    Cs = s["channels"]
    speaker = {
        "stem": _conv(5, s["n_mels"], Cs), "stem_ln": _ln(Cs),
        "blocks": [{"conv1": _conv(3, Cs, Cs), "conv2": _conv(3, Cs, Cs), "ln1": _ln(Cs), "ln2": _ln(Cs)}
                   for _ in range(s["n_blocks"])],
        "att": _conv(1, Cs, Cs), "att_v": _conv(1, Cs, Cs),
        "head": {"w": _n((2 * Cs, s["emb_dim"]), 2 * Cs), "b": ("zeros", (s["emb_dim"],))},
    }
    Ds, in_ch, sub = st["dim"], st["n_mels"], []
    for _ in st["strides"]:
        sub.append({"conv": _conv(4, in_ch, Ds), "ln": _ln(Ds)})
        in_ch = Ds
    tokenizer = {
        "sub": sub,
        "enc": [{"ln1": _ln(Ds), "wq": _n((Ds, Ds), Ds), "wk": _n((Ds, Ds), Ds), "wv": _n((Ds, Ds), Ds),
                 "wo": _n((Ds, Ds), Ds), "ln2": _ln(Ds), "w_up": _n((Ds, st["ffn_dim"]), Ds),
                 "w_down": _n((st["ffn_dim"], Ds), st["ffn_dim"])} for _ in range(st["n_layers"])],
        "codebook": ("normal", (st["codebook_size"], Ds), 1.0),
    }
    return {"token_lm": token_lm, "cfm": cfm, "vocoder": vocoder, "speaker": speaker,
            "speech_tokenizer": tokenizer}


def _normals(spec: Any) -> int:
    if isinstance(spec, dict):
        return sum(_normals(v) for v in spec.values())
    if isinstance(spec, list):
        return sum(_normals(v) for v in spec)
    return math.prod(spec[1]) if spec[0] == "normal" else 0


def draw(cfg: Dict, seed: int, device) -> Dict:
    """The whole tree from one normal draw of a generator seeded with ``seed``."""
    tree = specs(cfg)
    n = _normals(tree)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    at = [0]

    def build(spec):
        if isinstance(spec, dict):
            return {k: build(v) for k, v in spec.items()}
        if isinstance(spec, list):
            return [build(x) for x in spec]
        kind, shape = spec[0], spec[1]
        if kind == "normal":
            k = math.prod(shape)
            leaf = flat[at[0]: at[0] + k].view(shape).mul_(spec[2])
            at[0] += k
            return leaf
        if kind == "ones":
            return torch.ones(shape, device=device)
        if kind == "zeros":
            return torch.zeros(shape, device=device)
        leaf = torch.zeros(shape, device=device)
        leaf[: shape[0] // 2] = float(spec[2])
        return leaf

    out = build(tree)
    eos = cfg["token_lm"]["speech_vocab_size"] - 2
    out["token_lm"]["speech_head"][:, eos] *= float(cfg["weights"]["speech_head_eos_scale"])
    return out
