"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``reference/tts.py``), on a sample of what the
window finished, drawn from the seed with the longest request in it.

Numbers compared (each against its cell's limit, ``limits/<cell>.json``):

- ``lm_gap``: the widest gap by which a served speech token's logit lies
  below the reference's k-th best logit at its position (k the sampler's
  top-k: a top-k sampler serves only its top k), the reference run
  teacher-forced over the request's prompt and its served tokens: the
  prefill, every decode step and the sampler's masks.
- ``wav_rel_err``: the worst relative L2 distance between a served wav
  and the reference's CFM and vocoder on the same tokens, prompt and noise.
- ``chunks_rel_err`` (streams): the same of a stream's joined chunks
  against the reference's render of the same windows
  (``reference/tts_stream.py``) on the same tokens, prompt and noise; a
  chunk missing or added changes the length and reads infinite.
- ``off_path``: the window's decode calls that left the path the
  configuration states (``decode`` in its file; ``off_path``, below): an
  exact comparison, limit 0.
- ``search_err``: the widest distance between a search's top-k scores (and
  the scores of the rows it returned) and the reference's cosine top-k.
- ``tok_mismatch``, ``spk_err``, ``mel_err``: prompt features (the DB's
  rows made at set-up, or every finished wav request's own) against the reference's
  featurize of the same wav: the speech tokens that are not the
  reference's nearest codebook entry, as a share (%) of the frames whose
  reference top-2 VQ scores lie within ``VQ_TIE`` (a seed's drawn
  tokenizer sets how many near-ties there are, and so how many tokens any
  rounding can flip: the share over them is steady from seed to seed); the
  largest speaker-embedding and log-mel differences.

The downstream comparisons start from the prompt features the program
made (the DB's rows, a request's featurize), which the feature numbers
check by themselves. The control (``Numerics(control=True)``) is put in
the program's place with the same inputs: it serves, at each position,
a token drawn from its own top-k, and its own features, wavs and hits.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference import tts, tts_stream
from .tts_weights import draw

VQ_TIE = 1.0    # VQ score units (2 h.c - |c|^2): a frame whose top-2 scores lie this close is a near-tie


class Reference:
    """The reference (or the control) of one run's configuration and seed."""

    def __init__(self, cfg: Dict, seed: int, device, decode_bits: int, kv_int8_gen: bool, control: bool = False):
        self.cfg, self.device = cfg, torch.device(device)
        self.tree = draw(cfg, seed, self.device)
        self.ref = tts.Numerics()
        self.num = tts.Numerics(control=control)
        self.control = control
        self.lm_ref = tts.LMWeights(self.tree["token_lm"], self.ref, decode_bits)
        self.lm_ctl = tts.LMWeights(self.tree["token_lm"], self.num, decode_bits) if control else None
        self.kv_int8_gen = kv_int8_gen
        self.k = int(cfg["sampler"]["top_k"])
        self.min_tokens = int(cfg["sampler"]["min_tokens"])
        self.rng = torch.Generator(device=self.device).manual_seed(seed + 1)

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------ token LM

    def lm_gap(self, text: str, style_text: str, style_tokens, spk, served: List[int]) -> float:
        lm, lcfg = self.tree["token_lm"], self.cfg["token_lm"]
        full = (style_text + " " + text).strip() if style_text else text
        prefix = tts.lm_prefix(lm, lcfg, tts.encode_text(full), style_tokens, self._t(spk))
        ref = tts.mask_logits(tts.lm_logits(lm, lcfg, self.lm_ref, self.ref, prefix, served, self.kv_int8_gen),
                              lcfg, self.min_tokens)
        if not self.control:
            return tts.topk_gap(ref, served, self.k)
        ctl = tts.mask_logits(tts.lm_logits(lm, lcfg, self.lm_ctl, self.num, prefix, served, self.kv_int8_gen),
                              lcfg, self.min_tokens)
        top = torch.topk(ctl, self.k, dim=-1)
        pick = torch.multinomial(torch.softmax(top.values, -1), 1, generator=self.rng)
        return tts.topk_gap(ref, top.indices.gather(1, pick)[:, 0].tolist(), self.k)

    # ------------------------------------------------------------------ CFM + vocoder

    def wav_err(self, feat, served: List[int], wav: np.ndarray, noise: np.ndarray, fp_w: int, max_new: int) -> float:
        args = (feat.tokens, feat.mel24, self._t(feat.spk), served, self._t(noise), fp_w, max_new)
        ref = tts.served_wav(self.tree, self.cfg, self.ref, *args)
        got = tts.served_wav(self.tree, self.cfg, self.num, *args) if self.control else self._t(wav)
        return _rel_err(got, ref)

    def chunks_err(self, feat, served: List[int], chunks: List[np.ndarray], noises: List[np.ndarray],
                   stream: Dict) -> float:
        """A stream's joined chunks against the reference's render of its
        windows (``stream``: the mix's ``chunk_tokens`` and ``prompt_tokens``)."""
        args = (feat.tokens, feat.mel24, self._t(feat.spk), served, [self._t(n[0]) for n in noises],
                stream["chunk_tokens"], stream["prompt_tokens"])
        ref = torch.cat(tts_stream.render(self.tree, self.cfg, self.ref, *args))
        got = (torch.cat(tts_stream.render(self.tree, self.cfg, self.num, *args)) if self.control
               else self._t(np.concatenate(chunks) if chunks else np.zeros(0, np.float32)))
        return _rel_err(got, ref)

    # ------------------------------------------------------------------ featurize

    def feature_errs(self, wavs: List[np.ndarray], feats: List, padded: Optional[List[int]] = None) -> Dict[str, float]:
        """``feats[i]`` (tokens, spk, mel24) made from ``wavs[i]``, padded
        to ``padded[i]`` samples as its batch was (by default the wavs
        featurized as one batch)."""
        if padded is None:
            padded = [_padded(self, wavs)] * len(wavs)
        out = {"spk_err": 0.0, "mel_err": 0.0}
        near = missed = 0
        for w, f, pad in zip(wavs, feats, padded):
            ref = tts.featurize(self.tree, self.cfg, self.ref, w, pad, self.device)
            if self.control:
                ctl = tts.featurize(self.tree, self.cfg, self.num, w, pad, self.device)
                toks, spk, mel = ctl["scores"].argmax(-1), ctl["spk"], ctl["mel24"]
            else:
                toks = torch.as_tensor(np.asarray(f.tokens), dtype=torch.long, device=self.device)
                spk, mel = self._t(f.spk), self._t(f.mel24)
            s = ref["scores"]
            if toks.shape[0] != s.shape[0] or mel.shape != ref["mel24"].shape:
                return {k: float("inf") for k in ("tok_mismatch", "spk_err", "mel_err")}
            top2 = torch.topk(s, 2, dim=-1).values
            near += int((top2[:, 0] - top2[:, 1] < VQ_TIE).sum())
            missed += int((toks != s.argmax(-1)).sum())
            out["spk_err"] = max(out["spk_err"], float((spk - ref["spk"]).abs().max()))
            out["mel_err"] = max(out["mel_err"], float((mel - ref["mel24"]).abs().max()))
        out["tok_mismatch"] = 100.0 * missed / max(near, 1)
        return out

    # ------------------------------------------------------------------ style DB

    def search_err(self, queries: np.ndarray, rows: np.ndarray, hits: List[List]) -> float:
        ref = tts.cosine_scores(self.ref, self._t(queries), self._t(rows))
        k = len(hits[0])
        top = torch.topk(ref, k, dim=-1).values
        if self.control:
            ctl = tts.cosine_scores(self.num, self._t(queries), self._t(rows))
            c = torch.topk(ctl, k, dim=-1)
            hits = [[(int(i), float(v)) for i, v in zip(ci, cv)] for ci, cv in zip(c.indices.tolist(), c.values.tolist())]
        err = 0.0
        for q, row_hits in enumerate(hits):
            for r, (idx, score) in enumerate(row_hits):
                err = max(err, abs(score - float(top[q, r])), abs(score - float(ref[q, idx])))
        return err


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Relative L2 distance; infinite where the lengths differ."""
    if got.shape != ref.shape:
        return float("inf")
    return float(torch.linalg.norm(got - ref) / torch.clamp(torch.linalg.norm(ref), min=1e-12))


def served_tokens(gen, row: int, eos: int) -> List[int]:
    """A row's drawn tokens from the LM's ``SpeechGen``: those before EOS,
    and EOS where it was drawn."""
    toks = gen.tokens[row].tolist()
    n = int(gen.lengths[row])
    return toks[: n + 1] if n < len(toks) and toks[n] == eos else toks[:n]


def streamed_tokens(drawn: List[int], eos: int) -> List[int]:
    """A stream's drawn tokens up to EOS, and EOS where it was drawn."""
    return drawn[: drawn.index(eos) + 1] if eos in drawn else list(drawn)


def sample(records: List[Dict], n: int, seed: int) -> List[Dict]:
    """n finished records drawn from the seed, the longest among them."""
    done = [r for r in records if not r.get("failed")]
    if not done:
        return []
    longest = max(done, key=lambda r: (r["target"], r["i"]))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([seed, 11])
    pick = [rest[i] for i in sorted(rng.choice(len(rest), min(n - 1, len(rest)), replace=False))] if rest else []
    return [longest] + pick


def numbers(session, run, ref: Reference) -> Dict[str, float]:
    """Every number the cell compares, from the run's records (float32
    products with TF32 off while the reference runs)."""
    with tts.reference_mode():
        return _numbers(session, run, ref)


def _numbers(session, run, ref: Reference) -> Dict[str, float]:
    cfg, mix = session.cfg, session.mix
    eos = cfg["token_lm"]["speech_vocab_size"] - 2
    out: Dict[str, float] = {"lm_gap": 0.0}
    if mix["batch"] == 1:
        recs = sample(run.records, mix["check"]["requests"], session.seed)
        units = [(r["kept"], 0) for r in recs]
    else:
        recs = sample(run.records, mix["check"]["batches"], session.seed)
        units = [(r["kept"], b) for r in recs for b in range(len(r["kept"]["wavs"]))]
    if not units:
        return {}
    queries, hits = [], []
    for kept, b in units:
        batched = mix["batch"] > 1
        streamed = "chunks" in kept
        served = streamed_tokens(kept["drawn"], eos) if streamed else served_tokens(kept["gens"][0], b, eos)
        if batched:
            sty, tim = kept["feats"][b]
            text, style_text = kept["texts"][b], kept["style_texts"][b]
        else:
            sty, tim = kept["feats"] if "feats" in kept else kept["feat_out"][0]
            text, style_text = kept["text"], kept["style_text"]
        if "hits" in kept:
            queries.append(kept["queries"][b] if batched else kept["query"])
            hits.append(kept["hits"][b] if batched else kept["hits"])
        out["lm_gap"] = max(out["lm_gap"], ref.lm_gap(text, style_text, sty.tokens, tim.spk, served))
        gen_toks = served[:-1] if served and served[-1] == eos else served
        if streamed:
            noises = session.stream_noise(kept["noise_slot"], kept["n_tim"], kept["max_new"])
            out["chunks_rel_err"] = max(out.get("chunks_rel_err", 0.0),
                                        ref.chunks_err(tim, gen_toks, kept["chunks"], noises, mix["stream"]))
            continue
        wav = kept["wavs"][b] if batched else kept["wav"]
        noise = session.noise[kept["noise_slot"] % len(session.noise), b, : (kept["fp_w"] + kept["max_new"]) * session.up]
        out["wav_rel_err"] = max(out.get("wav_rel_err", 0.0),
                                 ref.wav_err(tim, gen_toks, wav, noise, kept["fp_w"], kept["max_new"]))
    out["off_path"] = float(off_path(session, run))
    if hits:
        out["search_err"] = ref.search_err(np.stack(queries), session.db["vectors"], hits)
    if session.db is not None:
        art = session.db["artifacts"]
        feats = [_Feat(art, j) for j in range(len(session.db["wavs"]))]
        out.update(ref.feature_errs(session.db["wavs"], feats))
    else:
        # every finished request's own prompt features: the cell's featurize is its point
        reqs = [r["kept"] for r in run.records if not r.get("failed")]
        out.update(ref.feature_errs([w for k in reqs for w in k["wavs"]], [f for k in reqs for f in k["feat_out"][0]],
                                    padded=[_padded(ref, k["wavs"]) for k in reqs for _ in k["wavs"]]))
    return out


def _padded(ref: Reference, wavs: List[np.ndarray]) -> int:
    return tts.prompt_padded_len([len(w) for w in wavs], ref.cfg["audio"]["prompt_sample_rate"])


class _Feat:
    """Row j of the DB's prompt artifacts as prompt features."""

    def __init__(self, art: Dict, j: int):
        self.tokens = art["speech_tokens"][j, : art["speech_token_lens"][j]]
        self.mel24 = art["prompt_mel"][j, : art["prompt_mel_lens"][j]]
        self.spk = art["spk"][j]


def stated_path(cfg: Dict, mix: Dict) -> Dict:
    """How the configuration file states that a request's decode runs
    (``decode.b1`` for B=1 traffic, ``decode.batch`` for batches): the
    path (``decode_step``, the B=1 kernel, or ``scanned``), the width of
    its weights and its KV cache's type."""
    d = cfg["decode"]["b1" if mix["batch"] == 1 else "batch"]
    if d["path"] not in ("decode_step", "scanned") or d["kv_cache"] not in ("bfloat16", "int8"):
        raise ValueError(f"unknown decode path in the configuration: {d}")
    return {"path": d["path"], "bits": int(d["weight_bits"]), "kv_int8": d["kv_cache"] == "int8"}


def decode_path(session) -> Dict:
    """The reference's decode precision, from the configuration file alone:
    the stated weight width, and an int8 KV cache where the stated path
    is the scanned decode with one (the B=1 kernel keeps a bfloat16 cache)."""
    p = stated_path(session.cfg, session.mix)
    return {"decode_bits": p["bits"], "kv_int8_gen": p["path"] == "scanned" and p["kv_int8"]}


def off_path(session, run) -> int:
    """Decode calls of the window that left the stated path (0 in a sound
    run): each token-LM call whose decode path (``Taps``) is not the
    stated one, each finished record without exactly one call, and, on
    the card, every decode-step launch of the other width or in a batch
    cell, and every decode step of a B=1 cell that was not a launch of the
    stated width (the program's own launch counters; a CPU step runs the
    plain twin and counts none)."""
    want = stated_path(session.cfg, session.mix)
    kernel = want["path"] == "decode_step"
    expect = {"bits": want["bits"], "kv_int8": False} if kernel else {"bits": None, "kv_int8": want["kv_int8"]}
    recs = [r for r in run.records if not r.get("failed")]
    n = sum(1 for r in recs for p in r["kept"]["paths"] if p != expect)
    n += sum(1 for r in recs if len(r["kept"]["paths"]) != 1)
    if session.device.type == "cuda":
        steps = sum(r["steps"] for r in recs) if kernel else 0
        for bits, count in run.counters.items():
            n += abs(count - steps) if kernel and bits == str(want["bits"]) else count
    return n
