"""The ``tts`` program: the port's style-DB TTS engine
(``autostyle_tts_tpu_torch``), the program of every configuration that
names none (``programs/__init__.py`` lists what a program provides).

The program is driven only through its public entry points:
``StyleStore.search``, ``Engine.prompt_features_from_store``,
``Engine.inference_tts_with_st`` (B=1, whole or ``stream=True``) and
``Engine.synthesize_batch`` (batches). ``Taps`` records what the timed
path produced for the check (the LM's tokens, a request's prompt features)
without changing it. Its weights are ``tts_weights``; its comparison with
``reference/tts.py`` is ``tts_check``.
"""

from __future__ import annotations

import math
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import counts
from ..reference.tts import GEN_BUCKETS, TOKEN_BUCKETS, bucket, encode_text
from ..traffic.generator import Traffic
from .tts_check import Reference, decode_path, numbers, served_tokens  # noqa: F401  the program's check
from .tts_weights import draw, specs  # noqa: F401  the program's weights

reference_args = decode_path


def port_config(cfg: Dict):
    """The port's ``Config`` of a configuration file (its other keys ignored)."""
    from autostyle_tts_tpu_torch.utils.config import from_dict

    return from_dict(cfg)


def prepare(device) -> Dict:
    """The port's CUDA kernels, all at once (nvcc only where a library is
    missing): their seconds and the libraries compiled."""
    if torch.device(device).type != "cuda":
        return {}
    from autostyle_tts_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    built = cuda_build.build()
    return {"kernel_builds": time.perf_counter() - t0, "compiled": sorted(built)}


def span_log() -> Optional[List]:
    """The port's log of its finished spans, or None where it keeps none."""
    try:
        from autostyle_tts_tpu_torch.utils.timing import spans
    except ImportError:
        return None
    return spans()


class Taps:
    """Observers on the program's outputs. While ``on``, every
    ``SpeechGen`` the engine's token LM returns, the decode path each call
    asked for, and every list of prompt features the engine makes are kept
    (device tensors are not read until the window has closed); for a
    stream (``stream``), the decode path each started decode loop asked
    for (``starts``) and the tokens its loop handed out (``drawn``)."""

    def __init__(self, eng, stream: bool = False):
        from autostyle_tts_tpu_torch.models import token_lm

        self.mod, self.eng = token_lm, eng
        self.on = False
        self.gens: List = []
        self.paths: List[Dict] = []
        self.feats: List = []
        self.starts: List[Dict] = []
        self.drawn: List[int] = []
        self._gen = token_lm.generate_speech_from_ids
        self._start, self._take = token_lm.start_decode, token_lm.take
        self._feat = eng.prompt_features

        def gen(*a, **k):
            out = self._gen(*a, **k)
            if self.on:
                self.gens.append(out)
                self.paths.append(decode_path_of(k))
            return out

        def start(*a, **k):
            if self.on:
                self.starts.append(decode_path_of(k))
            return self._start(*a, **k)

        def take(*a, **k):
            steps, gen = self._take(*a, **k)
            if self.on:
                self.drawn += [int(s[0]) for s in steps]
            return steps, gen

        def feat(*a, **k):
            out = self._feat(*a, **k)
            if self.on:
                self.feats.append(out)
            return out

        token_lm.generate_speech_from_ids = gen
        if stream:
            token_lm.start_decode, token_lm.take = start, take
        eng.prompt_features = feat

    def clear(self) -> None:
        for kept in (self.gens, self.paths, self.feats, self.starts, self.drawn):
            kept.clear()

    def remove(self) -> None:
        self.mod.generate_speech_from_ids = self._gen
        self.mod.start_decode, self.mod.take = self._start, self._take
        del self.eng.prompt_features


def decode_path_of(kwargs: Dict) -> Dict:
    """The decode path a call of ``generate_speech_from_ids`` (or a
    stream's ``start_decode``) asks for: the decode-step kernel at its
    weights' width (``bits``) where it passes the step's params, else the
    scanned decode (``bits`` None) with or without an int8 KV cache."""
    from autostyle_tts_tpu_torch.ops.decode_step import weight_bits

    dp = kwargs.get("decode_params")
    if isinstance(dp, dict) and kwargs.get("fused", True):
        return {"bits": weight_bits(dp), "kv_int8": False}
    return {"bits": None if dp is None else "layers", "kv_int8": bool(kwargs.get("kv_int8", False))}


class SpanLog:
    """Host-clock spans of the traced part: the benchmark's own (``db
    search``) and, through a ``Stopwatch`` that records them, the engine's
    (featurize, prefill, decode, cfm, vocoder)."""

    def __init__(self):
        self.on = False
        self.spans: List = []

    def add(self, name: str, t0: float, t1: float) -> None:
        if self.on:
            self.spans.append((name, t0, t1))

    @contextmanager
    def stopwatch(self):
        from autostyle_tts_tpu_torch.pipeline import engine as engine_mod
        from autostyle_tts_tpu_torch.utils.timing import Stopwatch

        log = self

        class Logged(Stopwatch):
            @contextmanager
            def span(self, name):
                with super().span(name):
                    t0 = time.perf_counter()
                    try:
                        yield
                    finally:
                        self._sync()
                        log.add(name, t0, time.perf_counter())

        engine_mod.Stopwatch = Logged
        try:
            yield
        finally:
            engine_mod.Stopwatch = Stopwatch


class Session:
    """The program under test with its inputs, built from the seed."""

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device):
        from autostyle_tts_tpu_torch.pipeline.engine import Engine, EngineParams

        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.device = torch.device(device)
        self.setup_times: Dict[str, float] = {}     # seconds of each part of the set-up
        t0 = time.perf_counter()
        self.pcfg = port_config(cfg)
        self.traffic = Traffic(mix, seed, cfg["audio"]["prompt_sample_rate"])
        tree = draw(cfg, seed, self.device)
        self._sync()
        t1 = time.perf_counter()
        self.eng = Engine(self.pcfg, params=EngineParams(**tree), seed=self.seed, device=self.device)
        del tree
        self._sync()
        t2 = time.perf_counter()
        self.setup_times.update(weights=t1 - t0, engine=t2 - t1)
        self.taps = Taps(self.eng, stream="stream" in mix)
        self.spans = SpanLog()
        self.up, self.hop = cfg["cfm"]["upsample"], cfg["audio"]["hop_length"]
        self.sr = cfg["audio"]["sample_rate"]
        B = mix["batch"]
        self.noise = self.traffic.noise_bank(B, (TOKEN_BUCKETS[-1] + GEN_BUCKETS[-1]) * self.up,
                                             cfg["cfm"]["n_mels"])
        self.store = self.db = None
        self.pool = None
        if mix["prompts"] == "db":
            self._build_db()
        else:
            self.pool = self.traffic.wav_pool()
        self._sync()
        self.setup_times["prompts"] = time.perf_counter() - t2

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def requests(self):
        """The traffic's requests in arrival order (prompts "wav": from the
        session's pool)."""
        return self.traffic.requests(self.pool)

    @staticmethod
    def counters() -> Dict[str, int]:
        """The program's own counts of decode-step kernel launches, by
        weight width (a step on the CPU runs the plain twin and counts none)."""
        from autostyle_tts_tpu_torch.ops.decode_step import mega_decode_step

        return {"8": int(mega_decode_step.launches), "4": int(mega_decode_step.launches_int4)}

    def _build_db(self) -> None:
        from autostyle_tts_tpu_torch.pipeline import rag
        from autostyle_tts_tpu_torch.retrieval.store import StyleStore

        d = self.mix["db"]
        self.db = self.traffic.db_rows()
        store = StyleStore(dim=d["dim"], capacity=d["capacity"], device=self.device)
        store.insert(self.db["vectors"], [{"file_id": f"style_{i}", "text": t}
                                          for i, t in enumerate(self.db["transcripts"])])
        art = rag.prompt_artifacts(self.eng, self.db["wavs"], batch=len(self.db["wavs"]))
        self.db["artifacts"] = art
        rows = self.db["wav_of_row"]
        store.artifacts = {k: v[rows] for k, v in art.items()}
        self.store = store

    def close(self) -> None:
        self.taps.remove()
        self.eng = self.store = None

    # ------------------------------------------------------------------ one request / batch

    def _noise(self, slot: int, rows: int, fp_w: int, max_new: int) -> np.ndarray:
        return self.noise[slot % len(self.noise), :rows, : (fp_w + max_new) * self.up]

    def _prompts(self, req, t0: float, kept: Dict):
        """A B=1 request's prompts: the DB's top-2 rows (searched here, the
        search timed from ``t0``) or its own wavs -> (style, timbre,
        style text, timbre tokens, search ms)."""
        if self.store is None:
            hop_tok = self.cfg["audio"]["prompt_hop_length"] * int(np.prod(self.cfg["speech_tokenizer"]["strides"]))
            sty, tim = req.wavs
            return sty, tim, "", max(1, len(tim) // hop_tok), None
        hits = self.store.search(req.query[None], k=self.mix["db"]["top_k"])[0]
        ts = time.perf_counter()
        self.spans.add("db search", t0, ts)
        sty, tim = self.eng.prompt_features_from_store(self.store, [hits[0].index, hits[1].index])
        kept.update(hits=[(h.index, h.distance) for h in hits], feats=(sty, tim))
        return sty, tim, hits[0].text, len(tim.tokens), (ts - t0) * 1e3

    def serve_one(self, req, j) -> Dict:
        """One B=1 request, timed from the client's call to the wav on the
        host: ``wall_ms``, ``search_ms``, the engine's ``timings``, decode
        ``steps``, ``gen_len``, ``useful_s`` (seconds of audio up to the
        request's target) and, under ``kept``, what the check reads."""
        eng, kept = self.eng, {}
        self.taps.clear()
        max_seconds = req.target / self.mix["token_rate"]
        max_new = bucket(req.target, GEN_BUCKETS)
        t0 = time.perf_counter()
        sty, tim, style_text, n_tim, search_ms = self._prompts(req, t0, kept)
        fp_w = bucket(n_tim, TOKEN_BUCKETS)
        noise = self._noise(req.index, 1, fp_w, max_new)
        wav = next(eng.inference_tts_with_st(req.text, style_text, sty, tim, max_seconds=max_seconds,
                                             cfm_noise=noise))["tts_speech"][0]
        t1 = time.perf_counter()
        kept.update(gens=list(self.taps.gens), paths=list(self.taps.paths), feat_out=list(self.taps.feats))
        kept.update(text=req.text, style_text=style_text, fp_w=fp_w, max_new=max_new, noise_slot=req.index,
                    wav=wav, query=req.query, wavs=req.wavs)
        return dict(i=req.index, target=req.target, t0=t0, t1=t1, wall_ms=(t1 - t0) * 1e3, search_ms=search_ms,
                    timings=dict(eng.last_timings), steps=eng.last_decode_steps, gen_len=eng.last_gen_len,
                    samples=len(wav), useful_s=min(len(wav), req.target * self.up * self.hop) / self.sr,
                    kept=kept)

    def stream_noise(self, slot: int, n_tim: int, max_new: int) -> List[np.ndarray]:
        """The CFM noise of each window a stream can render ([1, W * up,
        M], W = fp_w + 2 * chunk): window k of request ``slot`` reads bank
        entry (slot + k) mod the bank, from frame k * W * up (wrapped)."""
        st = self.mix["stream"]
        chunk = st["chunk_tokens"]
        fp_w = bucket(min(n_tim, st["prompt_tokens"]), TOKEN_BUCKETS)
        width = (fp_w + 2 * chunk) * self.up
        frames = self.noise.shape[2]
        out = []
        for k in range(math.ceil(max_new / chunk)):
            off = (k * width) % (frames - width + 1)
            out.append(self.noise[(slot + k) % len(self.noise), :1, off: off + width])
        return out

    def serve_stream(self, req, j) -> Dict:
        """One B=1 request streamed (``stream=True``), the client taking
        its chunks as they come: ``ttfa_ms`` from the client's call (the
        DB search included) to the first chunk's samples on the host,
        ``wall_ms`` to the last one's; the engine's render time of each
        window (``chunk_ms``); the rest as ``serve_one``."""
        eng, kept = self.eng, {}
        self.taps.clear()
        max_seconds = req.target / self.mix["token_rate"]
        max_new = bucket(req.target, GEN_BUCKETS)
        t0 = time.perf_counter()
        sty, tim, style_text, n_tim, search_ms = self._prompts(req, t0, kept)
        noise = self.stream_noise(req.index, n_tim, max_new)
        chunks, ttfa = [], None
        for out in eng.inference_tts_with_st(req.text, style_text, sty, tim, stream=True,
                                             max_seconds=max_seconds, cfm_noise=noise):
            chunks.append(out["tts_speech"][0])
            ttfa = (time.perf_counter() - t0) * 1e3 if ttfa is None else ttfa
        t1 = time.perf_counter()
        n = sum(len(c) for c in chunks)
        kept.update(drawn=list(self.taps.drawn), paths=list(self.taps.starts), feat_out=list(self.taps.feats))
        kept.update(text=req.text, style_text=style_text, max_new=max_new, noise_slot=req.index, n_tim=n_tim,
                    chunks=chunks, query=req.query, wavs=req.wavs)
        return dict(i=req.index, target=req.target, t0=t0, t1=t1, wall_ms=(t1 - t0) * 1e3, ttfa_ms=ttfa,
                    search_ms=search_ms, chunk_ms=list(eng.last_chunk_ms), timings=dict(eng.last_timings),
                    steps=eng.last_decode_steps, gen_len=eng.last_gen_len, samples=n,
                    useful_s=min(n, req.target * self.up * self.hop) / self.sr, kept=kept)

    def serve_batch(self, reqs, j: int) -> Dict:
        """One batch of the backlog: the DB searches, then one
        ``synthesize_batch``; the record as ``serve_one``'s, with each
        row's ``targets`` and ``gen_lens``."""
        eng, B = self.eng, len(reqs)
        self.taps.clear()
        max_target = max(r.target for r in reqs)
        max_new = bucket(max_target, GEN_BUCKETS)
        t0 = time.perf_counter()
        hits = self.store.search(np.stack([r.query for r in reqs]), k=self.mix["db"]["top_k"])
        ts = time.perf_counter()
        self.spans.add("db search", t0, ts)
        sty = eng.prompt_features_from_store(self.store, [h[0].index for h in hits])
        tim = eng.prompt_features_from_store(self.store, [h[1].index for h in hits])
        fp_w = bucket(max(len(f.tokens) for f in tim), TOKEN_BUCKETS)
        noise = self._noise(j, B, fp_w, max_new)
        wavs = eng.synthesize_batch([r.text for r in reqs], [h[0].text for h in hits], sty, tim,
                                    max_seconds=max_target / self.mix["token_rate"], cfm_noise=noise)
        t1 = time.perf_counter()
        useful = sum(min(len(w), r.target * self.up * self.hop) for w, r in zip(wavs, reqs)) / self.sr
        kept = dict(texts=[r.text for r in reqs], style_texts=[h[0].text for h in hits], feats=list(zip(sty, tim)),
                    hits=[[(x.index, x.distance) for x in h] for h in hits], queries=[r.query for r in reqs],
                    fp_w=fp_w, max_new=max_new, noise_slot=j, wavs=wavs, targets=[r.target for r in reqs],
                    gens=list(self.taps.gens), paths=list(self.taps.paths))
        return dict(i=j, target=max_target, t0=t0, t1=t1, wall_ms=(t1 - t0) * 1e3, search_ms=(ts - t0) * 1e3,
                    timings=dict(eng.last_timings), steps=eng.last_decode_steps, gen_lens=list(eng.last_gen_lens),
                    targets=[r.target for r in reqs], samples=sum(len(w) for w in wavs), useful_s=useful, kept=kept)

    # ------------------------------------------------------------------ warm-up

    def _warm_streams(self, pairs, texts) -> int:
        """A streamed request at every generation bucket with the widest
        prompt, and at the shortest with each other prompt: a stream's
        windows share one shape (the flow prompt is cut to the mix's
        ``prompt_tokens``), its prefill and decode loop vary with the
        prompt and the generation bucket."""
        pairs = sorted(pairs, key=lambda p: len(getattr(p[0], "tokens", p[0])))
        plan = [(g, pairs[-1]) for g in GEN_BUCKETS] + [(GEN_BUCKETS[0], p) for p in pairs[:-1]]
        for g, (sty, tim, st) in plan:
            for _ in self.eng.inference_tts_with_st(texts(g), st, sty, tim, stream=True,
                                                    max_seconds=g / self.mix["token_rate"]):
                pass
        return len(plan)

    def warm_up(self) -> int:
        """Every shape the traffic uses, before the clock: each generation
        bucket, each flow-prompt bucket the prompts reach (B=1: one request
        a pair, or ``_warm_streams`` where the traffic streams; batches:
        one short batch a prompt bucket, then the CFM and vocoder of every
        generation bucket through ``synthesize_from_tokens``).
        Returns the requests made."""
        rng = self.traffic.rng(12)
        texts = lambda n: self.traffic.text(rng, self.traffic.n_words(n / self.mix["token_rate"]), 300)  # noqa: E731
        made = 0
        if self.mix["batch"] == 1:
            if self.store is not None:
                art = self.db["artifacts"]
                lens = art["speech_token_lens"]
                by_bucket = {bucket(int(n), TOKEN_BUCKETS): j for j, n in enumerate(lens)}
                prompts = [self.eng.prompt_features_from_store(self.store, [j, j])[0] for j in by_bucket.values()]
                pairs = [(p, p, "style line") for p in prompts]
            else:
                sr = self.cfg["audio"]["prompt_sample_rate"]
                by_bucket = {bucket(len(w), tuple(sr * s for s in (1, 2, 4, 8, 16, 30))): w for w in self.pool}
                pairs = [(w, w.copy(), "") for w in by_bucket.values()]
            if "stream" in self.mix:
                return self._warm_streams(pairs, texts)
            for g in GEN_BUCKETS:
                for sty, tim, st in pairs:
                    next(self.eng.inference_tts_with_st(texts(g), st, sty, tim, max_seconds=g / self.mix["token_rate"]))
                    made += 1
            return made
        B = self.mix["batch"]
        art, lens = self.db["artifacts"], self.db["artifacts"]["speech_token_lens"]
        by_bucket = {bucket(int(n), TOKEN_BUCKETS): j for j, n in enumerate(lens)}
        for j in by_bucket.values():
            f = self.eng.prompt_features_from_store(self.store, [j] * B)
            self.eng.synthesize_batch([texts(64) for _ in range(B)], ["style line"] * B, f, f,
                                      max_seconds=GEN_BUCKETS[0] / self.mix["token_rate"])
            made += 1
            for g in GEN_BUCKETS:
                self.eng.synthesize_from_tokens([{"tokens": np.arange(g, dtype=np.int32) % 64, "flow_feat": x}
                                                 for x in f])
                made += 1
        return made


# ---------------------------------------------------------------------- what the readers take of a record


def rows(rec: Dict) -> List[tuple]:
    """(prefix length, tokens generated, flow-prompt tokens, decode steps)
    of each row of a record, at their real lengths."""
    k = rec["kept"]
    if "texts" in k:       # a batch
        out = []
        for b, (sty, tim) in enumerate(k["feats"]):
            n_pre = _prefix_len(k["texts"][b], k["style_texts"][b], len(sty.tokens))
            g = rec["gen_lens"][b]
            out.append((n_pre, g, len(tim.tokens), g))
        return out
    sty, tim = k["feats"] if "feats" in k else k["feat_out"][0]
    return [(_prefix_len(k["text"], k["style_text"], len(sty.tokens)), rec["gen_len"], len(tim.tokens), rec["steps"])]


def _prefix_len(text: str, style_text: str, n_style: int) -> int:
    full = (style_text + " " + text).strip() if style_text else text
    return 2 + len(encode_text(full)) + min(n_style, 256)


def flops(cfg: Dict, rec: Dict) -> float:
    """Model FLOPs of a record's rows at their real lengths (``counts.request_flops``)."""
    return sum(counts.request_flops(cfg, n_pre, g, n_p) for n_pre, g, n_p, _ in rows(rec))


def describe(run) -> List[str]:
    """How many finished rows drew EOS before their target."""
    recs = [r for r in run.records if not r.get("failed")]
    targets = [t for r in recs for t in (r["targets"] if "targets" in r else [r["target"]])]
    lens = [g for r in recs for g in (r["gen_lens"] if "gen_lens" in r else [r["gen_len"]])]
    early = sum(1 for g, t in zip(lens, targets) if g < t)
    return [f"{early} of {len(lens)} rows drew EOS before their target ({100.0 * early / max(len(lens), 1):.1f}%)"]
