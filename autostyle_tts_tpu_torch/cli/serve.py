"""Batch serving loop: JSONL requests in -> 24 kHz wavs + JSONL responses out.

Counterpart of the JAX ``cli/serve.py``. Requests stream from a file or
stdin and are batched dynamically (flushed at --batch requests or
--max_wait_ms, whichever comes first) through ``synthesize_batch``; with
--continuous they join a ``ContinuousBatcher`` slot pool mid-decode, and
with --continuous --stream every request is a ``StreamingScheduler``
session that emits its audio a chunk at a time. Runs on the card unless
--device cpu.

Request line:
  {"id": "r1", "text": "...", "style_text": "...",
   "style_wav": "/p/s.wav" | "style_index": 3,      # DB row (needs --style_db)
   "timbre_wav": "/p/t.wav" | "timbre_id": "w1"}     # registered via --timbre_map

Response line:
  {"id": "r1", "wav": "<result_dir>/r1.wav", "samples": N,
   "audio_s": ..., "latency_ms": ...}
  or {"id": "r1", "error": "..."}: a request's failure never stops the loop.
"""

from __future__ import annotations

import argparse
import json
import select
import sys
import time
from pathlib import Path
from typing import Dict, List, TextIO

import numpy as np

from ..retrieval.store import StyleStore
from ..utils.native_audio import load_wav_fast
from .common import add_common_args, build_engine, save_wav
from .tts_with_rag import parse_timbre_map


def _read_batch(stream: TextIO, batch: int, max_wait_ms: float) -> List[dict]:
    """Up to ``batch`` request lines; flushed at EOF or ``max_wait_ms``
    after the first line."""
    out: List[dict] = []
    deadline = None
    while len(out) < batch:
        if deadline is not None:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            if stream is sys.stdin:
                r, _, _ = select.select([stream], [], [], remaining)
                if not r:
                    break
        line = stream.readline()
        if not line:
            break  # EOF
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError as e:
            print(json.dumps({"error": f"bad request line: {e}"}), flush=True)
            continue
        if deadline is None:
            deadline = time.perf_counter() + max_wait_ms / 1000.0
    return out


def _bounded_reader(stream, limit: int, submit):
    """The request reader of the continuous and streaming loops: returns
    ``try_read(block) -> False`` at EOF. It polls stdin without blocking
    while decode work is in flight and takes at most ``limit`` lines a
    tick, so a file's requests are not all featurized before the first
    scheduler step. A bad line reports ``{"error": ...}`` and the loop goes
    on."""

    def try_read(block: bool) -> bool:
        taken = 0
        while taken < limit:
            if stream is sys.stdin and not block:
                r, _, _ = select.select([stream], [], [], 0)
                if not r:
                    return True
            line = stream.readline()
            if not line:
                return False
            block = False
            line = line.strip()
            if not line:
                continue
            taken += 1
            try:
                submit(json.loads(line))
            except Exception as e:  # noqa: BLE001 — one request's failure is its own
                print(json.dumps({"error": str(e)}), flush=True)
        return True

    return try_read


def _featurizer(engine, prompt_of):
    """A request with its ``style_feat`` / ``flow_feat`` (``PromptFeatures``;
    wavs featurized here) and its arrival time ``_t0``."""

    def featurize_req(req: dict) -> dict:
        req["_t0"] = time.perf_counter()
        for key, kind in (("style_feat", "style"), ("flow_feat", "timbre")):
            v = prompt_of(req, kind)
            req[key] = v if hasattr(v, "tokens") else engine.prompt_features([np.asarray(v).reshape(-1)])[0]
        return req

    return featurize_req


def _serve_streaming(args, engine, stream, result_dir: Path, prompt_of, out_sr: int) -> None:
    """--continuous --stream: every request is a live streaming session.
    One JSONL line an audio chunk (``{"id", "chunk", "wav", "samples"}``,
    ``"ttfb_ms"`` on the first) and, when a session completes, one line
    with its stitched wav."""
    from ..pipeline.stream_serve import StreamingScheduler

    sch = StreamingScheduler(engine, slots=args.slots, max_seconds=args.max_seconds, p_max=args.p_max)
    meta: dict = {}
    featurize_req = _featurizer(engine, prompt_of)

    def submit(raw: dict) -> None:
        req = featurize_req(raw)
        sid = sch.submit(req)
        meta[sid] = {"req": req, "chunks": [], "n": 0, "rid": str(req.get("id", sid))}

    try_read = _bounded_reader(stream, args.slots, submit)
    served = 0
    eof = False
    while True:
        if not eof:
            eof = not try_read(block=sch.idle)
        if eof and sch.idle:
            break
        for ev in sch.step():
            m = meta[ev.session]
            t0 = m["req"].get("_t0", time.perf_counter())
            if ev.kind == "chunk":
                cp = result_dir / f"{m['rid']}.chunk{m['n']:03d}.wav"
                save_wav(cp, ev.wav, engine)
                line = {"id": m["rid"], "chunk": m["n"], "wav": str(cp), "samples": int(ev.wav.size)}
                if m["n"] == 0:
                    line["ttfb_ms"] = round((time.perf_counter() - t0) * 1000, 1)
                print(json.dumps(line), flush=True)
                m["chunks"].append(ev.wav)
                m["n"] += 1
            elif ev.kind == "error":
                print(json.dumps({"id": m["rid"], "error": ev.error}), flush=True)
            else:  # done
                wav = np.concatenate(m["chunks"]) if m["chunks"] else np.zeros(0, np.float32)
                out = result_dir / f"{m['rid']}.wav"
                save_wav(out, wav, engine)
                served += 1
                print(json.dumps({"id": m["rid"], "wav": str(out), "samples": int(wav.size), "chunks": m["n"],
                                  "audio_s": round(wav.size / out_sr, 3),
                                  "latency_ms": round((time.perf_counter() - t0) * 1000, 1)}), flush=True)
    print(json.dumps({"served": served, "done": True}), flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--requests", type=str, default="-", help="request JSONL path, or '-' for stdin")
    p.add_argument("--result_dir", type=str, required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max_wait_ms", type=float, default=100.0)
    p.add_argument("--style_db", type=str, default=None,
                   help="StyleStore snapshot (enables style_index requests)")
    p.add_argument("--timbre_map", type=str, default=None,
                   help="'id=path,...' or JSON: the registered timbre_id values")
    p.add_argument("--max_seconds", type=float, default=20.0)
    p.add_argument("--continuous", action="store_true",
                   help="iteration-level continuous batching: requests join a live slot pool "
                        "mid-decode instead of waiting for the current batch (pipeline/continuous.py)")
    p.add_argument("--slots", type=int, default=4, help="--continuous: concurrent decode slots")
    p.add_argument("--chunk", type=int, default=32, help="--continuous: decode steps between scheduler ticks")
    p.add_argument("--p_max", type=int, default=384,
                   help="--continuous: prefix budget (text + style tokens); longer requests are "
                        "rejected one by one")
    p.add_argument("--stream", action="store_true",
                   help="with --continuous: emit audio chunks as each session decodes "
                        "(pipeline/stream_serve.py); chunk files land next to the final wav")
    args = p.parse_args(argv)

    engine = build_engine(args)
    sr = engine.cfg.audio.prompt_sample_rate
    out_sr = engine.cfg.audio.sample_rate
    result_dir = Path(args.result_dir)
    result_dir.mkdir(parents=True, exist_ok=True)
    store = StyleStore.load(args.style_db, device=engine.device) if args.style_db else None
    timbres: Dict[str, np.ndarray] = {}
    if args.timbre_map:
        timbres = {k: load_wav_fast(v, sr) for k, v in parse_timbre_map(args.timbre_map).items()}
    wav_cache: Dict[str, np.ndarray] = {}

    def prompt_of(req: dict, kind: str):
        """kind in {style, timbre}: the request's wav, DB row or registered id
        as a wav or ``PromptFeatures``."""
        if kind == "style" and "style_index" in req:
            if store is None:
                raise ValueError("style_index requires --style_db")
            return engine.prompt_features_from_store(store, [int(req["style_index"])])[0]
        if kind == "timbre" and "timbre_id" in req:
            return timbres[str(req["timbre_id"])]
        path = req[f"{kind}_wav"]
        if path not in wav_cache:
            wav_cache[path] = load_wav_fast(path, sr)
        return wav_cache[path]

    served = 0

    def emit(req: dict, wav: np.ndarray, t0: float) -> None:
        nonlocal served
        rid = str(req.get("id", served))
        out = result_dir / f"{rid}.wav"
        save_wav(out, wav, engine)
        served += 1
        print(json.dumps({"id": rid, "wav": str(out), "samples": int(wav.size),
                          "audio_s": round(wav.size / out_sr, 3),
                          "latency_ms": round((time.perf_counter() - t0) * 1000, 1)}), flush=True)

    stream = sys.stdin if args.requests == "-" else open(args.requests, encoding="utf-8")
    try:
        if args.continuous and args.stream:
            _serve_streaming(args, engine, stream, result_dir, prompt_of, out_sr)
            return
        if args.continuous:
            from ..pipeline.continuous import ContinuousBatcher

            batcher = ContinuousBatcher(engine, slots=args.slots, chunk=args.chunk, p_max=args.p_max,
                                        max_new=int(args.max_seconds * engine.cfg.token_lm.token_rate))
            featurize_req = _featurizer(engine, prompt_of)
            try_read = _bounded_reader(stream, args.slots, lambda raw: batcher.submit(featurize_req(raw)))
            eof = False
            while True:
                if not eof:
                    # block for input only when nothing is in flight
                    eof = not try_read(block=batcher.idle)
                if eof and batcher.idle:
                    break
                finished = batcher.step()
                for req, wav in zip(finished, engine.synthesize_from_tokens(finished, max_seconds=args.max_seconds)):
                    emit(req, wav, req.get("_t0", time.perf_counter()))
                for req in batcher.take_rejected():
                    print(json.dumps({"id": req.get("id"), "error": req["error"]}), flush=True)
            print(json.dumps({"served": served, "done": True}), flush=True)
            return
        while True:
            requests = _read_batch(stream, args.batch, args.max_wait_ms)
            if not requests:
                break
            t0 = time.perf_counter()
            texts, stexts, styles, timbs, good = [], [], [], [], []
            for req in requests:
                try:
                    style, timbre = prompt_of(req, "style"), prompt_of(req, "timbre")
                    texts.append(req["text"])
                except Exception as e:  # noqa: BLE001 — one request's failure is its own
                    print(json.dumps({"id": req.get("id"), "error": str(e)}), flush=True)
                    continue
                styles.append(style)
                timbs.append(timbre)
                stexts.append(req.get("style_text", ""))
                good.append(req)
            if not good:
                continue
            try:
                wavs = engine.synthesize_batch(texts, stexts, styles, timbs, max_seconds=args.max_seconds)
            except Exception as e:  # noqa: BLE001 — the batch's failure is reported a request at a time
                for req in good:
                    print(json.dumps({"id": req.get("id"), "error": str(e)}), flush=True)
                continue
            for req, wav in zip(good, wavs):
                emit(req, wav, t0)
        print(json.dumps({"served": served, "done": True}), flush=True)
    finally:
        if stream is not sys.stdin:
            stream.close()


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
