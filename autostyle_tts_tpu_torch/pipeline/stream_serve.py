"""Concurrent streaming serving: N live sessions share one slot-pool decode.

Counterpart of the JAX ``pipeline/stream_serve.py``. A
``ContinuousBatcher`` decodes every session's tokens; each tick, every
session with a full chunk of tokens it has not heard yet (or the rest of
them, once its decode is done) gets its next audio chunk from the engine's
stream window (``Engine.render_windows``, the window ``_synthesize_stream``
renders), all such sessions of one flow-prompt bucket in one call with one
host fetch, each with its own mel context. So N callers each hear audio
while the other sessions are still decoding.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.sampling import SamplerConfig
from .continuous import ContinuousBatcher

_SS_KEY = "_stream_session"


@dataclass
class _Session:
    req: dict
    flow_feat: object
    tokens: List[int] = field(default_factory=list)
    emitted: int = 0
    mel_ctx: Optional[torch.Tensor] = None     # [1, chunk * up, M] the last chunk's mel
    decode_done: bool = False
    done: bool = False


@dataclass
class StreamEvent:
    """One scheduler output: a "chunk" carries f32 samples at the output
    rate; "done" closes the session; "error" says why it never started
    (the wav is empty for both)."""

    session: str
    kind: str              # "chunk" | "done" | "error"
    wav: np.ndarray
    error: str = ""


class StreamingScheduler:
    """``submit`` -> session id; ``step`` -> list of ``StreamEvent``. A
    serving loop calls ``step`` while there is work (``idle`` says when
    there is none); ``run`` drives it to the end. ``sampler`` and
    ``min_tokens`` (EOS masked until a session has drawn that many) go to
    the batcher."""

    def __init__(
        self,
        engine,
        slots: int = 4,
        chunk_tokens: Optional[int] = None,
        max_seconds: float = 20.0,
        sampler: SamplerConfig = SamplerConfig(temperature=1.0, top_k=25),
        p_max: int = 384,
        min_tokens: int = 2,
    ):
        self.engine = engine
        tl = engine.cfg.token_lm
        # one audio chunk a decode chunk: the batcher's tick is the stream's cadence
        self.chunk = chunk_tokens or max(8, (2 * tl.token_rate) // 3)
        self.max_new = int(max_seconds * tl.token_rate)
        self.bat = ContinuousBatcher(engine, slots=slots, chunk=self.chunk, p_max=p_max,
                                     sampler=sampler, min_tokens=min_tokens, max_new=self.max_new)
        self.sessions: Dict[str, _Session] = {}        # live
        self.finished: Dict[str, _Session] = {}        # until take_finished
        self._next = 0

    # ------------------------------------------------------------------ intake

    def submit(self, req: dict) -> str:
        """``req``: the ``ContinuousBatcher`` request (``"text"``,
        ``"style_text"``, ``"style_feat"``, ``"flow_feat"``, optional
        ``"max_tokens"``). Returns the session id."""
        sid = f"s{self._next}"
        self._next += 1
        breq = dict(req, **{_SS_KEY: sid})
        breq.setdefault("id", sid)
        self.sessions[sid] = _Session(req=breq, flow_feat=req["flow_feat"])
        self.bat.submit(breq)
        return sid

    @property
    def idle(self) -> bool:
        return self.bat.idle and not self.sessions

    def take_finished(self) -> Dict[str, _Session]:
        """The completed sessions since the last call (a long-running
        server drains them)."""
        out, self.finished = self.finished, {}
        return out

    # ------------------------------------------------------------------ tick

    def _chunk_due(self, sess: _Session) -> bool:
        avail = len(sess.tokens) - sess.emitted
        return avail > 0 and (avail >= self.chunk or sess.decode_done)

    def _render_batch(self, due: List[_Session]) -> Dict[int, np.ndarray]:
        """The next chunk of every due session: one ``render_windows`` call
        (one noise draw of the engine's generator, one fetch) per
        flow-prompt bucket. -> {index in ``due``: samples}."""
        eng = self.engine
        cfg = eng.cfg
        out: Dict[int, np.ndarray] = {}
        groups: Dict[tuple, List[int]] = {}
        prompts = [eng._flow_stream_dev(sess.flow_feat) for sess in due]
        for i, p in enumerate(prompts):
            groups.setdefault(p.key, []).append(i)
        for idxs in groups.values():
            for i in idxs:
                if due[i].mel_ctx is None:
                    due[i].mel_ctx = torch.zeros((1, self.chunk * cfg.cfm.upsample, cfg.cfm.n_mels),
                                                 dtype=torch.float32, device=eng.device)
            wavs, mel_chunk = eng.render_windows(
                [due[i].tokens for i in idxs], [due[i].emitted for i in idxs], [prompts[i] for i in idxs],
                torch.cat([due[i].mel_ctx for i in idxs]), self.chunk)
            for r, i in enumerate(idxs):
                sess = due[i]
                sess.mel_ctx = mel_chunk[r : r + 1]
                sess.emitted += min(self.chunk, len(sess.tokens) - sess.emitted)
                out[i] = wavs[r]
        return out

    def step(self) -> List[StreamEvent]:
        """Advance the decode by one chunk, then emit every due chunk.
        With no work it returns []."""
        events: List[StreamEvent] = []
        if not self.bat.idle:
            finished = self.bat.step()
            for bad in self.bat.take_rejected():
                sess = self.sessions.get(bad.get(_SS_KEY))
                if sess is not None:
                    sess.done = sess.decode_done = True
                    events.append(StreamEvent(bad[_SS_KEY], "error", np.zeros(0, np.float32),
                                              error=bad.get("error", "")))
            for slot in self.bat.slots:     # live slots: their tokens so far
                if slot.req is not None and slot.req.get(_SS_KEY) in self.sessions:
                    self.sessions[slot.req[_SS_KEY]].tokens = list(slot.tokens)
            for req in finished:
                sess = self.sessions.get(req.get(_SS_KEY, ""))
                if sess is not None:
                    sess.tokens = [int(t) for t in req["tokens"]]
                    sess.decode_done = True
        # at most one chunk a session a tick (the stream's cadence), all of them at once
        order = list(self.sessions)
        due_ids = [sid for sid in order
                   if not self.sessions[sid].done and self._chunk_due(self.sessions[sid])]
        rendered = self._render_batch([self.sessions[sid] for sid in due_ids])
        wavs = {due_ids[i]: w for i, w in rendered.items()}
        for sid in order:
            sess = self.sessions[sid]
            if not sess.done:
                if sid in wavs:
                    events.append(StreamEvent(sid, "chunk", wavs[sid]))
                if sess.decode_done and sess.emitted >= len(sess.tokens):
                    sess.done = True
                    events.append(StreamEvent(sid, "done", np.zeros(0, np.float32)))
            if sess.done:
                sess.mel_ctx = None
                self.finished[sid] = self.sessions.pop(sid)
        return events

    def run(self, max_ticks: int = 10_000) -> Dict[str, List[StreamEvent]]:
        """Drive to the end; the events grouped by session, in order."""
        out: Dict[str, List[StreamEvent]] = {}
        for _ in range(max_ticks):
            if self.idle:
                break
            for ev in self.step():
                out.setdefault(ev.session, []).append(ev)
        return out
