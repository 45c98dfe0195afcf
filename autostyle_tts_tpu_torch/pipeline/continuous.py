"""Iteration-level continuous batching for the token LM: a fixed pool of
decode slots on the device, each at its own position.

Counterpart of the JAX ``pipeline/continuous.py``. Requests wait in a
queue and are admitted into free slots as they free up, in batches: one
prefill (``token_lm.prefill_prefix``, the flash-attention kernel) for every
request admitted at once, written into the pool's cache by one indexed
write. Each ``step`` then advances every slot by ``chunk`` tokens
(``token_lm.decode_chunk``, plain PyTorch), reads the chunk's tokens and
the done flags to the host in one fetch, and hands back the requests that
finished, with their tokens; their audio comes from the engine's batched
CFM and vocoder (``Engine.synthesize_from_tokens``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..models import frontend, token_lm
from ..models import transformer as core
from ..ops.sampling import SamplerConfig
from ..utils.config import Config


@dataclass
class _Slot:
    req: Optional[dict] = None          # the request the slot serves (None: idle)
    tokens: List[int] = field(default_factory=list)


class ContinuousBatcher:
    """Slot-pool LM scheduler over an Engine's token LM.

    ``submit`` queues a request (``{"id", "text", "style_text",
    "style_feat", "flow_feat"}``, optional ``"max_tokens"``); ``step``
    admits queued requests into free slots, decodes one chunk and returns
    the requests that finished, each with ``"tokens"`` (int32). A request
    that cannot be admitted (a prefix longer than ``p_max``, bad features)
    is set aside with ``"error"`` (``take_rejected``); nothing else fails
    with it."""

    def __init__(
        self,
        engine,
        slots: int = 4,
        chunk: int = 32,
        p_max: int = 384,
        sampler: SamplerConfig = SamplerConfig(temperature=1.0, top_k=25),
        min_tokens: int = 2,
        max_new: int = 512,
        kv_int8: Optional[bool] = None,
    ):
        if getattr(engine, "mesh", None) is not None:
            raise ValueError("continuous batching runs on an engine without a mesh")
        self.engine = engine
        cfg: Config = engine.cfg
        self.cfg = cfg
        self.tl = cfg.token_lm
        self.chunk = chunk
        self.p_max = p_max
        self.sampler = sampler
        self.min_tokens = min_tokens
        self.max_new = max_new
        # the int8 KV cache follows the engine's serving config unless set here
        self.kv_int8 = bool(getattr(cfg, "quantize_lm_kv_int8", False) if kv_int8 is None else kv_int8)
        # + chunk: decode_chunk's spare room for one chunk of appended rows
        self.s_max = -(-(p_max + max_new + 1 + chunk) // 8) * 8
        self.n_slots = slots
        dev = engine.device
        self.cache = core.make_cache(token_lm.core_config(self.tl), slots, self.s_max, dev,
                                     quantized=self.kv_int8)
        self.cur_logits = torch.full((slots, self.tl.speech_vocab_size), token_lm.NEG_INF,
                                     dtype=torch.float32, device=dev)
        self.t = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.offset = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.done = torch.ones((slots,), dtype=torch.bool, device=dev)     # every slot idle
        self.steps = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.slots: List[_Slot] = [_Slot() for _ in range(slots)]
        self.queue: List[dict] = []
        self.rejected: List[dict] = []
        self.generator = torch.Generator(device=dev).manual_seed(cfg.seed + 91)

    # ------------------------------------------------------------------ intake

    def submit(self, req: dict) -> None:
        self.queue.append(req)

    def _encode_req(self, req: dict):
        """Tokenize and check one request on the host: (text ids, style
        tokens, speaker embedding). Raises for a prefix beyond ``p_max``;
        an empty style prompt counts as one pad row, as admission builds
        it."""
        eng = self.engine
        full_text = (req.get("style_text", "") + " " + req["text"]).strip()
        ids = frontend.encode(full_text, tokenizer=eng.text_tokenizer, numbers=eng.normalize_numbers)
        sty = np.asarray(req["style_feat"].tokens, np.int32)
        spk = np.asarray(req["flow_feat"].spk, np.float32)
        raw_p = 1 + len(ids) + 1 + max(len(sty), 1)
        if raw_p > self.p_max:
            raise ValueError(f"prefix {raw_p} > p_max {self.p_max} "
                             f"(longer text/style prompt than this batcher was built for)")
        return np.asarray(ids, np.int32), sty, spk

    def _prefix(self, text, t_len, sty, s_len, spk) -> token_lm.Prefix:
        eng = self.engine
        return token_lm.build_prefix_padded(
            eng.params.token_lm, self.tl, *(eng._tensor(a, torch.int32) for a in (text, t_len, sty, s_len)),
            eng._tensor(spk, torch.float32), pad_multiple=self.p_max)

    def _build_prefix(self, req: dict) -> token_lm.Prefix:
        """One request's prefix, padded to ``p_max`` as admission pads it."""
        ids, sty, spk = self._encode_req(req)
        return self._prefix(ids[None], [len(ids)], sty[None], [len(sty)], spk[None])

    def _admit_batch(self, pairs) -> None:
        """Admit [(slot, request), ...] with one prefill and one write into
        the pool. The widths are complementary, as in the reference: style
        tokens bucketed to 64s, text ``p_max - 2 - w_s``, so every prefix is
        ``p_max`` wide. A request whose text outgrows that split is admitted
        alone at its exact widths."""
        items = []
        for b, req in pairs:
            try:
                ids, sty, spk = self._encode_req(req)
                items.append((b, req, ids, sty, spk))
            except Exception as e:      # an oversized prefix, bad features
                self.rejected.append(dict(req, error=str(e)))
        if not items:
            return
        w_s = -(-max(max(len(it[3]) for it in items), 1) // 64) * 64
        w_t = self.p_max - 2 - w_s
        fits = [0 < w_t and len(it[2]) <= w_t for it in items]
        for it, ok in zip(items, fits):
            if not ok:
                self._admit_rows([it], len(it[2]), max(len(it[3]), 1))
        rest = [it for it, ok in zip(items, fits) if ok]
        if rest:
            self._admit_rows(rest, w_t, w_s)

    def _admit_rows(self, items, w_t: int, w_s: int) -> None:
        """One prefill of ``items`` at widths (w_t, w_s), the batch bucketed
        to a power of two (pad rows repeat the last request: their writes
        go to its slot with the same values), then ``_admit_many``."""
        n = len(items)
        bq = 1 << (n - 1).bit_length()
        text = np.zeros((bq, w_t), np.int32)
        t_len = np.zeros((bq,), np.int32)
        sty = np.zeros((bq, w_s), np.int32)
        s_len = np.zeros((bq,), np.int32)
        spk = np.zeros((bq, items[0][4].shape[0]), np.float32)
        bs = np.zeros((bq,), np.int64)
        for j in range(bq):
            b, _, ids, st, sp = items[min(j, n - 1)]
            text[j, : len(ids)], t_len[j] = ids, len(ids)
            sty[j, : len(st)], s_len[j] = st, len(st)
            spk[j], bs[j] = sp, b
        pre = self._prefix(text, t_len, sty, s_len, spk)
        cache_b, logits_b, offset_b = token_lm.prefill_prefix(
            self.engine.params.token_lm, self.tl, pre, s_max=self.s_max, kv_int8=self.kv_int8)
        self._admit_many(self.engine._tensor(bs, torch.int64), cache_b, logits_b, offset_b)
        for b, req, *_ in items:
            self.slots[b] = _Slot(req=req)

    def _admit_many(self, bs: torch.Tensor, cache_b, logits_b, offset_b) -> None:
        """Slots ``bs`` take the freshly prefilled rows (in place)."""
        for name, buf in self.cache.items():
            buf[:, bs] = cache_b[name]
        self.cur_logits[bs] = logits_b
        self.t[bs] = self.p_max
        self.offset[bs] = offset_b
        self.done[bs] = False
        self.steps[bs] = 0

    def _mark_idle(self, b: int) -> None:
        """Slot b draws pad until it is refilled."""
        self.done[b] = True

    # ------------------------------------------------------------------ one scheduler tick

    @property
    def idle(self) -> bool:
        return not self.queue and all(s.req is None for s in self.slots)

    def take_rejected(self) -> List[dict]:
        """The requests that failed admission since the last call, each with
        ``"error"``."""
        out, self.rejected = self.rejected, []
        return out

    def step(self) -> List[dict]:
        """Admit queued requests into free slots, decode one chunk, and
        return the requests that finished, each with ``"tokens"``."""
        while self.queue:
            free = [b for b in range(self.n_slots) if self.slots[b].req is None]
            if not free:
                break
            pairs = []
            while free and self.queue:
                pairs.append((free.pop(0), self.queue.pop(0)))
            self._admit_batch(pairs)     # rejected pairs leave their slots free
        if all(s.req is None for s in self.slots):
            return []
        self.cache, self.cur_logits, self.t, self.done, self.steps, toks = token_lm.decode_chunk(
            self.engine.params.token_lm, self.tl, self.cache, self.cur_logits, self.t, self.offset,
            self.done, self.steps, self.generator, n_steps=self.chunk, sampler=self.sampler,
            min_tokens=self.min_tokens)
        host = torch.cat([toks, self.done[:, None].to(toks.dtype)], dim=1).cpu().numpy()   # one fetch
        toks_h, done_h = host[:, :-1], host[:, -1]
        finished: List[dict] = []
        eos, padt = self.tl.speech_eos, self.tl.speech_pad
        for b, slot in enumerate(self.slots):
            if slot.req is None:
                continue
            for tok in toks_h[b]:
                if tok == padt:
                    continue
                if tok == eos:
                    break
                slot.tokens.append(int(tok))
            cap = min(self.max_new, int(slot.req.get("max_tokens", self.max_new)))
            slot.tokens = slot.tokens[:cap]
            if bool(done_h[b]) or len(slot.tokens) >= cap:
                finished.append(dict(slot.req, tokens=np.asarray(slot.tokens, np.int32)))
                self.slots[b] = _Slot()
                self._mark_idle(b)
        return finished

    def drain(self, max_ticks: int = 10_000) -> List[dict]:
        """Step until every queued request has finished."""
        out: List[dict] = []
        for _ in range(max_ticks):
            if self.idle:
                break
            out.extend(self.step())
        return out
