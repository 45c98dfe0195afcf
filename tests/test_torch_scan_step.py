"""The scanned decode's step (``token_lm.ScanStep``) on the CPU at tiny
geometry: run eagerly over its buffers, with the step's slot as a tensor,
it gives the tokens, lengths, decode steps and logits of the loop it
replaced (a bf16 and an int8 KV cache, with and without ``rows``); the
decode span says the graph was not taken; where the captured step may
engage (a card, no model axis); and how captured steps are kept: one per
shape and set of weights, never shared by two live loops, the oldest idle
one dropped, a fresh one's cache zeroed. The capture itself is a CUDA
call: ``tests/test_torch_gpu.py`` holds it against this eager step."""

from __future__ import annotations

import dataclasses
import gc
from types import SimpleNamespace

import pytest
import torch

from autostyle_tts_tpu_torch.models import token_lm
from autostyle_tts_tpu_torch.models import transformer as core
from autostyle_tts_tpu_torch.ops.sampling import sample
from autostyle_tts_tpu_torch.parallel import comm
from autostyle_tts_tpu_torch.utils.config import tiny_config
from autostyle_tts_tpu_torch.utils.timing import Stopwatch
from autostyle_tts_tpu_torch.weights import quantize_tree

from torch_one_thread import one_thread  # noqa: F401  (autouse)

B = 3


def _previous_loop(params, cfg, ccfg, cache, next_logits, generator, offset, *, P,
                   max_new_tokens, sampler, min_tokens, clock, rows=None):
    """The scanned decode as it was before its step became ``ScanStep``:
    the core called with the step's slot as a Python int."""
    draw_rows = None if rows is None else (rows[0], rows[0] + next_logits.shape[0], rows[1])
    dev = next_logits.device
    eos, padt = cfg.speech_eos, cfg.speech_pad
    S_max = cache["k"].shape[2]
    slot = torch.arange(S_max, device=dev)
    valid = slot[None, :] >= offset.long()[:, None]
    n = next_logits.shape[0]
    toks = torch.full((n, max_new_tokens), padt, dtype=torch.int32, device=dev)
    gen_len = torch.zeros((n,), dtype=torch.int32, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    cur, steps = next_logits, 0
    for i in range(max_new_tokens):
        masked = token_lm._mask_logits(cur, cfg, i < min_tokens)
        tok = sample(masked, sampler, generator) if draw_rows is None else sample(masked, sampler, generator,
                                                                                 rows=draw_rows)
        tok = torch.where(done, torch.full_like(tok, padt), tok)
        is_eos = tok == eos
        gen_len += (~done & ~is_eos).to(torch.int32)
        done |= is_eos
        toks[:, i] = tok
        drawn = tok.tolist()
        yield drawn
        if all(t in (eos, padt) for t in drawn):
            break
        mask = (valid & (slot[None, :] <= P + i))[:, None, None, :]
        hidden = core.forward(params, ccfg, inputs_embeds=core.embed(params["speech_emb"], tok,
                                                                     cfg.speech_vocab_size)[:, None, :],
                              positions=(P + i - offset.long())[:, None], mask=mask, cache=cache, cache_start=P + i)
        cur = core.head_logits(hidden[:, 0], params["speech_head"], cfg.speech_vocab_size)
        steps += 1
    return token_lm.SpeechGen(tokens=toks, lengths=gen_len, decode_steps=steps)


def _lm(quant: bool):
    cfg = dataclasses.replace(tiny_config().token_lm, n_kv_heads=2)
    lm = token_lm.init_params(cfg, torch.Generator().manual_seed(2))
    return (quantize_tree(lm) if quant else lm), cfg


def _inputs(cfg):
    g = torch.Generator().manual_seed(3)
    return (torch.randint(16, 200, (B, 12), generator=g, dtype=torch.int32), torch.tensor([12, 7, 3]),
            torch.randint(0, 64, (B, 8), generator=g, dtype=torch.int32), torch.tensor([8, 3, 5]),
            torch.randn((B, cfg.spk_dim), generator=g))


def _decode(lm, cfg, kv_int8, rows, monkeypatch, previous=False):
    """(SpeechGen, each step's logits, the decode span) of one run."""
    seen = []
    mask = token_lm._mask_logits
    monkeypatch.setattr(token_lm, "_mask_logits", lambda logits, *a: seen.append(logits.clone()) or mask(logits, *a))
    if previous:
        def old(step, cfg, next_logits, generator, offset, **kw):
            return _previous_loop(step.params, cfg, step.ccfg, step.cache, next_logits, generator, offset, **kw)
        monkeypatch.setattr(token_lm, "_decode_scan", old)
    clock = Stopwatch(torch.device("cpu"))
    with clock.open("request"):
        gen = token_lm.generate_speech_from_ids(lm, cfg, *_inputs(cfg), torch.Generator().manual_seed(7),
                                                max_new_tokens=20, kv_int8=kv_int8, clock=clock,
                                                rows=rows, min_tokens=4)
    monkeypatch.undo()
    return gen, seen, [s for s in clock.spans if s.name == "decode"][0]


@pytest.mark.parametrize("rows", [None, (1, 5)])
@pytest.mark.parametrize("kv_int8", [False, True])
def test_step_over_its_buffers_matches_the_previous_loop(kv_int8, rows, monkeypatch):
    lm, cfg = _lm(quant=kv_int8)
    got, got_logits, span = _decode(lm, cfg, kv_int8, rows, monkeypatch)
    want, want_logits, _ = _decode(lm, cfg, kv_int8, rows, monkeypatch, previous=True)
    assert torch.equal(got.tokens, want.tokens) and torch.equal(got.lengths, want.lengths)
    assert got.decode_steps == want.decode_steps == span.counters["steps"] > 0
    assert len(got_logits) == len(want_logits) > 0
    for a, b in zip(got_logits, want_logits):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert span.attrs == {"path": "scanned", "kv_int8": kv_int8, "graph": False}
    assert span.counters["graph_replays"] == span.counters["graph_captures"] == 0


def test_graph_step_fits_a_card_without_a_model_axis():
    cpu, card = torch.device("cpu"), torch.device("cuda")
    assert not token_lm.graph_step_fits(cpu)
    assert token_lm.graph_step_fits(card)
    for model, fits in ((2, False), (1, True)):
        prev = comm.activate(SimpleNamespace(model=model, model_rank=0, data=2))
        try:
            assert token_lm.graph_step_fits(card) is fits
            assert not token_lm.graph_step_fits(cpu)
        finally:
            comm.restore(prev)


class _Loop:
    """Stands for a live decode loop (the step holds it weakly)."""


@pytest.fixture
def kept(monkeypatch):
    monkeypatch.setattr(token_lm, "_KEPT_STEPS", [])
    return token_lm._KEPT_STEPS


def _step(lm, cfg, S_max=40, kv_int8=True, B=2):
    return token_lm.graph_step(lm, cfg, token_lm.core_config(cfg), B, S_max, kv_int8, cfg.n_kv_heads,
                               torch.device("cpu"))


def test_captured_steps_are_kept_per_shape_and_weights(kept):
    lm, cfg = _lm(quant=True)
    a = _step(lm, cfg)
    assert a.capturable and a.cache["k"].shape[2] == token_lm.GRAPH_SLOTS and a.idle
    assert all(not bool(t.any()) for t in a.cache.values())
    assert _step(lm, cfg, S_max=token_lm.GRAPH_SLOTS) is a        # the same slot bucket
    assert _step(lm, cfg, S_max=token_lm.GRAPH_SLOTS + 8) is not a
    assert _step(lm, cfg, kv_int8=False) is not a
    assert _step(lm, cfg, B=3) is not a
    other, _ = _lm(quant=True)
    assert _step(other, cfg) is not a                              # other weights
    assert _step(dict(lm), cfg) is a                               # the same tensors in another dict
    assert len(kept) == 5


def test_live_loops_of_one_shape_do_not_share_a_step(kept):
    lm, cfg = _lm(quant=True)
    a = _step(lm, cfg)
    first = _Loop()
    a.hold(first)
    b = _step(lm, cfg)
    assert b is not a and not a.idle
    second = _Loop()
    b.hold(second)
    a.release()                       # the first loop ended
    assert _step(lm, cfg) is a
    a.hold(first)
    del second
    gc.collect()
    assert b.idle and _step(lm, cfg) is b          # a dropped loop frees its step


def test_oldest_idle_step_is_dropped_and_all_busy_is_eager(kept, monkeypatch):
    monkeypatch.setattr(token_lm, "MAX_KEPT_STEPS", 2)
    lm, cfg = _lm(quant=True)
    loops = [_Loop(), _Loop()]
    a = _step(lm, cfg, B=1)
    b = _step(lm, cfg, B=2)
    c = _step(lm, cfg, B=3)               # drops a, the oldest idle
    assert kept == [b, c]
    b.hold(loops[0])
    c.hold(loops[1])
    assert _step(lm, cfg, B=4) is None    # every kept step busy: the caller takes the eager step
    assert a not in kept


def test_prefill_writes_into_the_kept_step(kept, monkeypatch):
    """Where the captured step may engage, the prefill fills its cache and
    the loop holds it until it ends; its result is the eager loop's."""
    lm, cfg = _lm(quant=True)
    want = token_lm.generate_speech_from_ids(lm, cfg, *_inputs(cfg), torch.Generator().manual_seed(7),
                                             max_new_tokens=12, kv_int8=True)
    monkeypatch.setattr(token_lm, "graph_step_fits", lambda dev: True)
    monkeypatch.setattr(token_lm.ScanStep, "capture", lambda self: self.forward())   # no card here
    ids = _inputs(cfg)
    pre = token_lm.pad_prefix(token_lm.build_prefix(lm, cfg, *ids))
    loop = token_lm.start_decode(lm, cfg, pre, torch.Generator().manual_seed(7), max_new_tokens=12, kv_int8=True)
    (step,) = kept
    assert not step.idle and bool(step.cache["k"].any())
    gen = token_lm.finish(loop)
    assert step.idle
    assert torch.equal(gen.tokens, want.tokens) and gen.decode_steps == want.decode_steps


def test_interleaved_loops_of_one_shape_keep_their_own_steps(kept, monkeypatch):
    """Two live loops of one shape advanced in turns (two interleaved
    streams) hold two kept steps and give each its own run's tokens."""
    lm, cfg = _lm(quant=True)
    monkeypatch.setattr(token_lm, "graph_step_fits", lambda dev: True)
    monkeypatch.setattr(token_lm.ScanStep, "capture", lambda self: self.forward())   # no card here
    ids = _inputs(cfg)
    other = (ids[0].flip(0), ids[1].flip(0), ids[2].flip(0), ids[3].flip(0), ids[4].flip(0))
    kw = dict(max_new_tokens=12, kv_int8=True)
    alone = [token_lm.generate_speech_from_ids(lm, cfg, *x, torch.Generator().manual_seed(s), **kw)
             for x, s in ((ids, 1), (other, 2))]
    assert len(kept) == 1 and kept[0].idle
    loops = [token_lm.start_decode(lm, cfg, token_lm.pad_prefix(token_lm.build_prefix(lm, cfg, *x)),
                                   torch.Generator().manual_seed(s), **kw) for x, s in ((ids, 1), (other, 2))]
    assert len(kept) == 2 and not any(s.idle for s in kept)
    gens = [None, None]
    while None in gens:
        for j, loop in enumerate(loops):
            if gens[j] is None:
                _, gens[j] = token_lm.take(loop, 1)
    for g, a in zip(gens, alone):
        assert torch.equal(g.tokens, a.tokens) and torch.equal(g.lengths, a.lengths)
    assert all(s.idle for s in kept)
