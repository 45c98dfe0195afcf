"""The streamed cell at a tiny configuration on the CPU: a sound run is
correct; the control (the reference one precision step below, put in the
program's place) reads well above the program; a stream whose token is
altered where drawn, that loses a chunk, renders a window without the
previous chunk's mel under its context, or leaves the decode path its
configuration states, is not correct."""

from __future__ import annotations

import pytest
import torch

from portbench.bench.harness import run_cell
from portbench.programs import tts as program
from portbench.tests.tiny import TinyCell

SEED = 2 ** 31 + 41
FLOOR = {"lm_gap": 0.05, "chunks_rel_err": 1e-5, "search_err": 1e-6, "tok_mismatch": 0.5, "spk_err": 1e-5,
         "mel_err": 1e-4, "off_path": 0.0}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sound():
    """A sound run and limits four times its readings (or the floor)."""
    res = run_cell(TinyCell("b1-stream"), SEED, 1.5, False, 0.0, device="cpu")
    return res, {k: max(4 * v, FLOOR[k]) for k, v in res["_nums"].items()}


def test_a_sound_stream_is_correct(sound):
    res, limits = sound
    ok = run_cell(TinyCell("b1-stream", limits=limits), SEED + 1, 1.5, False, 0.0, device="cpu")
    assert ok["correct"], ok["compared"]
    assert ok["compared"]["off_path"]["value"] == 0 and ok["compared"]["chunks_rel_err"]["value"] < 1e-4
    rec = ok["_run"].records[0]
    assert 0 < rec["ttfa_ms"] < rec["wall_ms"] and len(rec["chunk_ms"]) == len(rec["kept"]["chunks"]) > 1


def test_the_control_reads_above_the_program(sound):
    res, _ = sound
    sess = res["_session"]
    ctl = program.numbers(sess, res["_run"], program.Reference(sess.cfg, SEED, "cpu", control=True,
                                                               **program.reference_args(sess)))
    prog = res["_nums"]
    for k in ("lm_gap", "chunks_rel_err", "search_err", "spk_err", "mel_err"):
        assert ctl[k] > 3 * max(prog[k], FLOOR[k] / 4), (k, prog[k], ctl[k])


def plant(monkeypatch, fault: str) -> None:
    """Break the stream underneath the harness, where it produces its chunks."""
    from autostyle_tts_tpu_torch.models import token_lm
    from autostyle_tts_tpu_torch.pipeline.engine import Engine

    if fault == "token":               # a token altered where it is drawn: each chunk's first is BOS, never served
        take0 = token_lm.take
        bos = TinyCell("b1-stream").cfg["token_lm"]["speech_vocab_size"] - 3

        def take(*a, **k):
            steps, gen = take0(*a, **k)
            return ([[bos]] + steps[1:] if steps else steps), gen

        monkeypatch.setattr(token_lm, "take", take)
    elif fault == "drop_chunk":        # the second chunk never reaches the client
        stream0 = Engine._synthesize_stream

        def stream(self, *a, **k):
            for i, wav in enumerate(stream0(self, *a, **k)):
                if i != 1:
                    yield wav

        monkeypatch.setattr(Engine, "_synthesize_stream", stream)
    elif fault == "no_context":        # each window in-paints zeros where the previous chunk's mel belongs
        render0 = Engine.render_windows

        def render(self, tokens, emitted, prompts, mel_ctx, chunk, **k):
            return render0(self, tokens, emitted, prompts, torch.zeros_like(mel_ctx), chunk, **k)

        monkeypatch.setattr(Engine, "render_windows", render)
    else:
        raise ValueError(fault)


def test_an_int4_stream_on_the_int8_step_is_off_path(monkeypatch, sound):
    _, limits = sound
    ok = run_cell(TinyCell("b1-stream", limits=limits, int4=True), SEED, 1.5, False, 0.0, device="cpu")
    assert ok["compared"]["off_path"]["value"] == 0
    config0 = program.port_config

    def config(cfg):
        c = config0(cfg)
        c.quantize_lm_int4 = False
        return c

    monkeypatch.setattr(program, "port_config", config)
    bad = run_cell(TinyCell("b1-stream", limits=limits, int4=True), SEED, 1.5, False, 0.0, device="cpu")
    assert not bad["correct"] and bad["compared"]["off_path"]["value"] >= 1


@pytest.mark.parametrize("fault,number", [("token", "lm_gap"), ("drop_chunk", "chunks_rel_err"),
                                          ("no_context", "chunks_rel_err")])
def test_a_broken_stream_is_not_correct(monkeypatch, sound, fault, number):
    _, limits = sound
    plant(monkeypatch, fault)
    bad = run_cell(TinyCell("b1-stream", limits=limits), SEED + 1, 1.5, False, 0.0, device="cpu")
    assert not bad["correct"]
    assert bad["compared"][number]["value"] > limits[number], bad["compared"]
