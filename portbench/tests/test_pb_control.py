"""The control and the faults at a tiny configuration on the CPU: the
reference one precision step below the configuration's, put in the
program's place, and runs whose timed path is broken underneath, must
both come out not correct; a sound run must come out correct."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.programs import tts as program
from portbench.bench.harness import run_cell
from portbench.tests.tiny import TinyCell

FLOOR = {"lm_gap": 0.05, "wav_rel_err": 1e-5, "search_err": 1e-6, "tok_mismatch": 0.5, "spk_err": 1e-5, "mel_err": 1e-4,
         "off_path": 0.0}
SEED = 2 ** 31 + 21


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def sound_limits(traffic: str, int4: bool = False) -> dict:
    nums = run_cell(TinyCell(traffic, int4=int4), SEED + 1, 1.5, False, 0.0, device="cpu")["_nums"]
    return {k: max(4 * v, FLOOR[k]) for k, v in nums.items()}


@pytest.mark.parametrize("traffic", ["b1-db", "b1-wav", "batch8"])
def test_control_reads_above_the_program(traffic):
    res = run_cell(TinyCell(traffic), SEED, 1.5, False, 0.0, device="cpu")
    args = program.reference_args(res["_session"])
    ctl = program.numbers(res["_session"], res["_run"], program.Reference(res["_session"].cfg, SEED, "cpu",
                                                                          control=True, **args))
    prog = res["_nums"]
    for k in ("lm_gap", "wav_rel_err", "spk_err", "mel_err") + (("search_err",) if traffic != "b1-wav" else ()):
        assert ctl[k] > 3 * max(prog[k], FLOOR[k] / 4), (k, prog[k], ctl[k])


def plant(monkeypatch, fault: str) -> None:
    """Break the program underneath the harness, where it produces its answer."""
    from autostyle_tts_tpu_torch.models import token_lm
    from autostyle_tts_tpu_torch.pipeline.engine import Engine

    if fault == "token":              # a token altered where it is drawn: BOS, which is never served
        gen0 = token_lm.generate_speech_from_ids

        def gen(*a, **k):
            out = gen0(*a, **k)
            t = out.tokens.clone()
            t[0, min(3, t.shape[1] - 1)] = a[1].speech_bos
            return out._replace(tokens=t)

        monkeypatch.setattr(token_lm, "generate_speech_from_ids", gen)
    elif fault == "drop_audio":       # an answer lost: the wav comes back silent
        tts0 = Engine.inference_tts_with_st

        def tts(self, *a, **k):
            for out in tts0(self, *a, **k):
                yield dict(out, tts_speech=np.zeros_like(out["tts_speech"]))

        monkeypatch.setattr(Engine, "inference_tts_with_st", tts)
    elif fault == "feature":          # an answer of featurize altered
        feat0 = Engine.prompt_features

        def feat(self, *a, **k):
            out = feat0(self, *a, **k)
            out[0].spk = out[0].spk[::-1].copy()
            return out

        monkeypatch.setattr(Engine, "prompt_features", feat)
    elif fault == "half_batch":       # half of the batch left out, answered with the other half's audio
        batch0 = Engine.synthesize_batch

        def batch(self, texts, *a, **k):
            wavs = batch0(self, texts, *a, **k)
            B = len(wavs)
            return wavs[: B // 2] + wavs[: B - B // 2]

        monkeypatch.setattr(Engine, "synthesize_batch", batch)
    elif fault in ("int8_step", "bf16_kv"):   # the program leaves the decode path its configuration states
        config0 = program.port_config

        def config(cfg):
            c = config0(cfg)
            if fault == "int8_step":
                c.quantize_lm_int4 = False
            else:
                c.quantize_lm_kv_int8 = False
            return c

        monkeypatch.setattr(program, "port_config", config)
    else:
        raise ValueError(fault)


@pytest.mark.parametrize("traffic,int4,fault,number", [
    ("b1-db", False, "token", "lm_gap"),
    ("b1-db", False, "drop_audio", "wav_rel_err"),
    ("b1-wav", False, "feature", "spk_err"),
    ("batch8", False, "half_batch", "wav_rel_err"),
    ("batch8", False, "token", "lm_gap"),
    ("b1-db", True, "int8_step", "off_path"),
    ("batch8", False, "bf16_kv", "off_path"),
])
def test_a_broken_run_is_not_correct(monkeypatch, traffic, int4, fault, number):
    limits = sound_limits(traffic, int4)
    ok = run_cell(TinyCell(traffic, limits=limits, int4=int4), SEED, 1.5, False, 0.0, device="cpu")
    assert ok["correct"], ok["compared"]
    assert ok["compared"]["off_path"]["value"] == 0
    plant(monkeypatch, fault)
    bad = run_cell(TinyCell(traffic, limits=limits, int4=int4), SEED, 1.5, False, 0.0, device="cpu")
    assert not bad["correct"]
    assert bad["compared"][number]["value"] > limits[number]
