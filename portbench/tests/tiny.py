"""A tiny configuration and small traffic mixes for the CPU tests: the
port's ``tiny_config()`` with an iSTFT vocoder, the DB and the wav pool cut
down, and short requests."""

from __future__ import annotations

import copy
import json

from portbench.bench.spec import BENCH_DIR


def tiny_cfg(int4: bool = False) -> dict:
    from autostyle_tts_tpu_torch.utils.config import VocoderConfig, tiny_config, to_dict

    cfg = tiny_config()
    cfg.vocoder = VocoderConfig(kind="istft", n_mels=16, istft_hop=32, istft_n_fft=128, istft_channels=32,
                                istft_blocks=2, istft_kernel=7)
    cfg.quantize_lm_int8 = True
    cfg.quantize_lm_kv_int8 = True
    cfg.quantize_lm_int4 = int4
    d = {k: v for k, v in to_dict(cfg).items() if k not in ("embedder", "train", "mesh")}
    d["cfm"]["n_steps"], d["cfm"]["use_cfg"] = 2, False
    flagship = json.loads((BENCH_DIR / "configs" / "flagship-int8.json").read_text())
    d.update(name="tiny", sampler=flagship["sampler"], weights=flagship["weights"], decode=copy.deepcopy(flagship["decode"]))
    d["decode"]["b1"]["weight_bits"] = 4 if int4 else 8
    return d


def tiny_mix(name: str) -> dict:
    mix = copy.deepcopy(json.loads((BENCH_DIR / "workloads" / f"{name}.json").read_text()))
    if mix["batch"] == 1:
        mix["lengths"]["blocks"] = [{"64": 2, "128": 1}]
        mix["check"]["requests"] = 3
    else:
        mix["lengths"]["blocks"] = [[{"64": 3, "128": 1}, {"64": 2, "128": 2}]]
        mix["window_units"] = 2
        mix["batch"] = 4
        mix["check"]["batches"] = 1
    if "db" in mix:
        mix["db"].update(rows=16, capacity=32, dim=32, wavs=4, wav_seconds=[0.5, 2.0])
    if "wav_pool" in mix:
        mix["wav_pool"].update(wavs=4, wav_seconds=[0.5, 2.0])
    mix["noise_bank"] = 2
    return mix


class TinyCell:
    """A cell of the tiny configuration (the ``Cell`` interface the harness reads)."""

    def __init__(self, traffic: str, metrics=(), limits=None, int4: bool = False):
        self.name = f"tiny.{traffic}"
        self.cfg = tiny_cfg(int4)
        self.mix = tiny_mix(traffic)
        self.chips = 1
        self.end_to_end = [{"name": m, "unit": "x"} for m in metrics]
        self.per_layer = []
        self._limits = limits or {}

    def limits(self):
        return dict(self._limits)
