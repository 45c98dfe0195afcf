"""How far the golden-wav statistics move with the CFM's noise, on the JAX
engine and on the PyTorch port, for the trained demo engine.

  JAX_PLATFORMS=cpu python scripts/golden_spread.py [--seeds 8]

Each of the first three corpus-sample rows is converted to its own voice
(``inference_vc``) on the CPU, by the JAX engine under ``--seeds`` keys
(the key a fresh ``Engine(seed=s)`` holds, s = 0, 1, ...) and by the port
under as many generator seeds (its engine's generator seeded as a fresh
``Engine(seed=s)`` seeds it). The two random streams differ, so the draws
differ: this compares the spread of each side's statistics over its own
draws, not draw by draw. For each row and seed it prints the mean over
the mel bins of |delta mel mean| and of |delta mel std| against
``tests/fixtures/golden_quality.json`` (the golden gate's limit is 0.3 for
each), then per row and side the mean, the largest value and how many
draws exceed 0.3.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
LIMIT = 0.3


def stats(mel: np.ndarray, g: dict):
    return (float(np.abs(mel.mean(0) - np.asarray(g["mel_mean"])).mean()),
            float(np.abs(mel.std(0) - np.asarray(g["mel_std"])).mean()))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    n_seeds = ap.parse_args().seeds

    import jax
    import jax.numpy as jnp
    import torch

    from autostyle_tts_tpu.ops import stft as jstft
    from autostyle_tts_tpu.pipeline import engine as jengine
    from autostyle_tts_tpu.utils import config as jconfig
    from autostyle_tts_tpu_torch.ops import stft as tstft
    from autostyle_tts_tpu_torch.pipeline import engine as tengine
    from autostyle_tts_tpu_torch.utils.audio_io import read_wav
    from autostyle_tts_tpu_torch.utils.config import demo_config
    from autostyle_tts_tpu_torch.weights import from_jax_tree, load_npz

    fixtures = REPO / "tests" / "fixtures"
    sample = fixtures / "demo_corpus_sample"
    golden = json.loads((fixtures / "golden_quality.json").read_text())
    rows = json.loads((sample / "manifest.json").read_text())[:3]
    tree = load_npz(fixtures / "demo_engine.npz")
    cfg = demo_config()
    a = cfg.audio
    jeng = jengine.Engine(jconfig.demo_config(), seed=0, params=jengine.EngineParams.from_tree(
        jax.tree_util.tree_map(jnp.asarray, tree)))
    teng = tengine.Engine(cfg, params=tengine.EngineParams.from_tree(from_jax_tree(tree, cfg)), device="cpu")

    def jax_mel(wav):
        return np.asarray(jstft.log_mel_spectrogram(jnp.asarray(wav[None]), a.sample_rate, a.n_fft, a.hop_length,
                                                    a.win_length, n_mels=a.n_mels, fmax=a.fmax))[0]

    def port_mel(wav):
        return tstft.log_mel_spectrogram(torch.from_numpy(wav[None]), a.sample_rate, a.n_fft, a.hop_length,
                                         a.win_length, n_mels=a.n_mels, fmax=a.fmax)[0].numpy()

    summary = {}
    for row in rows:
        src, _ = read_wav(sample / row["wav"])
        g = golden[row["wav"]]
        for s in range(n_seeds):
            jeng.key = jax.random.PRNGKey(s + 17)         # a fresh Engine(seed=s)'s key
            teng.generator.manual_seed(s + 17)            # a fresh Engine(seed=s)'s generator
            jwav = np.asarray(next(jeng.inference_vc(src, src))["tts_speech"]).ravel().astype(np.float32)
            twav = next(teng.inference_vc(src, src))["tts_speech"].ravel()
            for side, mel in (("jax", jax_mel(jwav)), ("port", port_mel(twav))):
                dmean, dstd = stats(mel, g)
                summary.setdefault((row["wav"], side), []).append((dmean, dstd))
                print(json.dumps(dict(wav=row["wav"], side=side, seed=s, d_mel_mean=dmean, d_mel_std=dstd)),
                      flush=True)
    for (wav, side), vals in summary.items():
        v = np.asarray(vals)
        print(json.dumps(dict(wav=wav, side=side, draws=len(v), d_mel_mean_avg=float(v[:, 0].mean()),
                              d_mel_mean_max=float(v[:, 0].max()), d_mel_std_avg=float(v[:, 1].mean()),
                              d_mel_std_max=float(v[:, 1].max()),
                              over_limit=int(((v[:, 0] >= LIMIT) | (v[:, 1] >= LIMIT)).sum()))))


if __name__ == "__main__":
    main()
