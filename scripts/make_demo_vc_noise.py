"""Record the CFM noise the JAX engine draws for the demo's golden rows.

  JAX_PLATFORMS=cpu python scripts/make_demo_vc_noise.py

For each of the first three corpus-sample rows, a fresh JAX
``Engine(demo_config(), seed=0)`` converts the row to its own voice
(``inference_vc``): its key PRNGKey(17) is split once and
``jax.random.normal`` draws the CFM's initial noise [1, F, n_mels], F =
(token bucket of the prompt + generation bucket of the source) x upsample.
Writes those draws to tests/fixtures/demo_vc_noise.npz (one array per wav
file stem), so that a program without JAX, such as the PyTorch port on a
GPU, can run the golden-statistics check of
tests/fixtures/golden_quality.json on the noise the statistics were made
with. tests/test_torch_trained_demo.py checks the file against a fresh draw.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> None:
    import jax
    import jax.numpy as jnp

    from autostyle_tts_tpu.pipeline import engine as jengine
    from autostyle_tts_tpu.utils.checkpoint import load_pytree
    from autostyle_tts_tpu.utils.config import demo_config
    from autostyle_tts_tpu.utils.native_audio import load_wav_fast

    fixtures = REPO / "tests" / "fixtures"
    sample = fixtures / "demo_corpus_sample"
    cfg = demo_config()
    init = jengine.EngineParams.init(jax.random.PRNGKey(0), cfg)
    tree = load_pytree(fixtures / "demo_engine.npz", init.tree())
    params = jengine.EngineParams.from_tree(
        jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), tree))
    eng = jengine.Engine(cfg, params=params, seed=0)
    out = {}
    for row in json.loads((sample / "manifest.json").read_text())[:3]:
        src = load_wav_fast(str(sample / row["wav"]), cfg.audio.prompt_sample_rate)
        n = len(eng.prompt_features([src])[0].tokens)
        fp_w = jengine._bucket(n, jengine.TOKEN_BUCKETS)
        max_new = jengine._bucket(n, jengine.GEN_BUCKETS)
        _, sub = jax.random.split(jax.random.PRNGKey(0 + 17))
        shape = (1, (fp_w + max_new) * cfg.cfm.upsample, cfg.cfm.n_mels)
        out[Path(row["wav"]).stem] = np.asarray(jax.random.normal(sub, shape, jnp.float32))
        print(row["wav"], "tokens", n, "noise", shape)
    np.savez(fixtures / "demo_vc_noise.npz", **out)
    print("->", fixtures / "demo_vc_noise.npz")


if __name__ == "__main__":
    main()
