"""Record slices of the JAX package's 3B int8 embedder base, for checks
without JAX.

  JAX_PLATFORMS=cpu python scripts/make_jax_base_probe.py

``artifacts/ft3b/adapter_f16.npz`` was trained over
``init_params_quantized(PRNGKey(42), Config().embedder, bits=8)``. This
script draws slices of that base on the CPU through the same key splits as
``models/transformer.py`` (``split(key, 12)``, then ``split(k, L)`` for a
projection stack, each layer drawn and quantized under ``jax.jit`` as the
package's ``lax.map`` body is), without building the whole base:

- ``tok_emb``: its first ``ROWS`` rows (a draw's element depends only on its
  flat position, so the first rows of a [V, D] draw are a [ROWS, D] draw);
- ``wqkv`` and ``w_down`` of layers 0 and L-1: the int8 values of the
  columns ``COLS`` (every row) and all of the layer's scales.

Writes tests/fixtures/jax_base_probe.npz (keys ``tok_emb``,
``<name>/<layer>/q``, ``<name>/<layer>/s``, ``cols``, ``seed``). The
PyTorch port's draw is held to it: on the CPU by tests/test_torch_rng.py
(the same slices), on the card by chip_smoke.py path M1 (the whole base).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SEED = 42
ROWS = 4
COLS = (0, 1, 2, 3, -4, -3, -2, -1)
PROJ_KEYS = {"wqkv": 1, "w_down": 7}     # index into split(key, 12), as init_params_quantized uses them


def probe_slices(cfg, seed: int = SEED, rows: int = ROWS, cols=COLS, layers=None) -> dict:
    """The slices of ``init_params_quantized(PRNGKey(seed), cfg, bits=8)``
    described in the module docstring, as numpy arrays."""
    import jax

    from autostyle_tts_tpu.models.transformer import _dense_init
    from autostyle_tts_tpu.ops.quant import quantize

    L, D, F = cfg.n_layers, cfg.dim, cfg.ffn_dim
    shapes = {"wqkv": (D, (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim), "w_down": (F, D)}
    layers = (0, L - 1) if layers is None else layers
    keys = jax.random.split(jax.random.PRNGKey(seed), 12)
    out = {"tok_emb": np.asarray(jax.jit(lambda k: _dense_init(k, D, (rows, D)))(keys[0])),
           "cols": np.asarray(cols, np.int64), "seed": np.int64(seed)}
    for name, ki in PROJ_KEYS.items():
        fan_in, fan_out = shapes[name]
        layer_keys = jax.random.split(keys[ki], L)
        draw = jax.jit(lambda k: tuple(quantize(_dense_init(k, fan_in, (fan_in, fan_out)))))
        for l in layers:
            q, s = draw(layer_keys[l])
            out[f"{name}/{l}/q"] = np.asarray(q)[:, list(cols)]
            out[f"{name}/{l}/s"] = np.asarray(s)
    return out


def main() -> None:
    import jax

    from autostyle_tts_tpu.utils.config import Config

    out = probe_slices(Config().embedder)
    path = REPO / "tests" / "fixtures" / "jax_base_probe.npz"
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({path.stat().st_size} bytes; jax {jax.__version__}, "
          f"threefry partitionable {jax.config.jax_threefry_partitionable})")


if __name__ == "__main__":
    main()
