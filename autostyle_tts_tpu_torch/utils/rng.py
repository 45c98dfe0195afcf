"""JAX-compatible threefry keys and draws, in plain torch integer ops.

Counterpart of the JAX package's ``utils/rng.py`` (``root_key``,
``named_key``, ``seed_python``) and of the parts of ``jax.random`` that the
embedder's init draws from: ``PRNGKey``, ``split``, ``fold_in``, ``bits``,
``uniform`` and ``truncated_normal``. The same key gives the same bits as
``jax.random`` with ``jax_threefry_partitionable=True`` (JAX's default
since 0.5), so ``init_params_quantized(cfg, PRNGKey(42))`` rebuilds the
base that a JAX-trained LoRA adapter was trained over.

Layouts follow ``jax/_src/prng.py`` and ``jax/_src/random.py`` (JAX 0.9.0,
Apache-2.0):

- a key is ``uint32[2]``, held here as an int64 tensor [2] (values in
  [0, 2**32)); the tensor's device is where every draw from it runs;
- ``PRNGKey(seed)`` is ``[0, seed mod 2**32]``: with 64-bit types off (JAX's
  default) the seed is an int32 before it is split into (hi, lo) words, so
  the high word is 0;
- threefry-2x32 with 20 rounds (``_threefry2x32_lowering``);
- element i of a draw of any shape hashes the counter pair
  (i >> 32, i mod 2**32) (``iota_2x32_shape``): ``split`` keeps both output
  words, ``bits`` XORs them. Element i depends on i alone, so a draw can be
  made at chosen flat positions (``truncated_normal_at``) or in chunks;
- ``uniform``: the top 23 bits as a mantissa in [1, 2), minus 1, then
  ``floats * (maxval - minval) + minval`` as one fused multiply-add (XLA
  fuses it), then ``max(minval, .)``;
- ``truncated_normal``: ``u = uniform(erf(lower / sqrt2), erf(upper /
  sqrt2))`` (the division as XLA compiles it, a product with the f32
  reciprocal), ``sqrt2 * erf_inv(u)``, clamped to the open interval. ``erf``
  and ``erf_inv`` follow XLA's f32 polynomials (the rational ``erf`` clamped
  at 3.7439; Giles' two branches for ``erf_inv``), each Horner step a fused
  multiply-add.

torch has no logical right shift on int32 and few uint32 ops, so the hash
runs in int64 with every result masked to 32 bits. A fused multiply-add is
emulated in float64: the product of two f32 values is exact there, and the
sum is rounded once to f64 and once to f32 (exact for the draws the init
functions make; elsewhere it may differ from a true FMA in the last bit).
The one step that is not bitwise is ``log1p`` inside ``erf_inv``: torch's
and XLA's differ in the last bit on about 1% of inputs, which moves a
truncated normal by at most 2 ulp (``tests/test_torch_rng.py``).
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# elements drawn per pass of a large draw: keeps the int64 temporaries at
# ~128 MB each whatever the shape
_CHUNK = 1 << 24

Shape = Union[int, Sequence[int]]


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 [2] tensor on ``device``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device)


def _threefry(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry-2x32, 20 rounds, on 32-bit words held in int64 tensors
    (keys broadcast against the counters)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_M32)
    return x0, x1


def _hash_counters(key: torch.Tensor, index: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both output words for the flat positions ``index`` (int64)."""
    return _threefry(key[0], key[1], index >> 32, index & _M32)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(int(s) for s in shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: [num, 2] keys."""
    b0, b1 = _hash_counters(key, torch.arange(int(num), dtype=torch.int64, device=key.device))
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    (0, data mod 2**32)."""
    x = torch.tensor([0, int(data) & _M32], dtype=torch.int64, device=key.device)
    b0, b1 = _threefry(key[0], key[1], x[:1], x[1:])
    return torch.cat([b0, b1])


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 values in [0, 2**32)."""
    shape = _shape(shape)
    b0, b1 = _hash_counters(key, torch.arange(math.prod(shape), dtype=torch.int64, device=key.device))
    return (b0 ^ b1).view(shape)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """round_f32(a * b + c) for f32 operands, through float64."""
    return (a.double() * (b.double() if isinstance(b, torch.Tensor) else b)
            + (c.double() if isinstance(c, torch.Tensor) else c)).float()


def _uniform_from_bits(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    span = _f32(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(_fma(floats, span, minval), minval)


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return _uniform_from_bits(random_bits(key, shape), _f32(minval), _f32(maxval))


_ERF_ALPHA = (0.00022905065861350646, 0.0034082910107109506, 0.050955695062380861,
              0.18520832239976145, 1.128379143519084)
_ERF_BETA = (-1.1791602954361697e-7, 0.000023547966471313185, 0.0010179625278914885,
             0.014070470171167667, 0.11098505178285362, 0.49746925110067538, 1.0)
_ERF_CLAMP = 3.7439211627767994


def erf(x: torch.Tensor) -> torch.Tensor:
    """f32 erf as XLA computes it: x clamped to +-3.7439, then
    x * alpha(x^2) / beta(x^2) with Horner steps fused."""
    x = torch.clamp(x.float(), -_f32(_ERF_CLAMP), _f32(_ERF_CLAMP))
    x2 = x * x

    def poly(coeffs):
        p = torch.full_like(x2, _f32(coeffs[0]))
        for c in coeffs[1:]:
            p = _fma(x2, p, _f32(c))
        return p

    return x * poly(_ERF_ALPHA) / poly(_ERF_BETA)


# Giles, "Approximating the erfinv function" (2010), single precision: the
# central branch (w < 5) and the tail branch, as XLA's chlo lowering has them
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                   -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """f32 inverse erf as XLA computes it (``erf_inv(+-1) = +-inf``)."""
    x = x.float()
    w = -torch.log1p(x * -x)
    central = w < 5.0
    # torch's f32 sqrt on the CPU is not always correctly rounded (XLA's is):
    # through f64, rounded once
    w = torch.where(central, w - 2.5, torch.sqrt(w.double()).float() - 3.0)

    def coeff(i: int) -> torch.Tensor:
        return torch.where(central, torch.tensor(_f32(_ERFINV_CENTRAL[i]), device=x.device),
                           torch.tensor(_f32(_ERFINV_TAIL[i]), device=x.device))

    p = coeff(0)
    for i in range(1, len(_ERFINV_CENTRAL)):
        p = _fma(p, w, coeff(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_SQRT2 = _f32(math.sqrt(2.0))


def _tn_bounds(lower: float, upper: float) -> Tuple[float, float, float, float]:
    """(erf(lower/sqrt2), erf(upper/sqrt2), the open interval's two ends) in
    f32. JAX's ``truncated_normal`` is jitted, and XLA turns the division by
    the constant sqrt2 into a product with its f32 reciprocal."""
    lo, hi = np.float32(lower), np.float32(upper)
    inv_sqrt2 = np.float32(1.0) / np.float32(_SQRT2)
    a, b = (float(erf(torch.tensor([np.float32(v * inv_sqrt2)]))) for v in (lo, hi))
    return a, b, float(np.nextafter(lo, np.float32(np.inf))), float(np.nextafter(hi, np.float32(-np.inf)))


def _tn_at(key: torch.Tensor, bounds, index: torch.Tensor) -> torch.Tensor:
    a, b, lo, hi = bounds
    b0, b1 = _hash_counters(key, index)
    return torch.clamp(_SQRT2 * erf_inv(_uniform_from_bits(b0 ^ b1, a, b)), lo, hi)


def truncated_normal_at(key: torch.Tensor, lower: float, upper: float, index: torch.Tensor) -> torch.Tensor:
    """The elements at flat positions ``index`` of
    ``truncated_normal(key, lower, upper, shape)``, for any shape that holds
    them (a draw's element depends on its flat position alone)."""
    return _tn_at(key, _tn_bounds(lower, upper), index.to(device=key.device, dtype=torch.int64))


def truncated_normal(key: torch.Tensor, lower: float, upper: float, shape: Shape) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape, float32)`` on
    the key's device, drawn ``_CHUNK`` elements at a time."""
    shape = _shape(shape)
    n = math.prod(shape)
    bounds = _tn_bounds(lower, upper)
    out = torch.empty(n, dtype=torch.float32, device=key.device)
    for s in range(0, n, _CHUNK):
        e = min(s + _CHUNK, n)
        out[s:e] = _tn_at(key, bounds, torch.arange(s, e, dtype=torch.int64, device=key.device))
    return out.view(shape)


def root_key(seed: int, device="cpu") -> torch.Tensor:
    return PRNGKey(seed, device)


def named_key(key: torch.Tensor, name: str) -> torch.Tensor:
    """Derive a subsystem key from a stable hash of its name."""
    h = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")
    return fold_in(key, h)


def seed_python(seed: int) -> None:
    """Seed the host-side RNGs used only for data shuffling and sampling
    choices."""
    import random

    random.seed(seed)
    np.random.seed(seed % (2**32))
