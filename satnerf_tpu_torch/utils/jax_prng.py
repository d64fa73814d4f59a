"""JAX's threefry PRNG and flax's parameter keys, in numpy.

The JAX package draws its initial weights with `jax.random` under flax's
`Module.init` (satnerf_tpu/train/system.py:216-232,
satnerf_tpu/models/nerf.py:38-61, 224-235). This module computes the same
bits with numpy alone, for JAX 0.9 with `jax_threefry_partitionable` on (its
default) and flax 0.12 with `flax_fix_rng_separator` off (its default):

- `threefry_2x32`: the Threefry-2x32 hash, 20 rounds
  (jax/_src/prng.py `_threefry2x32_lowering`);
- `prng_key`, `split`, `fold_in`: `jax.random.PRNGKey` / `split` /
  `fold_in` on raw uint32[2] keys (prng.py `threefry_seed`,
  `_threefry_split_foldlike`, `_threefry_fold_in`);
- `random_bits`: 32 partitionable bits, the two hash words of a 64-bit
  counter XORed (prng.py `_threefry_random_bits_partitionable`);
- `uniform`: the mantissa trick of jax/_src/random.py `_uniform`;
- `normal`: `sqrt(2) * erf_inv(u)` with u uniform in (-1, 1), through XLA's
  float32 `erf_inv` (Giles' polynomial, written out below);
- `flax_param_key`: flax's per-parameter key, `_fold_in_static` of the
  module path and the scope's call counter (flax/core/scope.py:87-140).

Every operation is float32 or uint32 as in XLA, `erf_inv`'s log1p and log
are XLA's CPU polynomials (not numpy's, which differ in the last bits), and
a multiply-add that XLA's CPU code fuses into one rounding (the uniform's
scale and shift, the Horner steps) is rounded once here too (`fma32`), so
the draws equal JAX's on the CPU to the bit.
"""

from __future__ import annotations

import hashlib
from typing import Sequence, Union

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry_2x32(k1, k2, x1: np.ndarray, x2: np.ndarray):
    """Threefry-2x32 of the counter pairs (x1, x2) under the key (k1, k2):
    two uint32 arrays of the counters' shape."""
    k1, k2 = _U32(k1), _U32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    x = [np.asarray(x1, _U32) + ks[0], np.asarray(x2, _U32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = x[0] ^ _rotl(x[1], r)
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) as raw uint32[2] with 64-bit types off (the
    JAX package's setting): the seed taken as a 32-bit integer, the high
    word 0."""
    return np.array([0, int(seed) & 0xFFFFFFFF], _U32)


def fma32(a, b, c) -> np.ndarray:
    """a * b + c in float32 with one rounding, as XLA's CPU code fuses it:
    the product is exact in float64, the sum is rounded to odd there (its
    exact error from TwoSum), so the cast to float32 rounds once."""
    p = np.asarray(a, np.float32).astype(np.float64) * \
        np.asarray(b, np.float32).astype(np.float64)
    c = np.asarray(c, np.float32).astype(np.float64)
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even,
                 np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _counters(shape: Sequence[int]):
    """The high and low words of a row-major uint64 iota of `shape`."""
    n = int(np.prod(shape, dtype=np.int64))
    iota = np.arange(n, dtype=np.uint64).reshape(shape)
    return (iota >> np.uint64(32)).astype(_U32), iota.astype(_U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num): (num, 2) uint32."""
    hi, lo = _counters((num,))
    b1, b2 = threefry_2x32(key[0], key[1], hi, lo)
    return np.stack([b1, b2], axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """jax.random.fold_in(key, data) for a uint32 `data`."""
    b1, b2 = threefry_2x32(key[0], key[1], np.zeros(1, _U32),
                           np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.array([b1[0], b2[0]], _U32)


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """jax.random.bits(key, shape, uint32)."""
    hi, lo = _counters(tuple(shape))
    b1, b2 = threefry_2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def uniform(key: np.ndarray, shape: Sequence[int], minval=0.0,
            maxval=1.0) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> _U32(32 - 23)) | _U32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, fma32(floats, hi - lo, lo))


# XLA's CPU float32 log (Cephes' logf): x = m * 2^e with m in [sqrt(1/2),
# sqrt(2)), log(x) = log1p(m - 1) + e log 2 with e log 2 in two parts
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _xla_log(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 log for x > 0, its fused multiply-adds included."""
    f = np.float32
    p = [f(c) for c in _LOG_P]
    x = np.maximum(np.array(0x00800000, _U32).view(f), np.asarray(x, f))
    bits = x.view(_U32)
    e = f(1) + ((bits >> _U32(23)).astype(np.int32) - 0x7F).astype(f)
    m = ((bits & _U32(0x807FFFFF)) | _U32(0x3F000000)).view(f)
    small = m < f(0.707106781186547524)
    m = (m - f(1)) + np.where(small, m, f(0))
    e = e - np.where(small, f(1), f(0))
    m2 = m * m
    m3 = m2 * m
    y = fma32(fma32(m, p[0], p[1]), m, p[2])
    y1 = fma32(fma32(m, p[3], p[4]), m, p[5])
    y2 = fma32(fma32(m, p[6], p[7]), m, p[8])
    y = fma32(fma32(y, m3, y1), m3, y2)
    y = fma32(y, m3, f(_LOG_Q1) * e)
    return ((m - f(0.5) * m2) + y) + f(_LOG_Q2) * e


# XLA's float32 log1p: Cephes' rational approximation where |x| < sqrt(2) - 1,
# else log(1 + x); the polynomials are Horner from the highest degree
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _xla_log1p(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 log1p for x > -1."""
    f = np.float32
    x = np.asarray(x, f)

    def horner(cs):
        acc = np.zeros_like(x)
        for c in cs:
            acc = fma32(acc, x, f(c))
        return acc

    x2 = x * x
    r = (x * x2) * (horner(_LOG1P_NUM) / horner(_LOG1P_DEN))
    near = x + (f(-0.5) * x2 + r)
    return np.where(np.abs(x) < f(0.41421356237309504880), near,
                    _xla_log(x + f(1)))


# XLA's float32 erf_inv (M. Giles, "Approximating the erfinv function"):
# a degree-8 polynomial in w - 2.5 where w = -log1p(-x^2) < 5, else in
# sqrt(w) - 3, times x
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erf_inv, operation by operation in float32."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -_xla_log1p(-x * x)
        lt = w < np.float32(5.0)
        w = np.where(lt, w - np.float32(2.5),
                     np.sqrt(w) - np.float32(3.0)).astype(np.float32)
        p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
        for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            p = fma32(p, w, np.where(lt, np.float32(a), np.float32(b)))
        out = p * x
        return np.where(np.abs(x) == np.float32(1.0),
                        x * np.float32(np.inf), out).astype(np.float32)


def normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """jax.random.normal(key, shape, float32)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, np.float32(1.0))
    return np.float32(np.sqrt(2)) * erf_inv(u)


def flax_param_key(key: np.ndarray, path: Sequence[str],
                   counter: int) -> np.ndarray:
    """The key flax gives the `counter`-th `self.param` of the module at
    `path` (names from the root, which is not named) under
    `init(key, ...)`: the root key folded with the first four bytes of
    sha1 over the path's names and the counter (flax/core/scope.py
    `LazyRng`, `_fold_in_static`)."""
    m = hashlib.sha1()
    suffix: Sequence[Union[str, int]] = (*path, counter)
    for x in suffix:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))
