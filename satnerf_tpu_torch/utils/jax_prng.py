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
- `randint`: random.py `_randint` for int32, two 32-bit draws a value from
  the two keys of a split, folded into the span in uint32 arithmetic
  (`randint_span` gives the span and its multiplier);
- `permutation`: random.py `_shuffle` of `arange(n)`, ceil(3 ln n / ln
  (2^32 - 1)) rounds, each a split, 32 random bits a position and a stable
  sort by them;
- `flax_param_key`: flax's per-parameter key, `_fold_in_static` of the
  module path and the scope's call counter (flax/core/scope.py:87-140);
- `step_keys`: the keys of one training step, the JAX package's key tree
  (satnerf_tpu/train/system.py:665-730).

Every operation is float32 or uint32 as in XLA, `erf_inv`'s log1p and log
are XLA's CPU polynomials (not numpy's, which differ in the last bits), and
a multiply-add that XLA's CPU code fuses into one rounding (the uniform's
scale and shift, the Horner steps) is rounded once here too (`fma32`), so
the draws equal JAX's on the CPU to the bit.
"""

from __future__ import annotations

import functools
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


def _threefry_scalar(k1: int, k2: int, x1: int, x2: int) -> tuple:
    """threefry_2x32 of one counter pair in Python integers: the same bits,
    at a fraction of numpy's cost for the few keys a step derives."""
    m = 0xFFFFFFFF
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a, b = (x1 + ks[0]) & m, (x2 + ks[1]) & m
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & m
            b = a ^ (((b << r) | (b >> (32 - r))) & m)
        a = (a + ks[(i + 1) % 3]) & m
        b = (b + ks[(i + 2) % 3] + i + 1) & m
    return a, b


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
    """jax.random.split(key, num): (num, 2) uint32, the key of counter i in
    row i."""
    k1, k2 = int(key[0]), int(key[1])
    return np.array([_threefry_scalar(k1, k2, 0, i) for i in range(num)],
                    _U32).reshape(num, 2)


def split_at(key: np.ndarray, i: int) -> np.ndarray:
    """split(key, num)[i] for any num > i: the key of counter i, made alone
    (a draw that needs one of a split's keys pays for that one)."""
    return np.array(_threefry_scalar(int(key[0]), int(key[1]), 0, int(i)),
                    _U32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """jax.random.fold_in(key, data) for a uint32 `data`."""
    return np.array(_threefry_scalar(int(key[0]), int(key[1]), 0,
                                     int(data) & 0xFFFFFFFF), _U32)


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """jax.random.bits(key, shape, uint32)."""
    hi, lo = _counters(tuple(shape))
    b1, b2 = threefry_2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def uniform(key: np.ndarray, shape: Sequence[int], minval=0.0,
            maxval=1.0) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    lo, scale = uniform_scale(minval, maxval)
    bits = (random_bits(key, shape) >> _U32(32 - 23)) | _U32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, fma32(floats, scale, lo))


def uniform_scale(minval=0.0, maxval=1.0) -> tuple:
    """(lo, hi - lo) in float32: the shift and scale `uniform` applies to
    its [0, 1) floats, fused into one rounding."""
    lo, hi = np.float32(minval), np.float32(maxval)
    return lo, np.float32(hi - lo)


def randint_span(minval: int, maxval: int) -> tuple:
    """(span, multiplier) of `randint` over [minval, maxval) as uint32, as
    random.py `_randint` forms them for int32: span 1 where maxval <=
    minval, multiplier = (2^16 mod span)^2 mod span, the square taken in
    uint32 (it wraps to 0 where 2^16 mod span is 2^16)."""
    span = 1 if maxval <= minval else (int(maxval) - int(minval)) & 0xFFFFFFFF
    mult = (1 << 16) % span
    return span, ((mult * mult) & 0xFFFFFFFF) % span


def randint_fold(higher: np.ndarray, lower: np.ndarray, minval: int,
                 span: int, mult: int) -> np.ndarray:
    """randint's value from its two words of random bits: ((higher mod
    span) * mult + lower mod span) mod span in uint32 (the sum wraps as
    uint32 does), plus minval."""
    with np.errstate(over="ignore"):
        off = ((higher % _U32(span)) * _U32(mult) + lower % _U32(span)) \
            % _U32(span)
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def randint(key: np.ndarray, shape: Sequence[int], minval: int,
            maxval: int) -> np.ndarray:
    """jax.random.randint(key, shape, minval, maxval) with int32 values
    (JAX's `int` with 64-bit types off)."""
    k = split(key)
    span, mult = randint_span(minval, maxval)
    return randint_fold(random_bits(k[0], shape), random_bits(k[1], shape),
                        minval, span, mult)


def permutation_rounds(n: int) -> int:
    """The sort rounds random.py `_shuffle` takes for n elements."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(0xFFFFFFFF)))


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """jax.random.permutation(key, n): arange(n) as int32, sorted by 32
    fresh random bits a position in each round, stably."""
    x = np.arange(n, dtype=np.int32)
    for _ in range(permutation_rounds(n)):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, (n,)), kind="stable")]
    return x


STEP_BLOCK = 1024  # steps whose keys step_keys derives in one pass


def step_keys(key: np.ndarray, rank: int, step: int, accum: int = 1) -> list:
    """The keys of one training step of the JAX package
    (satnerf_tpu/train/system.py:665-730): k = fold_in(fold_in(key, rank),
    step) and, a micro-batch, (k_idx, k_didx, k_loss) = split(k, 3); with
    `accum` > 1 each micro-batch's triple is split from its key of
    split(k, accum). A list of `accum` triples. The keys of STEP_BLOCK
    steps are derived at once, as arrays (_step_key_block), so a step pays
    for an index, not for its hashes."""
    block = _step_key_block(int(key[0]), int(key[1]), int(rank),
                            int(step) // STEP_BLOCK, int(accum))
    keys = block[int(step) % STEP_BLOCK].copy()
    return [tuple(k) for k in keys]


@functools.lru_cache(maxsize=8)
def _step_key_block(k1: int, k2: int, rank: int, block: int,
                    accum: int) -> np.ndarray:
    """step_keys of the steps block * STEP_BLOCK onwards, STEP_BLOCK of
    them: (STEP_BLOCK, accum, 3, 2) uint32. fold_in and split are the hash
    of the counter (0, data) and (0, i), so each level is one threefry_2x32
    over arrays."""
    r1, r2 = _threefry_scalar(k1, k2, 0, rank & 0xFFFFFFFF)
    steps = np.arange(block * STEP_BLOCK, (block + 1) * STEP_BLOCK,
                      dtype=np.uint64).astype(_U32)[:, None]
    s1, s2 = threefry_2x32(r1, r2, np.zeros_like(steps), steps)
    if accum > 1:  # (STEP_BLOCK, accum): split(k, accum)
        m = np.arange(accum, dtype=_U32)
        s1, s2 = threefry_2x32(s1, s2, np.zeros_like(m), m)
    i = np.arange(3, dtype=_U32)
    t1, t2 = threefry_2x32(s1[..., None], s2[..., None], np.zeros_like(i), i)
    return np.stack([t1, t2], axis=-1)


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
