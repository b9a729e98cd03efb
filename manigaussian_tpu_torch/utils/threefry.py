"""JAX's default PRNG in numpy: `threefry2x32` keys, `split`, `uniform` and
`normal` with `jax.random`'s bits.

For scripts whose output is defined by `jax.random` draws (the golden
scenes of `scripts/make_goldens.py` and their loss weights): the same key
gives the same float32 arrays here, without JAX. The key layout and the
counters are JAX's `jax_threefry_partitionable` mode, the default since
JAX 0.5: a key is two uint32 words; `split(key, n)` and a draw of shape S
hash the flat uint64 index of each element (its high and low words) under
the key, and a 32-bit draw is the two output words XOR-ed. `uniform` sets
the top 23 bits as a float32 mantissa in [1, 2), subtracts 1 and scales;
`normal` is √2 · erf⁻¹(u) for u uniform in (-1, 1), through XLA's float32
`erf_inv` on the CPU (Giles' polynomial in w = -log1p(-u²), log1p as XLA's
CPU backend emits it: Cephes' rational form below |x| = √2 - 1, else its
`logf` polynomial of 1 + x), so that it equals JAX's bit for bit. XLA's
CPU code contracts a product and the sum that takes it into one fused
multiply-add (x86 FMA): every such pair here is one rounding (`_fma`).
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# XLA's ErfInv32 coefficients (Giles, "Approximating the erfinv function"),
# for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)

# XLA's CPU log1p: Cephes' rational approximation for |x| < sqrt(2) - 1
# (numerator and denominator, highest power first) ...
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# ... and Cephes' logf of 1 + x elsewhere: its polynomial in three
# interleaved Horner chains, and ln 2 split in two
_LOGF_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
           -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
           2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LN2_LO, _LN2_HI = -2.12194440e-4, 0.693359375


def _fma(a, b, c) -> np.ndarray:
    """a·b + c rounded once to float32 (the product is exact in float64)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` with JAX's default 32-bit integers: the
    seed is taken modulo 2^32 into the low word, the high word is 0."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32, 20 rounds, of the counter words (x0, x1) under the
    key (two uint32 words): JAX's `threefry2x32_p`."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _hashed_iota(key: np.ndarray, shape) -> tuple:
    """The two output words of threefry over the flat uint64 index."""
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32).reshape(shape)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape)
    return threefry2x32(key, hi, lo)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)`: [num, 2] uint32."""
    b0, b1 = _hashed_iota(key, (num,))
    return np.stack([b0, b1], axis=-1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """`jax.random.bits(key, shape)` of 32 bits: uint32 of `shape`."""
    b0, b1 = _hashed_iota(key, tuple(shape))
    return b0 ^ b1


def uniform(key: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(32 - 23)) | one).view(np.float32) \
        - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


def _f32(c) -> np.float32:
    return np.float32(c)


def _horner(coeffs, x: np.ndarray) -> np.ndarray:
    p = np.zeros_like(x) * x + _f32(coeffs[0])
    for c in coeffs[1:]:
        p = _fma(p, x, _f32(c))
    return p


def _logf(y: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 log (Cephes logf), special values included."""
    v = np.maximum(y, np.finfo(np.float32).tiny)
    bits = v.view(np.uint32)
    m = ((bits & np.uint32(0x7FFFFF)) | np.uint32(0x3F000000)).view(np.float32)
    e = ((bits >> np.uint32(23)).astype(np.int32) - 127).astype(np.float32) \
        + _f32(1.0)
    small = m < _f32(0.707106769)
    e = e - np.where(small, _f32(1.0), _f32(0.0))
    x = (m - _f32(1.0)) + np.where(small, m, _f32(0.0))
    z = x * x
    z3 = z * x
    c = [_f32(k) for k in _LOGF_P]
    a = _fma(_fma(x, c[0], c[1]), x, c[2])
    b = _fma(_fma(x, c[3], c[4]), x, c[5])
    d = _fma(_fma(x, c[6], c[7]), x, c[8])
    r = _fma(_fma(_fma(a, z3, b), z3, d), z3, e * _f32(_LN2_LO))
    r = _fma(e, _f32(_LN2_HI), _fma(-z, _f32(0.5), x) + r)
    r = np.where(y <= 0, np.float32(np.nan), r)
    r = np.where(y == 0, np.float32(-np.inf), r)
    return np.where(y == np.inf, np.float32(np.inf), r)


def log1p(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 log1p."""
    x = np.asarray(x, np.float32)
    x2 = x * x
    small = (x * x2) * (_horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x))
    small = x + _fma(x2, _f32(-0.5), small)
    with np.errstate(invalid="ignore", divide="ignore"):
        large = _logf(x + _f32(1.0))
    return np.where(np.abs(x) < _f32(0.41421356237309504880), small, large)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 `erf_inv` (its Horner order, its branch at w = 5)."""
    x = np.asarray(x, np.float32)
    w = -log1p(x * -x)
    lt = w < np.float32(5.0)
    with np.errstate(invalid="ignore"):
        w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    coef = lambda i: np.where(lt, np.float32(_ERFINV_LT5[i]),
                              np.float32(_ERFINV_GE5[i]))
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coef(i))
    inf = np.float32(np.inf)
    return np.where(np.abs(x) == np.float32(1.0), x * inf, p * x)


def normal(key: np.ndarray, shape) -> np.ndarray:
    """`jax.random.normal(key, shape)`, float32."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return np.float32(np.sqrt(2)) * erf_inv(u)
