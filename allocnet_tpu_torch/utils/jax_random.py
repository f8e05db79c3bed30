"""The JAX package's parameter draws, in numpy.

`jax.random`'s threefry-2x32 generator (the default implementation, with
`jax_threefry_partitionable` on, as JAX >= 0.5 has it) and flax's way of
giving each parameter its own key, so that the port can start a net from
the very weights `net.init(jax.random.PRNGKey(seed), ...)` gives in the
JAX package (train/train_step.init_params):

* `param_key(seed, scope, k)`: the key of the k-th parameter (1-based,
  in declaration order) that the module at `scope` (a tuple of submodule
  names, () for the top module) creates: flax folds the SHA-1 of the path
  and the counter into the root key (flax.core.scope._fold_in_static);
* `truncated_normal(key, shape)`: `jax.random.truncated_normal(key, -2,
  2, shape, float32)`: uniform bits as JAX draws them, then XLA's float32
  inverse error function (Giles' approximation), with the fused
  multiply-adds that XLA's CPU code uses.  The uniform bits are JAX's bit
  for bit; the values agree with JAX's CPU run to 2 units in the last
  place of the truncation bound (log1p is numpy's, not XLA's).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
# XLA's ErfInv for float32: the polynomial for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
F32 = np.float32


def threefry2x32(key, x0, x1) -> tuple:
    """The threefry-2x32 block cipher (20 rounds) of the counter pairs
    (x0, x1) under `key` (two uint32)."""
    ks = [np.uint32(key[0]), np.uint32(key[1])]
    ks.append(ks[0] ^ ks[1] ^ _PARITY)
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = ((x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r)))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> tuple:
    """jax.random.PRNGKey(seed) for 0 <= seed < 2**32."""
    return (np.uint32(0), np.uint32(seed))


def fold_in(key, data: int) -> tuple:
    """jax.random.fold_in(key, data)."""
    a, b = threefry2x32(key, np.zeros(1, np.uint32),
                        np.array([data], np.uint32))
    return (a[0], b[0])


def param_key(seed: int, scope: tuple, k: int) -> tuple:
    """The key flax gives the k-th parameter created in `scope` under
    `init(PRNGKey(seed), ...)`."""
    m = hashlib.sha1()
    for x in (*scope, k):
        m.update(x.encode() if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return fold_in(prng_key(seed), int.from_bytes(m.digest()[:4], "big"))


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once (the product of two float32 is exact
    in float64)."""
    return (np.asarray(a, np.float64) * np.float64(b)
            + np.asarray(c, np.float64)).astype(F32)


def _erfinv(x: np.ndarray) -> np.ndarray:
    w = -np.log1p(-x * x)
    lt = w < F32(5)
    w = np.where(lt, w - F32(2.5), np.sqrt(w) - F32(3)).astype(F32)
    p = np.where(lt, F32(_ERFINV_LT5[0]), F32(_ERFINV_GE5[0]))
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, F32(lo), F32(hi)))
    return (p * x).astype(F32)


def truncated_normal(key, shape) -> np.ndarray:
    """jax.random.truncated_normal(key, -2, 2, shape) in float32."""
    n = math.prod(shape)
    b1, b2 = threefry2x32(key, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    bits = b1 ^ b2
    unit = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(F32) - F32(1)
    lo, hi = (F32(math.erf(v / math.sqrt(2.0))) for v in (-2.0, 2.0))
    u = np.maximum(lo, _fma(unit, hi - lo, lo))
    z = (F32(math.sqrt(2.0)) * _erfinv(u)).astype(F32)
    return np.clip(z, np.nextafter(F32(-2), F32(0)),
                   np.nextafter(F32(2), F32(0))).reshape(shape)
