"""The port's own copy of JAX's default PRNG (threefry2x32, partitionable).

``jax.random`` under its defaults (``jax_default_prng_impl =
threefry2x32``, ``jax_threefry_partitionable = True``) is what the JAX
package seeds MIS, colouring, the spectral embedding and SVD++ with; this
module gives the same bits from a seed without JAX, so the port's masks
and colours equal the JAX package's for the same ``seed``.

Keys are host NumPy ``uint32 [2]`` arrays, as ``jax.random.key_data``
shows them: ``PRNGKey``, ``fold_in`` and ``split`` hash a handful of words
on the host. ``bits``, ``uniform`` and ``normal`` hash one counter per
element on the given device. The 32-bit arithmetic runs in int64 with
``& 0xFFFFFFFF`` (torch's uint32 lacks most operations), so ``bits``
returns int64 tensors holding the uint32 values. ``bits`` and ``uniform``
are bit-equal to JAX; ``normal`` evaluates XLA's float32 ``erf_inv``
(Giles' single-precision polynomials) one rounded operation at a time,
and lands within 4 ulp of JAX's draw (XLA contracts some multiply-adds).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# Giles' erfinv polynomials in w - 2.5 (w < 5) and in sqrt(w) - 3, with
# w = -log(1 - x^2), highest power first: XLA's float32 ErfInv.
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                   0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def _hash(k1: int, k2: int, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    the key ``(k1, k2)``; ``x0``, ``x1`` are int64 arrays or tensors of
    values in [0, 2^32), and so are the two results."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _key_words(key) -> tuple[int, int]:
    key = np.asarray(key, dtype=np.uint32)
    if key.shape != (2,):
        raise TypeError(f"a raw threefry key has shape (2,), got {key.shape}")
    return int(key[0]), int(key[1])


def _as_key(a, b) -> np.ndarray:
    return np.array([int(a), int(b)], dtype=np.uint32)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as its raw ``uint32 [2]`` data: the
    seed taken as a 32-bit integer (as JAX does without x64), high word 0."""
    return _as_key(0, int(seed) & _M32)


def _threefry_2x32(key, count: np.ndarray) -> np.ndarray:
    """JAX's ``threefry_2x32`` over a flat uint32 count vector (padded to
    an even length, hashed as its two halves)."""
    k1, k2 = _key_words(key)
    flat = np.asarray(count, dtype=np.int64).ravel()
    odd = flat.shape[0] % 2
    if odd:
        flat = np.concatenate([flat, np.zeros(1, np.int64)])
    half = flat.shape[0] // 2
    y0, y1 = _hash(k1, k2, flat[:half], flat[half:])
    out = np.concatenate([y0, y1])
    return (out[:-1] if odd else out).astype(np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the key hashed over the seed
    words of ``data`` (as uint32)."""
    y = _threefry_2x32(key, np.array([0, int(data) & _M32], np.int64))
    return _as_key(y[0], y[1])


def _counters(n: int, device):
    """The two words of a uint64 iota ``[n]`` as int64 tensors (high, low)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & _M32


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` as raw keys ``uint32 [num, 2]``
    (the partitionable split: one hash of each key's index)."""
    k1, k2 = _key_words(key)
    idx = np.arange(int(num), dtype=np.int64)
    y0, y1 = _hash(k1, k2, idx >> 32, idx & _M32)
    return np.stack([y0, y1], axis=1).astype(np.uint32)


def bits(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` on ``device``, as int64
    holding the uint32 values: the two hash words of each element's
    counter, xor-ed."""
    shape = tuple(int(s) for s in (shape if isinstance(shape, (tuple, list)) else (shape,)))
    k1, k2 = _key_words(key)
    hi, lo = _counters(math.prod(shape), torch.device(device))
    y0, y1 = _hash(k1, k2, hi, lo)
    return (y0 ^ y1).reshape(shape)


def uniform(key, shape, device="cpu", minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    top 23 bits as a mantissa of [1, 2), less 1, scaled and shifted."""
    b = bits(key, shape, device)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    # XLA fuses the scale and shift into one multiply-add, rounded once:
    # the float32 product is exact in float64, so is the shifted sum here
    scaled = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (±inf at ±1)."""
    w = -torch.log1p(-x * x)
    central, tail = w - 2.5, torch.sqrt(w) - 3.0
    p = torch.full_like(x, _ERFINV_CENTRAL[0])
    q = torch.full_like(x, _ERFINV_TAIL[0])
    for c in _ERFINV_CENTRAL[1:]:
        p = c + p * central
    for c in _ERFINV_TAIL[1:]:
        q = c + q * tail
    out = torch.where(w < 5.0, p, q) * x
    return torch.where(x.abs() == 1.0, x * float("inf"), out)


def normal(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) *
    erfinv(u)`` with ``u`` uniform on [nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, device, lo, 1.0)
    return _erfinv(u) * torch.tensor(np.sqrt(2), dtype=torch.float32, device=u.device)
