"""Bit-exact threefry2x32 keys and integer draws.

The JAX package keys every RANSAC with `fold_in(PRNGKey(seed), frame_id)`
split into per-consumer subkeys (`vslam_tpu/core/tracking.py:931,1164`)
and draws hypothesis indices with `jax.random.randint`
(`vslam_tpu/ops/ransac.py:40`). The port reproduces those bits exactly —
the threefry2x32 hash, `PRNGKey`, `fold_in`, `split` and `randint` as jax
0.9 computes them with `jax_threefry_partitionable=True` — so both
packages sample the same minimal sets and every RANSAC agrees. The
float draws of the trainers (`uniform`, `bernoulli`, `normal`) follow
`jax.random` too, so a training step sees the same homographies,
photometric augments and batch indices as the JAX package's.

Keys are int64 tensors of shape (2,) holding uint32 values (torch's
uint32 supports few ops); every intermediate is masked to 32 bits. Keys
are tiny, so callers keep them on the host and move only the drawn
integers to the device.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x):
    return x & _M32


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds) of counter pairs (x1, x2) under
    key (k1, k2). All arguments are int64 tensors of uint32 values that
    broadcast together; returns the two output words."""
    ks = [k1, k2, _u32(k1 ^ k2 ^ 0x1BD11BDA)]
    x = [_u32(x1 + ks[0]), _u32(x2 + ks[1])]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = _u32(x[0] + x[1])
            x[1] = x0 ^ _rotl(x[1], r)
            x[0] = x0
        x[0] = _u32(x[0] + ks[(i + 1) % 3])
        x[1] = _u32(x[1] + ks[(i + 2) % 3] + (i + 1))
    return x[0], x[1]


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed (jax's default without
    x64): the key words are (0, seed)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`: hash the counter pair (0, data) under key.
    `data` may be a tensor of counters: the result is then (2, *shape),
    key i in column i."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    o1, o2 = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    return torch.stack([o1, o2])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split` (partitionable form): key i is the hash of the
    counter pair (0, i). Returns (num, 2)."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    o1, o2 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return torch.stack([o1, o2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit `jax.random.bits` (partitionable form): the xor of the two
    hash words of the flat (hi, lo) counter of every element."""
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    hi = lo >> 32
    o1, o2 = threefry2x32(key[0], key[1], hi, lo & _M32)
    return (o1 ^ o2).reshape(shape)


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval, dtype=int32)` for
    static Python bounds: two 32-bit draws combined modulo the span.
    Returns int64 values in [minval, maxval)."""
    minval, maxval = int(minval), int(maxval)
    span = maxval - minval if maxval > minval else 1
    k = split(key, 2)
    higher = random_bits(k[0], shape)
    lower = random_bits(k[1], shape)
    mult = ((2**16 % span) ** 2 & _M32) % span
    off = _u32(_u32((higher % span) * mult) + lower % span) % span
    return minval + off


def _scale_shift(f, minval, maxval):
    """`f * (maxval - minval) + minval` in f32 as XLA's CPU code computes
    it: one fused multiply-add (the f32 product is exact in f64), then
    clamped below at minval."""
    lo = torch.tensor(minval, dtype=torch.float32).item()
    span = torch.tensor(maxval, dtype=torch.float32).item() - lo
    span = torch.tensor(span, dtype=torch.float32).item()
    out = (f.to(torch.float64) * span + lo).to(torch.float32)
    return torch.clamp(out, min=lo)


def uniform(key: torch.Tensor, shape, minval=0.0, maxval=1.0) -> torch.Tensor:
    """`jax.random.uniform` (f32): the top 23 bits of each 32-bit draw as
    the mantissa of a float in [1, 2), minus 1, then scaled and shifted
    into [minval, maxval). Bit for bit equal to JAX's."""
    shape = tuple(shape)
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return _scale_shift(f, minval, maxval)


def bernoulli(key: torch.Tensor, p, shape) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)`: uniform [0, 1) below p."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32).item()


# Giles' single-precision erfinv coefficients, as XLA's ErfInv32 uses
# them: w = -log1p(-x^2) below 5 and sqrt(w) above.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """f32 erfinv by XLA's polynomial (Horner steps as fused multiply-adds,
    as XLA's CPU code contracts them); `torch.erfinv` differs from it by
    up to 2e-5 in the tails. Within 2.4e-7 of `jax.lax.erf_inv` (its
    `log1p` rounds differently on some inputs)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).to(torch.float64)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(torch.float32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, torch.tensor(a, dtype=torch.float32), torch.tensor(b, dtype=torch.float32))
        p = (p.to(torch.float64) * w + c.to(torch.float64)).to(torch.float32)
    return torch.where(torch.abs(x) == 1.0, x * torch.finfo(torch.float32).max, p * x)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.normal` (f32): sqrt(2) * erfinv(u) with u uniform on
    [nextafter(-1, 0), 1), as `jax._src.random._normal_real` computes it.
    Within 1e-6 of JAX's draw (the `erfinv` above), not bitwise."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return erfinv(u) * torch.tensor(math.sqrt(2.0), dtype=torch.float32).item()
