"""Bit-exact threefry2x32 keys and integer draws.

The JAX package keys every RANSAC with `fold_in(PRNGKey(seed), frame_id)`
split into per-consumer subkeys (`vslam_tpu/core/tracking.py:931,1164`)
and draws hypothesis indices with `jax.random.randint`
(`vslam_tpu/ops/ransac.py:40`). The port reproduces those bits exactly —
the threefry2x32 hash, `PRNGKey`, `fold_in`, `split` and `randint` as jax
0.9 computes them with `jax_threefry_partitionable=True` — so both
packages sample the same minimal sets and every RANSAC agrees.

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
    """`jax.random.fold_in`: hash the counter pair (0, data) under key."""
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
