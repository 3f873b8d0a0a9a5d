"""Tensor helpers that do not make the host wait for the card.

On a CUDA tensor some common idioms block the host until the stream has
drained: a copy from pageable host memory (`torch.tensor(python_values,
device="cuda")`, `cpu_tensor.to("cuda")`, `x[...] = python_scalar`), and
reading or writing `x[i]` where `i` is a 0-dim integer tensor (PyTorch
reads `i` back to the host to select). These helpers do the same work
without the wait. On CPU tensors they compute the same values.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=64)
def _constant(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype, device):
    """A small constant tensor from nested tuples of Python numbers, copied
    to `device` once per process and reused. Read-only: do not write into
    it."""
    return _constant(values, dtype, torch.device(device))


@functools.lru_cache(maxsize=64)
def _reciprocal(c, dtype, device):
    one, den = torch.tensor(1.0, dtype=dtype), torch.tensor(c, dtype=dtype)
    return (one / den).to(device)


def reciprocal(c, dtype, device):
    """The reciprocal of a Python constant, computed in `dtype` (as XLA
    folds `1 / c`), one tensor per device."""
    return _reciprocal(float(c), dtype, torch.device(device))


def div_const(x, c):
    """`x / c` for a Python constant `c` (a configuration value), rounded
    as the JAX package rounds it: under `jit` XLA folds `1 / c` in x's
    dtype and multiplies by it. The reciprocal is computed in that dtype
    (not `1.0 / c` in Python's f64, which can round one ulp away) and kept
    per device, so the CPU and the card multiply by the same value."""
    return x * _reciprocal(float(c), x.dtype, torch.device(x.device))


def fma(a, b, c):
    """`a * b + c` rounded once: the multiply-add that XLA's CPU code
    contracts `a * b + c` into (its LLVM backend fuses a product into the
    add or subtract that consumes it). `torch.addcmul` is one fused
    multiply-add in float32 on both devices (`chip_smoke.py` holds the
    card's bits against the f64 emulation). In float64 the card's
    `addcmul` rounds the product first; `ops.libm`'s f64 polynomials then
    round to the same float32 results (the smoke compares them with the
    CPU's)."""
    return torch.addcmul(c, a, b)


def fms(a, b, c):
    """`c - a * b` rounded once: XLA's contraction of a subtraction of a
    product. The card's `torch.addcmul(c, a, b, value=-1)` rounds the
    product first, so `a` is negated (exact) and the add fused."""
    return torch.addcmul(c, -a, b)


def sqrt(x):
    """Correctly rounded square root of a float32 tensor on both devices,
    as XLA's is. The card's float32 `sqrt` is (IEEE round to nearest;
    `chip_smoke.rounding_mismatches` holds its bits against the f64
    form). PyTorch's vectorised CPU float32 `sqrt` is not (0.7% of random
    inputs one ulp off), so on the CPU the square root of the f64 value is
    rounded once to float32."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def to_device(t, device):
    """`t.to(device)` for a small host tensor: on a CUDA device, from
    pinned memory and asynchronously on the current stream (PyTorch keeps
    the pinned block until the copy has run)."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def rows(table, idx):
    """`table[idx]` along dim 0 for an integer tensor idx of any shape
    (0-dim too: Python indexing would read a 0-dim index back)."""
    return torch.index_select(table, 0, idx.reshape(-1)).view(idx.shape + table.shape[1:])


def take(x, i):
    """`x[i]` along dim 0 for a 0-dim integer tensor `i` (in range)."""
    return x.index_select(0, i.reshape(1).long())[0]


def put_(x, i, value):
    """In place `x[i] = value` along dim 0 for a 0-dim integer tensor `i`
    (in range); `value` is a tensor of shape `x.shape[1:]` or a Python
    number."""
    idx = i.reshape(1).long()
    if isinstance(value, torch.Tensor):
        return x.index_copy_(0, idx, value.to(x.dtype)[None])
    return x.index_fill_(0, idx, value)
