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


def div_const(x, c):
    """`x / c` for a Python constant `c` (a configuration value), rounded
    as the JAX package rounds it: under `jit` XLA folds `1 / c` in x's
    dtype and multiplies by it. The reciprocal is computed in that dtype
    (not `1.0 / c` in Python's f64, which can round one ulp away) and kept
    per device, so the CPU and the card multiply by the same value."""
    return x * _reciprocal(float(c), x.dtype, torch.device(x.device))


def to_device(t, device):
    """`t.to(device)` for a small host tensor: on a CUDA device, from
    pinned memory and asynchronously on the current stream (PyTorch keeps
    the pinned block until the copy has run)."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


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
