"""Bilinear image resize with the JAX package's semantics.

The counterpart of `jax.image.resize(x, shape, method="bilinear")`, which
the ORB pyramid (`vslam_tpu/ops/orb.py:160`) and MiDaS's input and output
resizes (`vslam_tpu/models/midas.py:249-251`) call. That resize is not
`F.interpolate(mode="bilinear")`: it samples at half-pixel centres with a
triangle kernel that is WIDENED by the inverse scale when it shrinks (an
antialiasing filter), normalises each output's weights to sum to one, and
zeroes an output whose sample lies outside the input.

Each resized axis is one weight matrix (input size x output size), built
on the host in f32 with JAX's arithmetic (`jax/_src/image/scale.py:
compute_weight_mat`, including the FMA that XLA's CPU code makes of the
sample positions), and applied as a banded sum over that axis's nonzero
taps. The taps sum in another order than XLA's einsum, so the result
agrees with JAX's to f32 rounding (the tests say by how much).
"""

from __future__ import annotations

import functools

import numpy as np
import torch



@functools.lru_cache(maxsize=64)
def weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) f32 triangle-kernel weights of one axis."""
    f32 = np.float32
    # JAX takes the scale and its inverse as Python floats (f64) and rounds
    # them to f32 where they meet an array.
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    # XLA fuses (i + 0.5) * inv_scale - 0.5 into one FMA on the CPU: the
    # f64 product of two f32 values is exact, so one rounding to f32 after
    # the subtraction gives the FMA's result.
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)).astype(np.float64)
                * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(in_size - 0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _taps(in_size: int, out_size: int):
    """The nonzero weights of each output as (out, T) input rows and
    weights, lowest row first; short outputs are padded with weight 0."""
    w = weight_matrix(in_size, out_size)
    nz = [np.nonzero(w[:, j])[0] for j in range(out_size)]
    T = max(1, max(len(r) for r in nz))
    rows = np.zeros((out_size, T), np.int64)
    wts = np.zeros((out_size, T), np.float32)
    for j, r in enumerate(nz):
        rows[j, : len(r)] = r
        wts[j, : len(r)] = w[r, j]
    return rows, wts


def resize_bilinear(x, out_hw, dims=(-2, -1)):
    """Resize the two spatial axes `dims` of `x` (any leading and trailing
    axes) to `out_hw` = (H', W'), as `jax.image.resize(..., "bilinear")`
    does, first axis first; an axis whose size does not change is left
    untouched, as JAX leaves it. Each output is its taps' weighted sum in
    a fixed order (lowest input row first, one elementwise op per tap), so
    the card and the CPU compute the same bits."""
    x = x.to(torch.float32)
    for d, n in zip(dims, out_hw):
        d = d % x.dim()
        m = x.shape[d]
        if m == n:
            continue
        rows, wts = _taps(m, n)
        rows = torch.from_numpy(rows).to(x.device)
        wts = torch.from_numpy(wts).to(x.device)
        shape = [1] * x.dim()
        shape[d] = n
        acc = None
        for t in range(rows.shape[1]):
            term = torch.index_select(x, d, rows[:, t]) * wts[:, t].reshape(shape)
            acc = term if acc is None else acc + term
        x = acc
    return x
