"""Single-precision `sinf`, `cosf` and `atan2f` as the JAX package's CPU
code computes them.

XLA's CPU backend does not expand these functions itself: its compiled
code calls the C library's `sinf`, `cosf` and `atan2f` (glibc). The
closed-form eigensolver (`ops.linalg.eigh3x3`, and through it `svd3x3`
and every minimal solve) turns on their last bit, so the port computes
them as glibc does, with tensor ops that give the same bits on the CPU
and on the card:

  * `sincos`: glibc's `sincosf` polynomials (the variant built for CPUs
    with fused multiply-add: each `a * b + c` one FMA), evaluated in f64
    after the fast argument reduction by pi/2 (inputs |x| < 120; the
    eigensolver's angles lie in [-pi/2, pi + 2pi/3]);
  * `atan2f`: fdlibm's `__ieee754_atan2f` and `atanf` in f32 arithmetic
    (no FMA), finite inputs.

The card's time here is the host's (one launch per tensor op on tiny
tensors), so both are written for few ops: the branches of glibc's code
become rows of small tables picked by one index, and the sine and
cosine polynomials run side by side in one pair of lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from vslam_tpu_torch.ops.device import constant, fma, rows

_H = float.fromhex
# glibc's __sincosf_table: per table c0..c4 (cosine) and s1..s3 (sine);
# table 1 (quadrants 2 and 3) negates the cosine coefficients.
_SINCOS = {
    "c0": _H("0x1p0"), "c1": _H("-0x1.ffffffd0c621cp-2"), "c2": _H("0x1.55553e1068f19p-5"),
    "c3": _H("-0x1.6c087e89a359dp-10"), "c4": _H("0x1.99343027bf8c3p-16"),
    "s1": _H("-0x1.555545995a603p-3"), "s2": _H("0x1.1107605230bc4p-7"),
    "s3": _H("-0x1.994eb3774cf24p-13"),
}
_HPI_INV = _H("0x1.45f306dc9c883p+23")  # 2/pi * 2^24
_HPI = _H("0x1.921fb54442d18p+0")  # pi/2

# fdlibm's atanf: odd and even polynomial coefficients, atan(0.5, 1, 1.5,
# inf) split into high and low parts.
_AT = (0.3333333432674408, -0.20000000298023224, 0.1428571492433548, -0.1111111044883728,
       0.09090887010097504, -0.07691875845193863, 0.06661073118448257, -0.05833570286631584,
       0.049768779426813126, -0.03653157129883766, 0.016285819932818413)
_ATANHI = (0.46364760398864746, 0.7853981256484985, 0.9827936887741089, 1.570796251296997)
_ATANLO = (5.01215824399992e-09, 3.774894707930798e-08, 3.447321716976148e-08,
           7.549789415861596e-08)
_PI, _PI_LO = 3.1415927410125732, 8.742277657347586e-08
_PI_2 = 1.5707963705062866
# pi/2 + pi_lo/2 (fdlibm's pi_lo is -_PI_LO), rounded in f32 as fdlibm
# forms it.
_F = np.float32
_PI_2_LO = float(_F(_PI_2) - _F(_PI_LO / 2))


# sincosf: per output lane (sin, cos) and quadrant n & 3, which
# polynomial it takes (0 sine, 1 cosine) and its sign. glibc negates the
# sine's argument in quadrants 1 and 2 (its sign[n & 3]) and the cosine's
# coefficients in quadrants 2 and 3; odd quadrants swap the outputs.
_QUADRANT_PICK = ((0, 1), (1, 0), (0, 1), (1, 0))
_QUADRANT_SIGN = ((1.0, 1.0), (1.0, -1.0), (-1.0, -1.0), (-1.0, 1.0))


def sincos(y):
    """sinf(y) and cosf(y) for f32 `y`, |y| < 120, as glibc computes them:
    one tensor (..., 2) holding (sin, cos)."""
    f64, dev = torch.float64, y.device

    def c(v):
        return constant(v, f64, dev)

    x = y.to(f64)
    n = ((x * c(_HPI_INV)).to(torch.int32) + 0x800000) >> 24
    xr = fma(n.to(f64), c(-_HPI), x)
    x2 = xr * xr
    x2e = x2[..., None]
    # Lanes (sin, cos): glibc's polynomials fma(fma(x2, s3, s2), x2 * x3,
    # fma(x3, s1, x)) and fma(fma(x2, c4, c3), x2 * x4, fma(x4, c2,
    # fma(x2, c1, c0))), with x3 = x2 * x and x4 = x2 * x2.
    p = x2e * torch.stack([xr, x2], dim=-1)
    q = fma(p, c((_SINCOS["s1"], _SINCOS["c2"])),
            torch.stack([xr, fma(x2, c(_SINCOS["c1"]), c(_SINCOS["c0"]))], dim=-1))
    a = fma(x2e, c((_SINCOS["s3"], _SINCOS["c4"])), c((_SINCOS["s2"], _SINCOS["c3"])))
    poly = fma(a, x2e * p, q)
    # The polynomials are odd / even in x and exact under negation, so the
    # quadrant's signs are applied to the results.
    quad = (n & 3).long()
    pick = rows(constant(_QUADRANT_PICK, torch.int64, dev), quad)
    sign = rows(constant(_QUADRANT_SIGN, f64, dev), quad)
    return (poly.gather(-1, pick) * sign).float()


# fdlibm's atanf reduces x >= 0 on the intervals split at these bounds:
# interval i (0-5) computes num / den with num = x * a + b and
# den = x * a' + b' (each product exact or a rounded f32 product, each sum
# rounded), and adds atan of the interval's point as hi - ((t - lo) - x).
# Row 0 (x < 7/16) is fdlibm's `x - t`; row 5 (x >= 2^25) gives num = 0,
# so the result is hi + lo, fdlibm's atanhi[3] + atanlo[3].
_ATAN_BOUNDS = (0.4375, 0.6875, 1.1875, 2.4375, 2.0 ** 25)
_ATAN_ROWS = (  # a, a', b, b', hi, lo
    (1.0, 0.0, 0.0, 1.0, 0.0, 0.0),
    (2.0, 1.0, -1.0, 2.0, _ATANHI[0], _ATANLO[0]),
    (1.0, 1.0, -1.0, 1.0, _ATANHI[1], _ATANLO[1]),
    (1.0, 1.5, -1.5, 1.0, _ATANHI[2], _ATANLO[2]),
    (0.0, 1.0, -1.0, 0.0, _ATANHI[3], _ATANLO[3]),
    (0.0, 1.0, 0.0, 0.0, _ATANHI[3], _ATANLO[3]),
)


def _atanf_nonneg(x):
    """fdlibm's atanf for finite f32 x >= 0: the argument reduction of its
    interval (one quotient), the odd and even polynomials, atan of the
    interval's point in two parts. For x < 2^-29 fdlibm returns x, which
    this path gives too (its correction is below half an ulp of x)."""
    dt, dev = x.dtype, x.device
    row = rows(constant(_ATAN_ROWS, dt, dev),
               torch.bucketize(x, constant(_ATAN_BOUNDS, dt, dev), right=True))
    nd = x[..., None] * row[..., 0:2] + row[..., 2:4]
    xr = nd[..., 0] / nd[..., 1]
    z = xr * xr
    w = z * z
    we = w[..., None]
    # The odd and even polynomials in w, side by side: both run
    # (+ coefficient, * w) from a coefficient times w; the odd one then
    # adds aT[0] and takes a factor z.
    s = constant((_AT[10], _AT[9]), dt, dev) * we
    for k in (8, 6, 4, 2):
        s = (s + constant((_AT[k], _AT[k - 1]), dt, dev)) * we
    t = xr * ((s[..., 0] + constant(_AT[0], dt, dev)) * z + s[..., 1])
    return row[..., 4] - ((t - row[..., 5]) - xr)


def atan2f(y, x):
    """atan2f(y, x) for finite f32 tensors, as glibc (fdlibm) computes it.
    fdlibm returns atanf(y) for x == 1; the general path below gives the
    same value there (y / 1 is exact), so it has no branch of its own.
    Nor has |y / x| < 2^-60 with x < 0, where fdlibm takes atan 0: the
    quotient is lost in pi_lo, as 0 is."""
    def c(v):
        return constant(v, y.dtype, y.device)

    by, bx = y.view(torch.int32), x.view(torch.int32)
    iy, ix = by & 0x7FFFFFFF, bx & 0x7FFFFFFF
    # Where x == 0 the quotient is inf or nan; the x == 0 and y == 0 rows
    # below replace those results.
    z = _atanf_nonneg(torch.abs(y / x))
    z = torch.where(((iy - ix) >> 23) > 60, c(_PI_2_LO), z)
    nx = bx < 0
    r = torch.copysign(torch.where(nx, c(_PI) - (z + c(_PI_LO)), z), y)
    r = torch.where(ix == 0, torch.copysign(c(_PI_2), y), r)
    return torch.where(iy == 0, torch.where(nx, torch.copysign(c(_PI), y), y), r)
