"""Batched small-matrix decompositions.

Port of `vslam_tpu/ops/linalg.py`: the same closed-form and
shift-and-invert algorithms (not `torch.linalg`), so that results agree
with the JAX package to f32 rounding.

The minimal solves round as the JAX package's jitted CPU code does (its
fused multiply-adds, its reduction orders, glibc's `cosf` / `sinf` /
`atan2f` through `ops.libm`), with the same bits on the card:
`det3`, `eigh3x3`, `svd3x3`, `polar3x3`, `smallest_eigvec_psd` and the
Cholesky solves (`tests/test_torch_geometry.py::
test_minimal_solves_round_as_jit`; `chip_smoke.rounding_mismatches`).

The card's time for these tiny batched solves is the host's, one launch
per tensor op, so they are written for few ops: operands gathered from
a flat matrix by one index, independent sums run side by side as lanes
of one tensor, the Cholesky factor right-looking (each trailing update
one op, in the same per-entry order as the unrolled form).

Provided:
  f32_matmuls()  — context manager pinning full-f32 products on the card.
  dot / matmul3  — short sums in index order, each product fused.
  eigh3x3 / eigh_small — symmetric eigendecompositions (ascending).
  svd3x3 / polar3x3 / polar_newton3x3 — 3x3 SVD and nearest rotation.
  smallest_eigvec_psd, svd4x4_nullvec — null vectors by shift-and-invert.
  cholesky_solve_small, inv_spd_small — unrolled small SPD solves.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from vslam_tpu_torch.ops import libm
from vslam_tpu_torch.ops.device import constant, fma, fms, hold, reciprocal, rows, sqrt
from vslam_tpu_torch.ops.se3 import cross

_I64 = torch.int64


@contextlib.contextmanager
def f32_matmuls():
    """Pin full-float32 products for everything run inside (the port's
    counterpart of `vslam_tpu.ops.linalg.f32_matmuls`): on the card an
    f32 matmul may run in TF32 and an f32 convolution does by default,
    which the 5-cm geometry gates cannot tolerate. Restores both flags
    on exit."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def _pick(x, idx):
    """x[..., idx] for a tuple of indices into the last axis (one op)."""
    return torch.index_select(x, -1, constant(idx, _I64, x.device))


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _eye3(like):
    return constant(((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)), like.dtype, like.device)


# det3: the six triple products (first, second, third factor as flat
# indices) in the order XLA's CPU code sums them, and their signs.
_DET3_IDX = (0, 1, 2, 2, 0, 1, 4, 5, 3, 4, 5, 3, 8, 6, 7, 6, 7, 8)
_DET3_SIGN = (1.0, 1.0, 1.0, -1.0, -1.0, -1.0)


def det3(A):
    """Determinant of (..., 3, 3): `jnp.linalg.det`'s six-product sum,
    rounded as XLA's CPU code rounds it (each triple product fused into
    the running sum, from the second term)."""
    g = _pick(A.flatten(-2), _DET3_IDX).unflatten(-1, (3, 6))
    p = g[..., 0, :] * g[..., 1, :] * constant(_DET3_SIGN, A.dtype, A.device)
    f = g[..., 2, :]
    s = p[..., 1] * f[..., 1]
    for k in (0, 2, 3, 4, 5):
        s = fma(p[..., k], f[..., k], s)
    return s


def dot(a, b):
    """sum_k a_k b_k over the last axis as XLA's CPU code sums a short axis:
    from 0, in order, each product fused into the running sum."""
    acc = constant(0.0, a.dtype, a.device)
    for x, y in zip(a.unbind(-1), b.unbind(-1)):
        acc = fma(x, y, acc)
    return acc


def matmul3(a, b):
    """(..., n, k) @ (..., k, m) for small k, each entry summed as `dot`
    (XLA's CPU dot of small matrices)."""
    acc = constant(0.0, a.dtype, a.device)
    for col, row in zip(a.unsqueeze(-1).unbind(-2), b.unsqueeze(-2).unbind(-3)):
        acc = fma(col, row, acc)
    return acc


# _cross: from [a, b] (6 lanes) the operands of a_{i+1} b_{i+2} -
# a_{i+2} b_{i+1}, i = 0..2.
_CROSS_IDX = (1, 2, 0, 5, 3, 4, 2, 0, 1, 4, 5, 3)


def _cross(a, b):
    """`jnp.cross` with XLA's contraction: each a_i b_j - a_k b_l one FMA."""
    g = _pick(torch.cat(torch.broadcast_tensors(a, b), dim=-1), _CROSS_IDX)
    return fma(g[..., 0:3], g[..., 3:6], -(g[..., 6:9] * g[..., 9:12]))


# _eigvec_from_cross: the same operands for the three row pairs (0, 1),
# (0, 2), (1, 2) of a flat 3x3 matrix, as (4, pair, component).
_ROW_CROSS_IDX = tuple(
    3 * rows[p] + (i + sh) % 3
    for rows, sh in (((0, 0, 1), 1), ((1, 2, 2), 2), ((0, 0, 1), 2), ((1, 2, 2), 1))
    for p in range(3) for i in range(3))


def _eigvec_from_cross(M):
    """The cross product of two rows of M with the largest norm (the first
    of the pairs (0, 1), (0, 2), (1, 2) on ties) and its squared norm."""
    g = _pick(M.flatten(-2), _ROW_CROSS_IDX).unflatten(-1, (4, 3, 3))
    c = fma(g[..., 0, :, :], g[..., 1, :, :], -(g[..., 2, :, :] * g[..., 3, :, :]))
    n = dot(c, c)
    ge = _pick(n, (0, 0, 1)) >= _pick(n, (1, 2, 2))
    dev = M.device
    k = torch.where(ge[..., 0] & ge[..., 1], constant(0, _I64, dev),
                    torch.where(ge[..., 2], constant(1, _I64, dev), constant(2, _I64, dev)))
    v = c.gather(-2, k[..., None, None].expand(k.shape + (1, 3)))[..., 0, :]
    return v, n.gather(-1, k[..., None])[..., 0]


def _unit_min(v):
    """The unit vector along v's smallest |component| (the first on ties)."""
    return rows(_eye3(v), torch.argmin(torch.abs(v), dim=-1))


# eigh3x3's final order: for 2 max_first + swap, the lanes of
# (mu1, mu2, lam_a) / (u1, u2, va) that become eigenvalues 0, 1, 2.
_EIGH_ORDER = ((2, 0, 1), (2, 1, 0), (0, 1, 2), (1, 0, 2))


def eigh3x3(A):
    """Closed-form symmetric 3x3 eigendecomposition (ascending): Cardano
    roots, cross-product eigenvector of the best-separated extreme, exact
    2x2 solve in its complement (`vslam_tpu.ops.linalg.eigh3x3`).

    Rounded as the JAX package's jitted CPU code rounds it: the same
    operations, each multiply-add XLA contracts one FMA (`device.fma`; a
    negated product first becomes a subtraction, as LLVM canonicalises
    it), short sums in index order, divisions by constants as products
    with their f32 reciprocals, a correctly rounded square root
    (`device.sqrt`) and glibc's `cosf` / `sinf` / `atan2f` (`ops.libm`).
    Bit-equal to jitted JAX on the CPU (`tests/test_torch_geometry.py`)."""
    dt, dev = A.dtype, A.device

    def c(v):
        return constant(v, dt, dev)

    scale = torch.amax(torch.abs(A), dim=(-2, -1), keepdim=True)
    scale = torch.where(scale < 1e-30, c(1.0), scale)
    S = A / scale
    diag = S.diagonal(dim1=-2, dim2=-1)
    third = reciprocal(3.0, dt, dev)
    tr = (diag[..., 0] + diag[..., 1]) + diag[..., 2]
    # B = S - tr / 3 I, its diagonal entries each one FMA.
    B = S.clone()
    B.diagonal(dim1=-2, dim2=-1).copy_(fma((-tr)[..., None], third, diag))
    # Lanes (p1, p2): fma(s12, s12, fma(s01, s01, s02^2)) and
    # fma(b22, b22, fma(b00, b00, b11^2)).
    g = _pick(B.flatten(-2), (2, 4, 1, 0, 5, 8))
    p12 = fma(g[..., 4:6], g[..., 4:6], fma(g[..., 2:4], g[..., 2:4], g[..., 0:2] * g[..., 0:2]))
    p = sqrt(torch.clamp(fma(p12[..., 0], c(2.0), p12[..., 1]) * reciprocal(6.0, dt, dev),
                         min=0.0))
    psafe = torch.where(p < 1e-25, c(1.0), p)
    C = B / psafe[..., None, None]
    # The cofactors (m0, m1, m2) = c11 c22 - c12^2, c01 c22 - c12 c02,
    # c01 c12 - c11 c02.
    g = _pick(C.flatten(-2), (4, 1, 1, 8, 8, 5, 5, 5, 4, 5, 2, 2))
    m = fma(g[..., 0:3], g[..., 3:6], -(g[..., 6:9] * g[..., 9:12]))
    c0 = C[..., 0, :]
    detB = fma(c0[..., 2], m[..., 2], fma(c0[..., 0], m[..., 0], -(c0[..., 1] * m[..., 1])))
    r = torch.clamp(detB * c(0.5), -1.0, 1.0)
    phi = libm.atan2f(sqrt((c(1.0) - r) * (r + c(1.0))), r) * third  # acos(r) / 3
    # Lanes (lam_max, lam_min) from cos(phi) and cos(phi + 2 pi / 3).
    cos = libm.sincos(phi[..., None] + c((0.0, 2.0943951023931953)))[..., 1]
    lam = fma((p * c(2.0))[..., None], cos, (tr * third)[..., None])
    lam_max, lam_min = lam[..., 0], lam[..., 1]
    lam_mid = (tr - lam_max) - lam_min  # XLA folds 3 * (tr / 3) to tr

    max_first = (lam_max - lam_mid) >= (lam_mid - lam_min)
    lam_a = torch.where(max_first, lam_max, lam_min)

    va_raw, na2 = _eigvec_from_cross(S - lam_a[..., None, None] * _eye3(A))
    ok_a = na2 > 1e-20
    va = torch.where(ok_a[..., None], va_raw / sqrt(na2)[..., None], _eye3(A)[0])

    b1 = _cross(va, _unit_min(va))
    b1 = b1 / sqrt(dot(b1, b1))[..., None]
    b2 = _cross(va, b1)

    # Rows (b1, b2, va), S times each (`matvec`), and the four quadratic
    # forms (m00, m01, m11, lam_a_r) = (b1 S b1, b1 S b2, b2 S b2, va S va).
    W = torch.stack([b1, b2, va], dim=-2)
    SW = matmul3(W, S.transpose(-1, -2))
    q = dot(W.index_select(-2, constant((0, 0, 1, 2), _I64, dev)),
            SW.index_select(-2, constant((0, 1, 1, 2), _I64, dev)))
    m00, m01, m11 = q[..., 0], q[..., 1], q[..., 2]
    half = libm.atan2f(m01 * c(2.0), m00 - m11) * c(0.5)
    sc = libm.sincos(half)
    sn, cs = sc[..., 0], sc[..., 1]
    # Rows (u1, u2) = (cs b1 + sn b2, cs b2 - sn b1), each one FMA.
    sb = sn[..., None, None] * W.index_select(-2, constant((1, 0), _I64, dev))
    U = fma(cs[..., None, None], W[..., 0:2, :], sb * c(((1.0,), (-1.0,))))
    # Lanes (mu1, mu2) = fma(ss, m11, fma(cc, m00, t)), fma(cc, m11,
    # fma(ss, m00, -t)).
    sq = sc * sc  # (ss, cc)
    t = ((cs * c(2.0)) * sn) * m01
    mu = fma(sq, m11[..., None], fma(sq.flip(-1), m00[..., None], t[..., None] * c((1.0, -1.0))))
    swap = mu[..., 0] > mu[..., 1]
    order = rows(constant(_EIGH_ORDER, _I64, dev), max_first * 2 + swap)
    w = torch.cat([mu, q[..., 3:4]], dim=-1).gather(-1, order) * scale[..., 0]
    vecs = torch.cat([U.transpose(-1, -2), va[..., None]], dim=-1)
    return w, vecs.gather(-1, order[..., None, :].expand(vecs.shape))


def _jacobi_sweeps(n: int) -> int:
    if n <= 4:
        return 6
    if n <= 9:
        return 8
    return 9


def eigh_small(A, sweeps: int | None = None):
    """Batched symmetric eigendecomposition (ascending, eigenvectors as
    columns): the analytic 3x3 form, else parallel tournament Jacobi."""
    N = A.shape[-1]
    if N == 3 and sweeps is None:
        return eigh3x3(A)
    if sweeps is None:
        sweeps = _jacobi_sweeps(N)
    V = _eye(N, A).expand(A.shape).clone()
    players = list(range(N)) if N % 2 == 0 else list(range(N)) + [-1]
    Np = len(players)
    rounds = []
    for _ in range(Np - 1):
        pr = []
        for k in range(Np // 2):
            a, b = players[k], players[Np - 1 - k]
            if a >= 0 and b >= 0:
                pr.append((min(a, b), max(a, b)))
        rounds.append(pr)
        players = [players[0]] + [players[-1]] + players[1:-1]
    n_pairs = min(len(r) for r in rounds)
    rounds = [r[:n_pairs] for r in rounds] * sweeps
    eyeN = _eye(N, A)
    for r in rounds:
        EP = eyeN[[p for p, _ in r]]
        EQ = eyeN[[q for _, q in r]]
        app = torch.einsum("...ij,ki,kj->...k", A, EP, EP)
        aqq = torch.einsum("...ij,ki,kj->...k", A, EQ, EQ)
        apq = torch.einsum("...ij,ki,kj->...k", A, EP, EQ)
        small = torch.abs(apq) < 1e-20
        denom = torch.where(small, 1.0, 2.0 * apq)
        tau = (aqq - app) / denom
        t = torch.sign(tau) / (torch.abs(tau) + sqrt(1.0 + tau * tau))
        t = torch.where(small, 0.0, t)
        c = 1.0 / sqrt(1.0 + t * t)
        s = t * c
        cm1 = c - 1.0
        G = (
            eyeN.expand(A.shape)
            + torch.einsum("...k,ki,kj->...ij", cm1, EP, EP)
            + torch.einsum("...k,ki,kj->...ij", cm1, EQ, EQ)
            + torch.einsum("...k,ki,kj->...ij", s, EP, EQ)
            - torch.einsum("...k,ki,kj->...ij", s, EQ, EP)
        )
        A = G.transpose(-1, -2) @ A @ G
        V = V @ G
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    w_sorted = torch.gather(w, -1, order)
    V_sorted = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w_sorted, V_sorted


def _normalize_or(v, fallback, eps=1e-12):
    """v / |v| where |v|^2 > eps, else fallback."""
    n2 = dot(v, v)
    ok = n2 > eps
    return torch.where(ok[..., None], v / sqrt(n2)[..., None], fallback)


def _scale_last_column(U, s):
    """U with its last column times s (the others times 1, exactly)."""
    return torch.cat([U[..., :2], U[..., 2:] * s[..., None, None]], dim=-1)


def svd3x3(A):
    """Batched full SVD of (..., 3, 3) via the eigendecomposition of
    A^T A: returns (U, S, Vt), descending singular values. Rounded as
    jitted JAX rounds it on the CPU (see `eigh3x3`)."""
    V = eigh3x3(matmul3(A.transpose(-1, -2), A))[1].flip(-1)
    Bt = matmul3(A, V).transpose(-1, -2)
    n2 = dot(Bt, Bt)
    S = sqrt(n2)
    b1 = Bt[..., 1, :]
    e0 = _eye3(A)[0]
    u0 = torch.where((n2[..., 0] > 1e-12)[..., None], Bt[..., 0, :] / S[..., 0, None], e0)
    b1o = fms(dot(b1, u0)[..., None], u0, b1)
    fb1 = _cross(u0, _unit_min(u0))
    fb1 = fb1 / sqrt(dot(fb1, fb1))[..., None]
    u1 = _normalize_or(b1o, fb1)
    u2 = _cross(u0, u1)
    u2 = torch.where((dot(u2, Bt[..., 2, :]) < 0)[..., None], -u2, u2)
    U = torch.stack([u0, u1, u2], dim=-1)
    return U, S, V.transpose(-1, -2)


def polar3x3(A):
    """Nearest rotation (det +1): U diag(1, 1, det(U V^T)) V^T."""
    U, _, Vt = svd3x3(A)
    return matmul3(_scale_last_column(U, det3(matmul3(U, Vt))), Vt)


def polar_newton3x3(A, iters=2):
    """Newton polar iteration X <- (X + X^{-T}) / 2 for near-orthogonal
    inputs (cofactor form, no matmuls)."""
    X = A
    for _ in range(iters):
        r0, r1, r2 = X[..., 0, :], X[..., 1, :], X[..., 2, :]
        c0, c1, c2 = cross(r1, r2), cross(r2, r0), cross(r0, r1)
        det = torch.sum(r0 * c0, dim=-1)[..., None, None]
        inv_T = torch.stack([c0, c1, c2], dim=-2) / torch.where(
            torch.abs(det) < 1e-30, 1e-30, det
        )
        X = 0.5 * (X + inv_T)
    return X


def _cholesky_factor_small(H, eps=1e-20):
    """Cholesky factor of (..., N, N) SPD, rounded as XLA's CPU code
    rounds the JAX package's unrolled one: entry (i, j) is
    H_ij - l_i0 l_j0 - l_i1 l_j1 - ..., each `s - l * l'` one FMA, in
    that order. Computed right-looking: after column k, one FMA over the
    trailing block subtracts its products from every entry, which is the
    same sequence per entry. Returns (the negated columns below the
    diagonal, the same as tuples of their entries, the diagonal entries,
    the last pivot before its square root): lists over k of (..., N-k-1)
    and (...,) tensors."""
    N = H.shape[-1]
    R = H.clone()
    ncols, diag = [], []
    for k in range(N):
        pivot = torch.clamp(R[..., k, k], min=eps)
        diag.append(sqrt(pivot))
        ncol = R[..., k + 1:, k] / (-diag[k])[..., None]  # -(a / d), exactly
        if k + 1 < N:
            R[..., k + 1:, k + 1:].addcmul_(ncol[..., :, None], -ncol[..., None, :])
        ncols.append(ncol)
    return ncols, [c.unbind(-1) for c in ncols], diag, pivot


def _cholesky_solve_factored(factor, g):
    """Solve L L^T x = g for the factor of `_cholesky_factor_small`; g
    (..., N) (any batch shape broadcasting with the factor's). The
    forward solve runs column by column (each y_i's sum still in order
    k = 0, 1, ...); the backward sums run in order k = i+1, ..., N-1 as
    XLA's do, so they stay one FMA per term. XLA simplifies the last
    unknown's `(s / sqrt(p)) / sqrt(p)` to `s / p`, so it divides by the
    last pivot itself."""
    ncols, entries, diag, pivot = factor
    N = len(diag)
    s = g.expand(torch.broadcast_shapes(g.shape, diag[0].shape + (N,))).clone()
    sk = s.unbind(-1)  # views: they see the updates below
    y = []
    for k in range(N - 1):
        y.append(sk[k] / diag[k])
        s[..., k + 1:].addcmul_(ncols[k], y[k][..., None])
    x = [None] * N
    x[N - 1] = sk[N - 1] / pivot
    for i in reversed(range(N - 1)):
        acc = y[i]
        for k in range(i + 1, N):
            acc = fma(entries[i][k - i - 1], x[k], acc)
        x[i] = acc / diag[i]
    return torch.stack(x, dim=-1)


def _trace(A):
    """The trace of (..., N, N), summed in index order (XLA's reduce)."""
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    tr = diag[..., 0]
    for k in range(1, A.shape[-1]):
        tr = tr + diag[..., k]
    return tr


def _shift_diagonal(A, shift_rel):
    """A + shift_rel * max(tr A, 1e-30) / N * I, as XLA's CPU code forms
    it: `shift_rel / N` folded, each diagonal entry one FMA."""
    N = A.shape[-1]
    scale = torch.clamp(_trace(A), min=1e-30)[..., None]
    H = A.clone()
    diag = H.diagonal(dim1=-2, dim2=-1)
    diag.copy_(fma(scale, constant(shift_rel / N, A.dtype, A.device), diag))
    return H


@functools.lru_cache(maxsize=16)
def _start_vector(N, dtype, device):
    """The iteration's fixed start, 1/sqrt(N) + 0.1 i / N normalised, as
    XLA evaluates it (products and sums rounded apart); one read-only
    tensor per (N, dtype, device)."""
    v0 = (torch.arange(N, dtype=dtype) * constant(0.1 / N, dtype, "cpu")
          + constant(1.0, dtype, "cpu") / torch.sqrt(constant(float(N), dtype, "cpu")))
    sq = v0 * v0
    n2 = sq[0]
    for k in range(1, N):
        n2 = n2 + sq[k]
    return (v0 / sqrt(n2)).to(device)


def smallest_eigvec_psd(AtA, iters=3, shift_rel=1e-5):
    """Unit eigenvector of the smallest eigenvalue of a PSD (..., N, N)
    matrix: shift-and-invert iteration on one unrolled Cholesky, rounded
    as XLA's CPU code rounds it (the trace and the norms summed in order,
    each norm's products fused; the shift's `shift_rel / N` folded)."""
    N = AtA.shape[-1]
    factor = _cholesky_factor_small(_shift_diagonal(AtA, shift_rel))
    v = hold(_start_vector(N, AtA.dtype, torch.device(AtA.device))).expand(AtA.shape[:-1])
    for _ in range(iters):
        v = _cholesky_solve_factored(factor, v)
        v = v / torch.clamp(sqrt(dot(v, v)), min=1e-30)[..., None]
    return v


def inv_spd_small(H, eps=1e-20, shift_rel=0.0):
    """Batched inverse of small SPD (..., N, N) via the unrolled Cholesky:
    one solve of the N identity columns side by side."""
    N = H.shape[-1]
    if shift_rel:
        H = _shift_diagonal(H, shift_rel)
    factor = _cholesky_factor_small(H[..., None, :, :], eps)
    # Row j of the solution is column j of the inverse.
    return _cholesky_solve_factored(factor, _eye(N, H)).transpose(-1, -2).contiguous()


def cholesky_solve_small(H, g, eps=1e-20):
    """Solve H x = g for small SPD H (..., N, N), batched, unrolled."""
    return _cholesky_solve_factored(_cholesky_factor_small(H, eps), g)


def svd4x4_nullvec(A):
    """Smallest right singular vector of (..., 4, 4) via shift-and-invert
    on A^T A."""
    return smallest_eigvec_psd(matmul3(A.transpose(-1, -2), A))
