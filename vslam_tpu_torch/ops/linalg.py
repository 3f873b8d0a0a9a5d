"""Batched small-matrix decompositions.

Port of `vslam_tpu/ops/linalg.py`: the same closed-form and
shift-and-invert algorithms (not `torch.linalg`), so that results agree
with the JAX package to f32 rounding.

Provided:
  f32_matmuls()  — context manager pinning full-f32 products on the card.
  eigh3x3 / eigh_small — symmetric eigendecompositions (ascending).
  svd3x3 / polar3x3 / polar_newton3x3 — 3x3 SVD and nearest rotation.
  smallest_eigvec_psd, svd4x4_nullvec — null vectors by shift-and-invert.
  cholesky_solve_small, inv_spd_small — unrolled small SPD solves.
"""

from __future__ import annotations

import contextlib

import torch

from vslam_tpu_torch.ops.se3 import cross, norm


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


def det3(A):
    """Determinant of (..., 3, 3) by cofactor expansion."""
    return (
        A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
        - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
        + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0])
    )


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _unit(k, n, like):
    """Rows of the n x n identity picked by the integer tensor k (any
    shape), built by comparison: indexing with a 0-dim tensor would read k
    back to the host."""
    return (torch.arange(n, device=like.device) == k[..., None]).to(like.dtype)


def _eigvec_from_cross(M):
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01, c02, c12 = cross(r0, r1), cross(r0, r2), cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    use01 = (n01 >= n02) & (n01 >= n12)
    use02 = (~use01) & (n02 >= n12)
    v = torch.where(use01[..., None], c01, torch.where(use02[..., None], c02, c12))
    n2 = torch.where(use01, n01, torch.where(use02, n02, n12))
    return v, n2


def eigh3x3(A):
    """Closed-form symmetric 3x3 eigendecomposition (ascending): Cardano
    roots, cross-product eigenvector of the best-separated extreme, exact
    2x2 solve in its complement (`vslam_tpu.ops.linalg.eigh3x3`)."""
    eye = _eye(3, A)
    scale = torch.amax(torch.abs(A), dim=(-2, -1), keepdim=True)
    scale = torch.where(scale < 1e-30, 1.0, scale)
    S = A / scale
    a00, a11, a22 = S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]
    a01, a02, a12 = S[..., 0, 1], S[..., 0, 2], S[..., 1, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    psafe = torch.where(p < 1e-25, 1.0, p)
    c00, c11, c22 = b00 / psafe, b11 / psafe, b22 / psafe
    c01, c02, c12 = a01 / psafe, a02 / psafe, a12 / psafe
    detB = (
        c00 * (c11 * c22 - c12 * c12)
        - c01 * (c01 * c22 - c12 * c02)
        + c02 * (c01 * c12 - c11 * c02)
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    two_p = 2.0 * p
    lam_max = q + two_p * torch.cos(phi)
    lam_min = q + two_p * torch.cos(phi + 2.0943951023931953)
    lam_mid = 3.0 * q - lam_max - lam_min

    max_first = (lam_max - lam_mid) >= (lam_mid - lam_min)
    lam_a = torch.where(max_first, lam_max, lam_min)

    va_raw, na2 = _eigvec_from_cross(S - lam_a[..., None, None] * eye)
    e0 = torch.zeros_like(va_raw)
    e0[..., 0].fill_(1.0)  # a fill: `= 1.0` copies a host scalar
    ok_a = na2 > 1e-20
    va = torch.where(
        ok_a[..., None], va_raw / torch.sqrt(torch.where(ok_a, na2, 1.0))[..., None], e0
    )

    ek = _unit(torch.argmin(torch.abs(va), dim=-1), 3, A)
    b1 = cross(va, ek)
    b1 = b1 / norm(b1, keepdim=True)
    b2 = cross(va, b1)

    Sb1 = torch.sum(S * b1[..., None, :], dim=-1)
    Sb2 = torch.sum(S * b2[..., None, :], dim=-1)
    m00 = torch.sum(b1 * Sb1, dim=-1)
    m01 = torch.sum(b1 * Sb2, dim=-1)
    m11 = torch.sum(b2 * Sb2, dim=-1)
    half = 0.5 * torch.atan2(2.0 * m01, m00 - m11)
    c, sn = torch.cos(half), torch.sin(half)
    u1 = c[..., None] * b1 + sn[..., None] * b2
    u2 = -sn[..., None] * b1 + c[..., None] * b2
    mu1 = c * c * m00 + 2.0 * c * sn * m01 + sn * sn * m11
    mu2 = sn * sn * m00 - 2.0 * c * sn * m01 + c * c * m11
    swap = mu1 > mu2
    lo = torch.where(swap, mu2, mu1)
    hi = torch.where(swap, mu1, mu2)
    vlo = torch.where(swap[..., None], u2, u1)
    vhi = torch.where(swap[..., None], u1, u2)
    Sva = torch.sum(S * va[..., None, :], dim=-1)
    lam_a_r = torch.sum(va * Sva, dim=-1)

    s = scale[..., 0, 0]
    w = torch.where(
        max_first[..., None],
        torch.stack([lo, hi, lam_a_r], dim=-1),
        torch.stack([lam_a_r, lo, hi], dim=-1),
    ) * s[..., None]
    V = torch.where(
        max_first[..., None, None],
        torch.stack([vlo, vhi, va], dim=-1),
        torch.stack([va, vlo, vhi], dim=-1),
    )
    return w, V


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
        t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
        t = torch.where(small, 0.0, t)
        c = 1.0 / torch.sqrt(1.0 + t * t)
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
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    ok = n2 > eps
    safe = v / torch.sqrt(torch.where(ok, n2, 1.0))
    return torch.where(ok, safe, fallback), ok[..., 0]


def svd3x3(A):
    """Batched full SVD of (..., 3, 3) via the eigendecomposition of
    A^T A: returns (U, S, Vt), descending singular values."""
    AtA = A.transpose(-1, -2) @ A
    lam, V = eigh_small(AtA)
    V = V.flip(-1)
    B = A @ V
    S = torch.sqrt(torch.sum(B * B, dim=-2))
    b0, b1 = B[..., :, 0], B[..., :, 1]
    e0 = torch.zeros_like(b0)
    e0[..., 0].fill_(1.0)  # a fill: `= 1.0` copies a host scalar
    u0, _ = _normalize_or(b0, e0)
    b1o = b1 - torch.sum(b1 * u0, dim=-1, keepdim=True) * u0
    ek = _unit(torch.argmin(torch.abs(u0), dim=-1), 3, A)
    fb1 = cross(u0, ek)
    fb1 = fb1 / norm(fb1, keepdim=True)
    u1, _ = _normalize_or(b1o, fb1)
    u2 = cross(u0, u1)
    s2 = torch.sum(u2 * B[..., :, 2], dim=-1)
    u2 = torch.where((s2 < 0)[..., None], -u2, u2)
    U = torch.stack([u0, u1, u2], dim=-1)
    return U, S, V.transpose(-1, -2)


def polar3x3(A):
    """Nearest rotation (det +1): U diag(1, 1, det(U V^T)) V^T."""
    U, _, Vt = svd3x3(A)
    det = det3(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return (U * D[..., None, :]) @ Vt


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
    N = H.shape[-1]
    L = [[None] * N for _ in range(N)]
    for j in range(N):
        s = H[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=eps))
        L[j][j] = d
        for i in range(j + 1, N):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / d
    return L


def _cholesky_solve_factored(L, g):
    N = len(L)
    y = [None] * N
    for i in range(N):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * N
    for i in reversed(range(N)):
        s = y[i]
        for k in range(i + 1, N):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def smallest_eigvec_psd(AtA, iters=3, shift_rel=1e-5):
    """Unit eigenvector of the smallest eigenvalue of a PSD (..., N, N)
    matrix: shift-and-invert iteration on one unrolled Cholesky."""
    N = AtA.shape[-1]
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)
    shift = (shift_rel * torch.clamp(tr, min=1e-30) / N)[..., None, None]
    H = AtA + shift * _eye(N, AtA)
    L = _cholesky_factor_small(H)
    v0 = torch.full(AtA.shape[:-1], 1.0, dtype=AtA.dtype, device=AtA.device) / torch.sqrt(
        torch.full((), float(N), dtype=AtA.dtype, device=AtA.device)
    )
    v0 = v0 + torch.arange(N, dtype=AtA.dtype, device=AtA.device) * (0.1 / N)
    v = v0 / norm(v0, keepdim=True)
    for _ in range(iters):
        v = _cholesky_solve_factored(L, v)
        v = v / torch.clamp(norm(v, keepdim=True), min=1e-30)
    return v


def inv_spd_small(H, eps=1e-20, shift_rel=0.0):
    """Batched inverse of small SPD (..., N, N) via the unrolled Cholesky."""
    N = H.shape[-1]
    if shift_rel:
        tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
        H = H + (shift_rel * torch.clamp(tr, min=1e-30) / N)[..., None, None] * _eye(N, H)
    L = _cholesky_factor_small(H, eps)
    eye = _eye(N, H)
    cols = [_cholesky_solve_factored(L, eye[j]) for j in range(N)]
    return torch.stack(cols, dim=-1)


def cholesky_solve_small(H, g, eps=1e-20):
    """Solve H x = g for small SPD H (..., N, N), batched, unrolled."""
    return _cholesky_solve_factored(_cholesky_factor_small(H, eps), g)


def svd4x4_nullvec(A):
    """Smallest right singular vector of (..., 4, 4) via shift-and-invert
    on A^T A."""
    return smallest_eigvec_psd(A.transpose(-1, -2) @ A)
