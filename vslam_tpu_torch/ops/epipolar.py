"""Fundamental / Essential matrix estimation and pose recovery, batch-first.

Port of `vslam_tpu/ops/epipolar.py`: weighted normalized 8-point solves
(null vector by shift-and-invert), Sampson / symmetric epipolar
distances, `recoverPose`-style cheirality selection, and the Sampson
Gauss-Newton polish. Correspondences are pixels; recover_pose returns
(R, t) with x2 = R x1 + t, ||t|| = 1.
"""

from __future__ import annotations

import torch

from vslam_tpu_torch.ops import camera as cam
from vslam_tpu_torch.ops import device, linalg, se3


def _halving_sum(x):
    """Sum over the last axis of size 8 as XLA's CPU code reduces it: lane
    i + lane i + 4, then i + i + 2, then the two."""
    x = x[..., :4] + x[..., 4:]
    x = x[..., :2] + x[..., 2:]
    return x[..., 0] + x[..., 1]


def _hartley_normalize(uv, w, eps=1e-9):
    """Weighted Hartley normalization: (uv_n, T). On a minimal set (8
    points) it rounds as XLA's CPU code does: the mean summed in order
    with fused products, each distance's two squares fused, the mean
    distance summed by halving. uv may carry batch axes in front of w's
    (`eight_point` normalises both views of a minimal set at once)."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=eps)
    if uv.shape[-2] == 8:
        mean = linalg.matmul3(w[..., None, :], uv)[..., 0, :] / wsum
        dv = uv - mean[..., None, :]
        d = device.sqrt(device.fma(dv[..., 1], dv[..., 1], dv[..., 0] * dv[..., 0]))
        mean_d = _halving_sum(d * w) / wsum[..., 0]
    else:
        mean = torch.sum(uv * w[..., None], dim=-2) / wsum
        dv = uv - mean[..., None, :]
        d = se3.norm(dv)
        mean_d = torch.sum(d * w, dim=-1) / wsum[..., 0]
    s = device.constant(2.0 ** 0.5, uv.dtype, uv.device) / torch.clamp(mean_d, min=eps)
    uv_n = dv * s[..., None, None]
    # T = [[s, 0, -s m0], [0, s, -s m1], [0, 0, 1]], picked from
    # (s, -s m0, -s m1, 0, 1).
    vals = torch.cat([s[..., None], (-s)[..., None] * mean,
                      device.constant((0.0, 1.0), s.dtype, s.device).expand(s.shape + (2,))],
                     dim=-1)
    T = torch.index_select(vals, -1, device.constant((0, 3, 1, 3, 0, 2, 3, 3, 4), torch.int64,
                                                     s.device))
    return uv_n, T.unflatten(-1, (3, 3))


def eight_point(uv1, uv2, weights=None, essential=False, nullvec_iters=3):
    """Weighted normalized 8-point algorithm -> F (or E), ||F||_F = 1.
    On a minimal set it rounds as the JAX package's jitted CPU code: the
    Hartley step, the null vector and the 3x3 products and norm as XLA
    forms them (`_hartley_normalize`, `linalg.smallest_eigvec_psd`,
    `linalg.matmul3`)."""
    if weights is None:
        weights = torch.ones(uv1.shape[:-1], dtype=uv1.dtype, device=uv1.device)
    if uv1.shape[-2] == 8:
        # Both views at once: a minimal set's sums are elementwise.
        (uv1n, uv2n), (T1, T2) = _hartley_normalize(
            torch.stack(torch.broadcast_tensors(uv1, uv2)), weights)
    else:
        # A long axis is summed by `torch.sum`, whose order on the card
        # follows the number of sums: one view at a time.
        uv1n, T1 = _hartley_normalize(uv1, weights)
        uv2n, T2 = _hartley_normalize(uv2, weights)
    # Rows [x2 x1, x2 y1, x2, y2 x1, y2 y1, y2, x1, y1, 1]: the outer
    # product of (x2, y2, 1) and (x1, y1, 1).
    h1, h2 = (torch.cat([u, torch.ones_like(u[..., :1])], dim=-1) for u in (uv1n, uv2n))
    A = (h2[..., :, None] * h1[..., None, :]).flatten(-2)
    A = A * weights[..., None]
    AtA = torch.einsum("...ni,...nj->...ij", A, A)
    f = linalg.smallest_eigvec_psd(AtA, iters=nullvec_iters)
    F = f.reshape(*f.shape[:-1], 3, 3)
    mm = linalg.matmul3
    U, S, Vt = linalg.svd3x3(F)
    keep2 = device.constant((1.0, 1.0, 0.0), S.dtype, S.device)
    F = mm(mm(T2.transpose(-1, -2), mm(U * (S * keep2)[..., None, :], Vt)), T1)
    if essential:
        U, S, Vt = linalg.svd3x3(F)
        s_mean = (S[..., 0] + S[..., 1]) * 0.5
        F = mm(U * (s_mean[..., None] * keep2)[..., None, :], Vt)
    flat = F.reshape(*F.shape[:-2], 9)
    nrm = device.sqrt(linalg.dot(flat, flat))[..., None, None]
    return F / torch.clamp(nrm, min=1e-12)


def _homog(uv):
    return torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)


def epipolar_distance(F, uv1, uv2):
    """Symmetric epipolar distance (pixels); F in pixel coordinates."""
    x1, x2 = _homog(uv1), _homog(uv2)
    l2 = x1 @ F.transpose(-1, -2)
    l1 = x2 @ F
    num = torch.abs(torch.sum(x2 * l2, dim=-1))
    d2 = num / torch.clamp(se3.norm(l2[..., :2]), min=1e-12)
    d1 = num / torch.clamp(se3.norm(l1[..., :2]), min=1e-12)
    return 0.5 * (d1 + d2)


def sampson_distance(F, uv1, uv2):
    """First-order geometric (Sampson) distance."""
    x1, x2 = _homog(uv1), _homog(uv2)
    Fx1 = x1 @ F.transpose(-1, -2)
    Ftx2 = x2 @ F
    e = torch.sum(x2 * Fx1, dim=-1)
    denom = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return torch.abs(e) / torch.sqrt(torch.clamp(denom, min=1e-12))


def decompose_essential(E):
    """E -> two rotation candidates + unit translation."""
    U, _, Vt = linalg.svd3x3(E)
    detU = linalg.det3(U)
    detVt = linalg.det3(Vt)
    one = torch.ones_like(detU)
    U = U * torch.stack([one, one, detU], dim=-1)[..., None, :]
    Vt = Vt * torch.stack([one, one, detVt], dim=-1)[..., :, None]
    W = device.constant(((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)),
                        E.dtype, E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    t = t / torch.clamp(se3.norm(t, keepdim=True), min=1e-12)
    return R1, R2, t


def _cheirality_count(R, t, xn1, xn2, mask):
    h1 = torch.cat([xn1, torch.ones_like(xn1[..., :1])], dim=-1)
    h2 = torch.cat([xn2, torch.ones_like(xn2[..., :1])], dim=-1)
    Rx1 = h1 @ R.transpose(-1, -2)
    a = torch.sum(Rx1 * Rx1, dim=-1)
    b = -torch.sum(Rx1 * h2, dim=-1)
    c = torch.sum(h2 * h2, dim=-1)
    d = -torch.sum(Rx1 * t[..., None, :], dim=-1)
    e = torch.sum(h2 * t[..., None, :], dim=-1)
    det = a * c - b * b
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    z1 = (d * c - b * e) / det
    z2 = (a * e - b * d) / det
    good = (z1 > 0) & (z2 > 0) & mask
    return torch.sum(good, dim=-1), good


def essential_from_fundamental(F, fx, fy, cx, cy):
    """E = K^T F K for a pixel-coordinate fundamental matrix (..., 3, 3)."""
    K = device.constant(((fx, 0.0, cx), (0.0, fy, cy), (0.0, 0.0, 1.0)), F.dtype, F.device)
    return K.T @ F @ K


def recover_pose(E, uv1, uv2, fx, fy, cx, cy, mask=None):
    """cv::recoverPose equivalent for a single E (3, 3):
    (R, t, n_good, good_mask)."""
    if mask is None:
        mask = torch.ones(uv1.shape[:-1], dtype=torch.bool, device=uv1.device)
    xn1 = cam.normalize_pixels(uv1, fx, fy, cx, cy)
    xn2 = cam.normalize_pixels(uv2, fx, fy, cx, cy)
    R1, R2, t = decompose_essential(E)
    cands_R = torch.stack([R1, R1, R2, R2])
    cands_t = torch.stack([t, -t, t, -t])
    res = [_cheirality_count(cands_R[i], cands_t[i], xn1, xn2, mask) for i in range(4)]
    counts = torch.stack([c for c, _ in res])
    goods = torch.stack([g for _, g in res])
    best = torch.argmax(counts)
    return (se3.orthonormalize(device.take(cands_R, best)), device.take(cands_t, best),
            device.take(counts, best), device.take(goods, best))


def _sampson_signed(E, xn1, xn2):
    x1, x2 = _homog(xn1), _homog(xn2)
    Ex1 = x1 @ E.transpose(-1, -2)
    Etx2 = x2 @ E
    e = torch.sum(x2 * Ex1, dim=-1)
    denom = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return e / torch.sqrt(torch.clamp(denom, min=1e-12))


def refine_pose_sampson(R, t, xn1, xn2, w, iters=8, damping=1e-8):
    """Gauss-Newton polish of a relative pose on the Sampson error over
    5 DoF (so(3) increment + tangent-plane translation increment); each
    step is kept only when the weighted cost decreases."""
    dtype, dev = t.dtype, t.device
    eye5 = torch.eye(5, dtype=dtype, device=dev)
    ex = device.constant((1.0, 0.0, 0.0), dtype, dev)
    ey = device.constant((0.0, 1.0, 0.0), dtype, dev)

    def tangent_basis(tv):
        a = torch.where(torch.abs(tv[0]) < 0.9, ex, ey)
        b1 = cross(tv, a)
        b1 = b1 / torch.clamp(se3.norm(b1), min=1e-12)
        b2 = cross(tv, b1)
        return torch.stack([b1, b2], dim=-1)

    def residuals_at(xi, R0, t0, B):
        # exp_so3 of a (1, 3) batch: under torch.func.jacfwd, arithmetic
        # of a 0-dim tensor with a Python float promotes to f64.
        Rp = se3.exp_so3(xi[None, :3])[0] @ R0
        tp = t0 + B @ xi[3:]
        tp = tp / torch.clamp(se3.norm(tp), min=1e-12)
        return _sampson_signed(se3.hat(tp) @ Rp, xn1, xn2)

    def cost_at(xi, R0, t0, B):
        r = residuals_at(xi, R0, t0, B)
        return torch.sum(w * r * r)

    zero = torch.zeros(5, dtype=dtype, device=dev)
    c0 = cost_at(zero, R, t, tangent_basis(t))
    for _ in range(iters):
        B = tangent_basis(t)
        r = residuals_at(zero, R, t, B)
        J = torch.func.jacfwd(residuals_at)(zero, R, t, B)
        Jw = J * w[:, None]
        H = Jw.T @ J + damping * eye5
        g = Jw.T @ r
        H = H + 1e-6 * torch.trace(H) / 5.0 * eye5
        dxi = -linalg.cholesky_solve_small(H, g)
        c1 = cost_at(dxi, R, t, B)
        ok = c1 < c0
        R = torch.where(ok, se3.exp_so3(dxi[:3]) @ R, R)
        t1 = t + B @ torch.where(ok, dxi[3:], torch.zeros(2, dtype=dtype, device=dev))
        t = t1 / torch.clamp(se3.norm(t1), min=1e-12)
        c0 = torch.where(ok, c1, c0)
    return se3.orthonormalize(R), t


cross = se3.cross
