"""Perspective-n-Point: batched DLT-RANSAC + Gauss-Newton refinement.

Port of `vslam_tpu/ops/pnp.py`: minimal 6-point DLT solves for every
hypothesis at once (null vector by shift-and-invert), one (B, N)
reprojection score matrix, and a fixed-iteration Huber-IRLS Gauss-Newton
on se(3). Internally solves world->camera (R_cw, t_cw); returns the
camera-to-world pose.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vslam_tpu_torch.ops import camera as cam
from vslam_tpu_torch.ops import device
from vslam_tpu_torch.ops import linalg, se3
from vslam_tpu_torch.ops.ransac import sample_minimal_sets


def dlt_normal_matrix(X, xn):
    """A^T A of the DLT system [X 0 -x X; 0 X -y X] for world points
    (..., N, 3) and normalized observations (..., N, 2): (..., 12, 12)."""
    ones = torch.ones_like(X[..., :1])
    Xh = torch.cat([X, ones], dim=-1)
    zeros = torch.zeros_like(Xh)
    x, y = xn[..., 0:1], xn[..., 1:2]
    r1 = torch.cat([Xh, zeros, -x * Xh], dim=-1)
    r2 = torch.cat([zeros, Xh, -y * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    return torch.einsum("...ni,...nj->...ij", A, A)


def _dlt_pose(X, xn):
    """DLT pose from world points (..., N, 3) + normalized obs (..., N, 2):
    (R_cw, t_cw) with orthonormalized R and cheirality-corrected sign. On
    the minimal 6-point sets it rounds as the JAX package's jitted CPU
    code (`linalg.smallest_eigvec_psd`, `linalg.svd3x3`)."""
    p = linalg.smallest_eigvec_psd(dlt_normal_matrix(X, xn))
    P = p.reshape(*p.shape[:-1], 3, 4)
    R_raw = P[..., :3]
    t_raw = P[..., 3]
    _, sv, _ = linalg.svd3x3(R_raw)
    # The mean of the singular values as XLA's CPU code forms it: the sum
    # in the order (0 + 2) + 1, times the f32 reciprocal of 3.
    scale = ((sv[..., 0] + sv[..., 2]) + sv[..., 1]) * device.reciprocal(3.0, sv.dtype, sv.device)
    scale = torch.where(scale < 1e-12, 1e-12, scale)
    Rs = R_raw / scale[..., None, None]
    # Both signs' rotations in one batched solve.
    R, Rn = se3.orthonormalize(torch.stack([Rs, -Rs])).unbind(0)
    t = t_raw / scale[..., None]
    z = se3.transform_points(R, t, X)[..., 2]
    flip = torch.mean(torch.sign(z), dim=-1) < 0
    R = torch.where(flip[..., None, None], Rn, R)
    t = torch.where(flip[..., None], -t, t)
    return R, t


def gn_refine_pose(R_cw, t_cw, X, uv, weights, fx, fy, cx, cy, iters=10,
                   huber_px=5.0, damping=1e-3):
    """Huber-IRLS Gauss-Newton pose refinement on se(3), analytic
    Jacobians, fixed iteration count."""
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    R, t = R_cw, t_cw
    for _ in range(iters):
        p = (
            X[..., 0:1] * R[:, 0][None]
            + X[..., 1:2] * R[:, 1][None]
            + X[..., 2:3] * R[:, 2][None]
            + t
        )
        z = torch.clamp(p[..., 2], min=1e-6)
        u = fx * p[..., 0] / z + cx
        v = fy * p[..., 1] / z + cy
        r = torch.stack([u - uv[..., 0], v - uv[..., 1]], dim=-1)
        rn = se3.norm(r)
        w_h = torch.where(rn <= huber_px, 1.0, huber_px / torch.clamp(rn, min=1e-9))
        w = weights * w_h * (p[..., 2] > 1e-6)
        zi = 1.0 / z
        zero = torch.zeros_like(zi)
        J_proj = torch.stack(
            [
                torch.stack([fx * zi, zero, -fx * p[..., 0] * zi * zi], -1),
                torch.stack([zero, fy * zi, -fy * p[..., 1] * zi * zi], -1),
            ],
            dim=-2,
        )
        J_rot = se3.cross(p[..., None, :], J_proj)
        J = torch.cat([J_rot, J_proj], dim=-1)
        JW = (J * w[..., None, None]).reshape(-1, 6)
        Jf = J.reshape(-1, 6)
        H = JW.T @ Jf + damping * eye6
        g = JW.T @ r.reshape(-1)
        delta = -linalg.cholesky_solve_small(H, g)
        dR = se3.exp_so3(delta[:3])
        R = dR @ R
        t = (dR @ t[..., None])[..., 0] + delta[3:]
    return se3.orthonormalize(R), t


class PnPResult(NamedTuple):
    R: torch.Tensor  # (3, 3) camera-to-world
    t: torch.Tensor  # (3,)
    inlier_mask: torch.Tensor  # (N,)
    num_inliers: torch.Tensor  # ()
    ok: torch.Tensor  # ()


def ransac_pnp(key, X, uv, valid, fx, fy, cx, cy, num_hypotheses=256,
               threshold_px=8.0, min_inliers=10, gn_iters=10, huber_px=5.0):
    """solvePnPRansac equivalent; returns PnPResult (camera-to-world)."""
    xn = cam.normalize_pixels(uv, fx, fy, cx, cy)
    idx = sample_minimal_sets(key, valid, num_hypotheses, 6)
    R_h, t_h = _dlt_pose(X[idx], xn[idx])
    p = se3.transform_points(R_h, t_h, X[None])
    uv_hat, front = cam.project(p, fx, fy, cx, cy)
    err = se3.norm(uv_hat - uv[None])
    inl = (err < threshold_px) & front & valid[None, :]
    best = torch.argmax(torch.sum(inl, dim=-1))
    w = device.take(inl, best).to(X.dtype)
    R_cw, t_cw = gn_refine_pose(device.take(R_h, best), device.take(t_h, best), X, uv, w,
                                fx, fy, cx, cy, iters=gn_iters, huber_px=huber_px)
    p_f = se3.transform_points(R_cw, t_cw, X)
    uv_f, front_f = cam.project(p_f, fx, fy, cx, cy)
    final_inl = (se3.norm(uv_f - uv) < threshold_px) & front_f & valid
    n_inl = torch.sum(final_inl)
    R_wc, t_wc = se3.inverse(R_cw, t_cw)
    return PnPResult(R_wc, t_wc, final_inl, n_inl, n_inl >= min_inliers)
