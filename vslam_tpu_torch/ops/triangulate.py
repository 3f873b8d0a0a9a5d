"""Batched DLT two-view triangulation + validity gating.

Port of `vslam_tpu/ops/triangulate.py`: cheirality in both views, depth
range, reprojection error in both views, camera-distance cap.
"""

from __future__ import annotations

import torch

from vslam_tpu_torch.ops import camera as cam
from vslam_tpu_torch.ops import device, linalg, se3


def projection_matrix(R_cw, t_cw, fx, fy, cx, cy):
    """3x4 projection P = K [R_cw | t_cw] (world -> pixels)."""
    K = device.constant(((fx, 0.0, cx), (0.0, fy, cy), (0.0, 0.0, 1.0)),
                        R_cw.dtype, R_cw.device)
    return K @ torch.cat([R_cw, t_cw[..., None]], dim=-1)


def triangulate_dlt(P1, P2, uv1, uv2):
    """Linear DLT triangulation of (..., 2) pixel pairs -> (..., 3)."""
    rows = []
    for P, uv in ((P1, uv1), (P2, uv2)):
        u, v = uv[..., 0], uv[..., 1]
        rows.append(u[..., None] * P[2] - P[0])
        rows.append(v[..., None] * P[2] - P[1])
    A = torch.stack(rows, dim=-2)
    Xh = linalg.svd4x4_nullvec(A)
    w = Xh[..., 3]
    w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return Xh[..., :3] / w[..., None]


def triangulate_two_view(
    R1, t1, R2, t2, uv1, uv2, fx, fy, cx, cy,
    min_depth=0.05, max_depth=50.0, max_reproj_px=3.0, max_cam_dist=5.0,
):
    """Triangulate + the reference's validity gates. Poses camera-to-world.
    Returns (pts_world (N, 3), valid (N,))."""
    R1_cw = R1.transpose(-1, -2)
    t1_cw = -(R1_cw @ t1[..., None])[..., 0]
    R2_cw = R2.transpose(-1, -2)
    t2_cw = -(R2_cw @ t2[..., None])[..., 0]
    P1 = projection_matrix(R1_cw, t1_cw, fx, fy, cx, cy)
    P2 = projection_matrix(R2_cw, t2_cw, fx, fy, cx, cy)
    X = triangulate_dlt(P1, P2, uv1, uv2)
    Xc1 = se3.transform_points(R1_cw, t1_cw, X)
    Xc2 = se3.transform_points(R2_cw, t2_cw, X)
    z1, z2 = Xc1[..., 2], Xc2[..., 2]
    uv1_hat, v1ok = cam.project(Xc1, fx, fy, cx, cy)
    uv2_hat, v2ok = cam.project(Xc2, fx, fy, cx, cy)
    e1 = se3.norm(uv1_hat - uv1)
    e2 = se3.norm(uv2_hat - uv2)
    dist1 = se3.norm(X - t1)
    valid = (
        (z1 > min_depth) & (z2 > min_depth) & (z1 < max_depth) & (z2 < max_depth)
        & v1ok & v2ok & (e1 <= max_reproj_px) & (e2 <= max_reproj_px)
        & (dist1 <= max_cam_dist)
    )
    return X, valid
