"""Batched RANSAC: all minimal sets sampled and solved at once.

Port of `vslam_tpu/ops/ransac.py`. Hypothesis indices come from the
port's bit-exact threefry `randint` (`ops.prng`), so both packages draw
the same minimal sets for the same key. Keys and draws stay on the
host; the drawn integers reach the card by an asynchronous copy.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vslam_tpu_torch.ops import camera as cam
from vslam_tpu_torch.ops import device
from vslam_tpu_torch.ops import epipolar as epi
from vslam_tpu_torch.ops import kabsch as kb
from vslam_tpu_torch.ops import linalg, prng, se3


def sample_minimal_sets(key, valid, num_hypotheses, set_size):
    """(B, set_size) indices of valid entries: valid indices compacted to
    the front (stable argsort), uniform draws modulo the valid count."""
    n = valid.shape[-1]
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    n_valid = torch.clamp(torch.sum(valid), min=1)
    u = device.to_device(prng.randint(key, (num_hypotheses, set_size), 0, n), valid.device)
    return order[u % n_valid]


class RansacResult(NamedTuple):
    inlier_mask: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int
    ok: torch.Tensor  # () bool


def ransac_kabsch_3d3d(
    key, src, dst, valid, num_hypotheses=256, inlier_thresh=0.05,
    max_translation=0.2, min_translation=1e-4, min_inliers=3,
):
    """3D-3D rigid motion RANSAC: dst ~ R src + t; 5 cm inliers, translation
    magnitude gates, all-inlier refit and re-score."""
    idx = sample_minimal_sets(key, valid, num_hypotheses, 3)
    R_h, t_h, _ = kb.kabsch(src[idx], dst[idx])
    res = kb.rigid_residuals(R_h, t_h, src[None], dst[None])
    inl = (res < inlier_thresh) & valid[None, :]
    counts = torch.sum(inl, dim=-1)
    tn = se3.norm(t_h)
    h_ok = (tn <= max_translation) & (tn >= min_translation)
    scores = torch.where(h_ok, counts, -1)
    best = torch.argmax(scores)
    w = device.take(inl, best).to(src.dtype)
    R, t, _ = kb.kabsch(src, dst, weights=w)
    res_f = kb.rigid_residuals(R, t, src, dst)
    final_inl = (res_f < inlier_thresh) & valid
    n_inl = torch.sum(final_inl)
    tn_f = se3.norm(t)
    ok = (
        (n_inl >= min_inliers)
        & (tn_f <= max_translation)
        & (tn_f >= min_translation)
        & (device.take(scores, best) > 0)
    )
    return R, t, RansacResult(final_inl, n_inl, ok)


def ransac_fundamental(key, uv1, uv2, valid, num_hypotheses=256, threshold_px=3.0,
                       min_inliers=8):
    """Fundamental-matrix RANSAC gate; inliers by Sampson distance."""
    idx = sample_minimal_sets(key, valid, num_hypotheses, 8)
    F_h = epi.eight_point(uv1[idx], uv2[idx])
    d = epi.sampson_distance(F_h, uv1[None], uv2[None])
    inl = (d < threshold_px) & valid[None, :]
    best = torch.argmax(torch.sum(inl, dim=-1))
    w = device.take(inl, best).to(uv1.dtype)
    F = epi.eight_point(uv1, uv2, weights=w, nullvec_iters=10)
    final_inl = (epi.sampson_distance(F, uv1, uv2) < threshold_px) & valid
    n_inl = torch.sum(final_inl)
    return F, RansacResult(final_inl, n_inl, n_inl >= min_inliers)


def ransac_essential(key, uv1, uv2, valid, fx, fy, cx, cy, num_hypotheses=256,
                     threshold_px=1.0, min_inliers=15, polish_iters=8):
    """Essential-matrix RANSAC + cheirality + Sampson GN polish.
    Returns (R, t, E, RansacResult) with x2 = R x1 + t, ||t|| = 1."""
    xn1 = cam.normalize_pixels(uv1, fx, fy, cx, cy)
    xn2 = cam.normalize_pixels(uv2, fx, fy, cx, cy)
    idx = sample_minimal_sets(key, valid, num_hypotheses, 8)
    E_h = epi.eight_point(xn1[idx], xn2[idx], essential=True)
    d = epi.sampson_distance(_E_to_pixel_F(E_h, fx, fy, cx, cy), uv1[None], uv2[None])
    inl = (d < threshold_px) & valid[None, :]
    best = torch.argmax(torch.sum(inl, dim=-1))
    w = device.take(inl, best).to(uv1.dtype)
    E = epi.eight_point(xn1, xn2, weights=w, essential=True, nullvec_iters=10)
    d_f = epi.sampson_distance(_E_to_pixel_F(E, fx, fy, cx, cy), uv1, uv2)
    final_inl = (d_f < threshold_px) & valid
    R, t, n_good, good = epi.recover_pose(E, uv1, uv2, fx, fy, cx, cy, mask=final_inl)
    if polish_iters > 0:
        R, t = epi.refine_pose_sampson(
            R, t, xn1, xn2, (final_inl & good).to(uv1.dtype), iters=polish_iters
        )
    det_ok = torch.abs(linalg.det3(R) - 1.0) < 1e-3
    ok = (n_good >= min_inliers) & det_ok
    return R, t, E, RansacResult(final_inl & good, n_good, ok)


def k_inverse(fx, fy, cx, cy, dtype, dev):
    """K^-1 from Python quotients rounded to `dtype`, as the JAX package
    builds it (no division for XLA to rewrite)."""
    return device.constant(
        ((1.0 / fx, 0.0, -cx / fx), (0.0, 1.0 / fy, -cy / fy), (0.0, 0.0, 1.0)), dtype, dev)


def _E_to_pixel_F(E, fx, fy, cx, cy):
    """F (pixel coords) = K^-T E K^-1, normalized."""
    Kinv = k_inverse(fx, fy, cx, cy, E.dtype, E.device)
    F = Kinv.T @ E @ Kinv
    nrm = torch.sqrt(torch.sum(F * F, dim=(-2, -1), keepdim=True))
    return F / torch.clamp(nrm, min=1e-12)
