"""Batched RANSAC: all minimal sets sampled and solved at once.

Port of `vslam_tpu/ops/ransac.py`. Hypothesis indices come from the
port's bit-exact threefry `randint` (`ops.prng`), so both packages draw
the same minimal sets for the same key. Keys and draws stay on the
host; the drawn integers reach the card by an asynchronous copy.

The two epipolar RANSACs (`ransac_fundamental`, `ransac_essential`) are
a host draw followed by a pure device function of the draw and the
correspondences, thousands of small kernels whose launches the host pays
one by one. On CUDA inputs that device function is captured once per
key (the function, its static parameters, the input shapes and dtypes,
the device and the TF32 flags) as a CUDA graph and replayed afterwards:
the same kernels on the same inputs, so the same bits, for a few
launches a call (`ops.graphs`, the draw among the graph's inputs; its
`STATS` counts them under `_fundamental` and `_essential`). CPU inputs
run the eager code.

The 3D-3D RANSAC is split the same way (`_kabsch_3d3d`), but its graph
is the tracking step's (`core.tracking._rigid_motion`), which also
gathers the keypoint depths and backprojects them: `ransac_kabsch_3d3d`
itself runs eagerly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vslam_tpu_torch.ops import camera as cam
from vslam_tpu_torch.ops import device
from vslam_tpu_torch.ops import epipolar as epi
from vslam_tpu_torch.ops import graphs
from vslam_tpu_torch.ops import kabsch as kb
from vslam_tpu_torch.ops import linalg, prng, se3

def draw_minimal_sets(key, n, num_hypotheses, set_size):
    """The host half of `sample_minimal_sets`: (num_hypotheses, set_size)
    uniform draws in [0, n), an int64 CPU tensor."""
    return prng.randint(key, (num_hypotheses, set_size), 0, n)


def minimal_sets_from_draw(u, valid):
    """The device half of `sample_minimal_sets`: valid indices compacted to
    the front (stable argsort), the draws `u` modulo the valid count."""
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    n_valid = torch.clamp(torch.sum(valid), min=1)
    return order[u % n_valid]


def sample_minimal_sets(key, valid, num_hypotheses, set_size):
    """(B, set_size) indices of valid entries: valid indices compacted to
    the front (stable argsort), uniform draws modulo the valid count."""
    u = draw_minimal_sets(key, valid.shape[-1], num_hypotheses, set_size)
    return minimal_sets_from_draw(device.to_device(u, valid.device), valid)


class RansacResult(NamedTuple):
    inlier_mask: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int
    ok: torch.Tensor  # () bool


def _kabsch_3d3d(u, src, dst, valid, max_translation, inlier_thresh, min_translation,
                 min_inliers):
    """The 3D-3D RANSAC's device work for the draw `u`: (R, t, inliers,
    count, ok). `max_translation` is a number or a 0-d tensor."""
    idx = minimal_sets_from_draw(u, valid)
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
    return R, t, final_inl, n_inl, ok


def ransac_kabsch_3d3d(
    key, src, dst, valid, num_hypotheses=256, inlier_thresh=0.05,
    max_translation=0.2, min_translation=1e-4, min_inliers=3,
):
    """3D-3D rigid motion RANSAC: dst ~ R src + t; 5 cm inliers, translation
    magnitude gates, all-inlier refit and re-score. Runs eagerly; the
    tracking step replays its device half, `_kabsch_3d3d`, inside
    `core.tracking._rigid_motion`'s graph."""
    u = draw_minimal_sets(key, valid.shape[-1], num_hypotheses, 3)
    R, t, inl, n_inl, ok = _kabsch_3d3d(device.to_device(u, valid.device), src, dst, valid,
                                        max_translation, inlier_thresh, min_translation,
                                        min_inliers)
    return R, t, RansacResult(inl, n_inl, ok)


def _fundamental(u, uv1, uv2, valid, threshold_px, min_inliers):
    """The F-gate's device work for the draw `u`: (F, inliers, count, ok)."""
    idx = minimal_sets_from_draw(u, valid)
    F_h = epi.eight_point(uv1[idx], uv2[idx])
    d = epi.sampson_distance(F_h, uv1[None], uv2[None])
    inl = (d < threshold_px) & valid[None, :]
    best = torch.argmax(torch.sum(inl, dim=-1))
    w = device.take(inl, best).to(uv1.dtype)
    F = epi.eight_point(uv1, uv2, weights=w, nullvec_iters=10)
    final_inl = (epi.sampson_distance(F, uv1, uv2) < threshold_px) & valid
    n_inl = torch.sum(final_inl)
    return F, final_inl, n_inl, n_inl >= min_inliers


def _essential(u, uv1, uv2, valid, fx, fy, cx, cy, threshold_px, min_inliers, polish_iters):
    """The essential RANSAC's device work for the draw `u`:
    (R, t, E, inliers, count, ok)."""
    xn1 = cam.normalize_pixels(uv1, fx, fy, cx, cy)
    xn2 = cam.normalize_pixels(uv2, fx, fy, cx, cy)
    idx = minimal_sets_from_draw(u, valid)
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
    return R, t, E, final_inl & good, n_good, ok


def ransac_fundamental(key, uv1, uv2, valid, num_hypotheses=256, threshold_px=3.0,
                       min_inliers=8):
    """Fundamental-matrix RANSAC gate; inliers by Sampson distance. On
    CUDA inputs a replay of `_fundamental`'s graph."""
    u = draw_minimal_sets(key, valid.shape[-1], num_hypotheses, 8)
    F, inl, n_inl, ok = graphs.call(_fundamental, (threshold_px, min_inliers),
                                    (u, uv1, uv2, valid))
    return F, RansacResult(inl, n_inl, ok)


def ransac_essential(key, uv1, uv2, valid, fx, fy, cx, cy, num_hypotheses=256,
                     threshold_px=1.0, min_inliers=15, polish_iters=8):
    """Essential-matrix RANSAC + cheirality + Sampson GN polish.
    Returns (R, t, E, RansacResult) with x2 = R x1 + t, ||t|| = 1. On CUDA
    inputs a replay of `_essential`'s graph."""
    u = draw_minimal_sets(key, valid.shape[-1], num_hypotheses, 8)
    R, t, E, inl, n_good, ok = graphs.call(
        _essential, (fx, fy, cx, cy, threshold_px, min_inliers, polish_iters),
        (u, uv1, uv2, valid))
    return R, t, E, RansacResult(inl, n_good, ok)


def k_inverse(fx, fy, cx, cy, dtype, dev):
    """K^-1 from Python quotients rounded to `dtype`, as the JAX package
    builds it (no division for XLA to rewrite)."""
    return device.constant(
        ((1.0 / fx, 0.0, -cx / fx), (0.0, 1.0 / fy, -cy / fy), (0.0, 0.0, 1.0)), dtype, dev)


def _E_to_pixel_F(E, fx, fy, cx, cy):
    """F (pixel coords) = K^-T E K^-1, normalized."""
    Kinv = k_inverse(fx, fy, cx, cy, E.dtype, E.device)
    F = Kinv.T @ E @ Kinv
    nrm = device.sqrt(torch.sum(F * F, dim=(-2, -1), keepdim=True))
    return F / torch.clamp(nrm, min=1e-12)
