"""Weighted Kabsch / Umeyama rigid (+ similarity) alignment, batch-first.

Port of `vslam_tpu/ops/kabsch.py`. On a short point axis (the RANSAC's
minimal sets) the solve rounds as XLA's jitted CPU code does: the
weighted means and H summed in order with each product fused
(`linalg.matmul3`), the SVD as `linalg.svd3x3`. A long axis (the
all-inlier refits) is summed by `torch.sum`.
"""

from __future__ import annotations

import torch

from vslam_tpu_torch.ops import linalg, se3

# Point sets up to this size are summed as XLA sums them (one launch per
# point); longer ones by `torch.sum`.
SHORT_AXIS = 16


def moments(src, dst, w):
    """The weighted means of src and dst (..., N, 3) for normalised weights
    w (..., N), src centred, and the cross-covariance H = sum_i w_i dc_i
    sc_i^T: (mu_src, mu_dst, sc, H)."""
    if src.shape[-2] <= SHORT_AXIS:
        # src and dst side by side as six lanes.
        sd = torch.cat(torch.broadcast_tensors(src, dst), dim=-1)
        mu = linalg.matmul3(w[..., None, :], sd)[..., 0, :]
        cen = sd - mu[..., None, :]
        sc, dc = cen[..., :3], cen[..., 3:]
        return (mu[..., :3], mu[..., 3:], sc,
                linalg.matmul3((dc * w[..., None]).transpose(-1, -2), sc))
    mu_src = torch.sum(src * w[..., None], dim=-2)
    mu_dst = torch.sum(dst * w[..., None], dim=-2)
    sc = src - mu_src[..., None, :]
    dc = dst - mu_dst[..., None, :]
    return mu_src, mu_dst, sc, torch.einsum("...ni,...nj->...ij", dc * w[..., None], sc)


def kabsch(src, dst, weights=None, with_scale=False, eps=1e-9):
    """Solve R, t (and optionally s) minimizing
    sum_i w_i ||dst_i - (s R src_i + t)||^2 over (..., N, 3) point sets.
    Returns (R, t, s) with det R = +1 (s == 1 when with_scale=False)."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=eps)
    mu_src, mu_dst, sc, H = moments(src, dst, w)
    U, S, Vt = linalg.svd3x3(H)
    det = linalg.det3(linalg.matmul3(U, Vt))
    R = linalg.matmul3(linalg._scale_last_column(U, det), Vt)
    Rmu = linalg.matmul3(R, mu_src[..., None])[..., 0]
    if with_scale:
        D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
        var_src = torch.sum(torch.sum(sc * sc, dim=-1) * w, dim=-1)
        s = torch.sum(S * D, dim=-1) / torch.clamp(var_src, min=eps)
        t = mu_dst - s[..., None] * Rmu
    else:
        s = torch.ones(src.shape[:-2], dtype=src.dtype, device=src.device)
        t = mu_dst - Rmu
    return R, t, s


def rigid_residuals(R, t, src, dst):
    """Per-point alignment error norms (..., N)."""
    pred = se3.rotate_rows(R, src) + t[..., None, :]
    return se3.norm(dst - pred)
