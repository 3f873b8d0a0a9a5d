"""Weighted Kabsch / Umeyama rigid (+ similarity) alignment, batch-first.

Port of `vslam_tpu/ops/kabsch.py`.
"""

from __future__ import annotations

import torch

from vslam_tpu_torch.ops import linalg, se3


def kabsch(src, dst, weights=None, with_scale=False, eps=1e-9):
    """Solve R, t (and optionally s) minimizing
    sum_i w_i ||dst_i - (s R src_i + t)||^2 over (..., N, 3) point sets.
    Returns (R, t, s) with det R = +1 (s == 1 when with_scale=False)."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=eps)
    mu_src = torch.sum(src * w[..., None], dim=-2)
    mu_dst = torch.sum(dst * w[..., None], dim=-2)
    sc = src - mu_src[..., None, :]
    dc = dst - mu_dst[..., None, :]
    H = torch.einsum("...ni,...nj->...ij", dc * w[..., None], sc)
    U, S, Vt = linalg.svd3x3(H)
    det = linalg.det3(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = (U * D[..., None, :]) @ Vt
    if with_scale:
        var_src = torch.sum(torch.sum(sc * sc, dim=-1) * w, dim=-1)
        s = torch.sum(S * D, dim=-1) / torch.clamp(var_src, min=eps)
    else:
        s = torch.ones(src.shape[:-2], dtype=src.dtype, device=src.device)
    t = mu_dst - s[..., None] * (R @ mu_src[..., None])[..., 0]
    return R, t, s


def rigid_residuals(R, t, src, dst):
    """Per-point alignment error norms (..., N)."""
    pred = se3.rotate_rows(R, src) + t[..., None, :]
    return se3.norm(dst - pred)
