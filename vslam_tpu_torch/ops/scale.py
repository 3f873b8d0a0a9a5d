"""Monocular scale from matched depths (two-view variant).

Port of `vslam_tpu/ops/scale.py`: per-match s_i = (P2 - R P1) . t_hat,
IQR outlier rejection, median.
"""

from __future__ import annotations

import torch

from vslam_tpu_torch.ops import device, se3


def _masked_quantile(x, valid, q):
    n = torch.sum(valid)
    xs = torch.sort(torch.where(valid, x, torch.inf)).values
    idx = torch.clamp((q * torch.clamp(n - 1, min=0)).to(torch.int32), 0, x.shape[0] - 1)
    return device.take(xs, idx), n


def two_view_scale(R_rel, t_rel, p1, p2, valid, min_matches=5):
    """Scale of the unit translation from matched metric depths.
    Returns (scale, ok); scale = -1 when not ok."""
    t_hat = t_rel / torch.clamp(se3.norm(t_rel), min=1e-9)
    s_i = torch.sum((p2 - se3.rotate_rows(R_rel, p1)) * t_hat, dim=-1)
    ok_i = valid & torch.isfinite(s_i)
    q1, _ = _masked_quantile(s_i, ok_i, 0.25)
    q3, _ = _masked_quantile(s_i, ok_i, 0.75)
    iqr = q3 - q1
    inband = ok_i & (s_i >= q1 - 1.5 * iqr) & (s_i <= q3 + 1.5 * iqr)
    med, n = _masked_quantile(s_i, inband, 0.5)
    ok = (n >= min_matches) & (med > 0) & torch.isfinite(med)
    return torch.where(ok, med, -1.0), ok
