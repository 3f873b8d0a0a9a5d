"""Trajectory evaluation: ATE after Umeyama alignment, and RPE.

Port of `vslam_tpu/eval/ate.py`: timestamp association (50 ms window,
numpy), sim(3)/SE(3) alignment with the port's Kabsch, RMSE; the
relative pose (translation drift) error per step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vslam_tpu_torch.ops import kabsch as kb


class ATEResult(NamedTuple):
    rmse: float
    mean: float
    median: float
    max: float
    num_pairs: int
    scale: float


class RPEResult(NamedTuple):
    rmse: float
    mean: float
    max: float
    num_pairs: int


def associate(ts_est, ts_gt, max_dt=0.05):
    """Nearest-in-time association (<= max_dt). Returns (idx_est, idx_gt)."""
    ts_est = np.asarray(ts_est)
    ts_gt = np.asarray(ts_gt)
    pos = np.clip(np.searchsorted(ts_gt, ts_est), 1, len(ts_gt) - 1)
    left = ts_gt[pos - 1]
    right = ts_gt[pos]
    idx_gt = np.where(np.abs(right - ts_est) < np.abs(ts_est - left), pos, pos - 1)
    keep = np.abs(ts_gt[idx_gt] - ts_est) <= max_dt
    return np.nonzero(keep)[0], idx_gt[keep]


def align_umeyama(est_xyz, gt_xyz, with_scale=True):
    """Alignment est -> gt in f32 on the CPU. Returns (R, t, s)."""
    R, t, s = kb.kabsch(
        torch.as_tensor(np.asarray(est_xyz, np.float32)),
        torch.as_tensor(np.asarray(gt_xyz, np.float32)),
        with_scale=with_scale,
    )
    return R.numpy(), t.numpy(), float(s)


def compute_ate(ts_est, est_xyz, ts_gt, gt_xyz, max_dt=0.05, with_scale=True):
    """Absolute trajectory error after Umeyama alignment."""
    ie, ig = associate(ts_est, ts_gt, max_dt)
    if len(ie) < 3:
        inf = float("inf")
        return ATEResult(inf, inf, inf, inf, len(ie), 1.0)
    e = np.asarray(est_xyz)[ie]
    g = np.asarray(gt_xyz)[ig]
    R, t, s = align_umeyama(e, g, with_scale=with_scale)
    err = np.linalg.norm(s * e @ R.T + t - g, axis=-1)
    return ATEResult(
        rmse=float(np.sqrt(np.mean(err**2))), mean=float(np.mean(err)),
        median=float(np.median(err)), max=float(np.max(err)), num_pairs=len(ie), scale=s,
    )


def compute_rpe(ts_est, est_xyz, ts_gt, gt_xyz, max_dt=0.05, delta=1):
    """Relative pose error: the norm of the vector difference between the
    estimated and true displacements over `delta` steps (direction errors
    count, not just length)."""
    ie, ig = associate(ts_est, ts_gt, max_dt)
    if len(ie) < delta + 2:
        inf = float("inf")
        return RPEResult(inf, inf, inf, 0)
    e = np.asarray(est_xyz)[ie]
    g = np.asarray(gt_xyz)[ig]
    err = np.linalg.norm((e[delta:] - e[:-delta]) - (g[delta:] - g[:-delta]), axis=-1)
    return RPEResult(rmse=float(np.sqrt(np.mean(err**2))), mean=float(np.mean(err)),
                     max=float(np.max(err)), num_pairs=len(err))
