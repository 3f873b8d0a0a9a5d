"""Plain numpy reference of trajectory error against ground truth.

The estimated positions are aligned to the true ones by the least-squares
rigid transform (Umeyama 1991; with a scale for monocular runs, whose
trajectory is defined up to scale), in float64; the absolute trajectory
error (ATE) is the root mean square of the aligned position errors.
"""

from __future__ import annotations

import numpy as np


def align(est, gt, with_scale: bool):
    """(R, t, s) minimising |s R est + t - gt|^2."""
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    me, mg = est.mean(0), gt.mean(0)
    e, g = est - me, gt - mg
    U, S, Vt = np.linalg.svd(g.T @ e / len(est))
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    var = (e * e).sum(1).mean()
    # An estimate with no spread is scaled to a point (its best fit).
    s = (float(np.trace(np.diag(S) @ D) / var) if var > 0 else 0.0) if with_scale else 1.0
    return R, mg - s * R @ me, s


def aligned_errors(est, gt, with_scale: bool):
    """Per-frame position error (m) after alignment."""
    R, t, s = align(est, gt, with_scale)
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    return np.linalg.norm(s * est @ R.T + t - gt, axis=-1)


def ate_rmse(errors) -> float:
    e = np.asarray(errors, np.float64)
    return float(np.sqrt(np.mean(e * e)))
