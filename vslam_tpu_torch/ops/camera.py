"""Pinhole camera projection / back-projection (batched, masked).

Port of `vslam_tpu/ops/camera.py`.
"""

from __future__ import annotations

import torch


def project(pts_cam, fx, fy, cx, cy, eps=1e-6):
    """Camera-frame points (..., 3) -> pixels (..., 2) + in-front mask."""
    z = pts_cam[..., 2]
    valid = z > eps
    zs = torch.where(valid, z, 1.0)
    u = fx * pts_cam[..., 0] / zs + cx
    v = fy * pts_cam[..., 1] / zs + cy
    return torch.stack([u, v], dim=-1), valid


def backproject(uv, depth, fx, fy, cx, cy):
    """Pixels (..., 2) + depth (...) -> camera-frame points (..., 3)."""
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def normalize_pixels(uv, fx, fy, cx, cy):
    """Pixels -> normalized image coordinates (x/z, y/z)."""
    return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)


def in_image(uv, width, height, margin=0.0):
    """Mask of pixels inside the image bounds."""
    return (
        (uv[..., 0] >= margin)
        & (uv[..., 0] <= width - 1 - margin)
        & (uv[..., 1] >= margin)
        & (uv[..., 1] <= height - 1 - margin)
    )
