"""Plain numpy reference of dense voxel fusion: the cloud a sequence's
depth frames leave at given poses.

Every `pixel_step`-th pixel of each depth frame with depth in
(depth_min, max_depth] is back-projected through the pinhole camera and
the camera-to-world pose, in float32, one rounding per operation:
x = (u - cx) * (1/fx) * z, y likewise, then each world coordinate as
((x R_i0 + y R_i1) + z R_i2) + t_i, with 1/fx, 1/fy, 1/depth_scale and
1/voxel formed in float32. Each point falls in the voxel floor(p / voxel)
and in the hash slot |73856093 x ^ 19349663 y ^ 83492791 z| mod slots
(int32 arithmetic, wrapping). Candidates are offered frame by frame, in
pixel order; the first candidate to reach a slot is kept, every later
one that reaches it is dropped, and the kept points form the cloud in the
order they were kept, up to its capacity.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32


def _recip(c):
    return F32(1.0) / F32(c)


def backproject(depth_u16, R, t, cam: dict, dense: dict):
    """(N, H, W) integer depth, poses R (N, 3, 3), t (N, 3) -> points
    (N * n, 3) f32 and valid (N * n,)."""
    N, H, W = depth_u16.shape
    step = int(dense["pixel_step"])
    vs = np.arange(0, H - H % step, step)
    us = np.arange(0, W - W % step, step)
    z = depth_u16[:, vs[:, None], us[None, :]].astype(F32) * _recip(cam["depth_scale"])
    valid = (z > F32(cam["depth_min"])) & (z <= F32(dense["max_depth"]))
    x = ((us.astype(F32)[None, :] - F32(cam["cx"])) * _recip(cam["fx"]))[None] * z
    y = ((vs.astype(F32)[:, None] - F32(cam["cy"])) * _recip(cam["fy"]))[None] * z
    x, y, z = (a.reshape(N, -1) for a in (x, y, z))
    R = np.asarray(R, F32)
    t = np.asarray(t, F32)
    pts = np.stack([x * R[:, i, 0, None] + y * R[:, i, 1, None] + z * R[:, i, 2, None]
                    + t[:, i, None] for i in range(3)], -1)
    return pts.reshape(-1, 3), valid.reshape(-1)


def slots(pts, voxel, capacity):
    c = np.floor(pts * _recip(voxel)).astype(np.int32)
    with np.errstate(over="ignore"):
        h = (c[:, 0] * np.int32(73856093)) ^ (c[:, 1] * np.int32(19349663)) ^ (
            c[:, 2] * np.int32(83492791))
        h = np.abs(h)
    return np.remainder(h, np.int32(capacity))


def fused_cloud(depth_u16, R, t, cam: dict, dense: dict):
    """The cloud (n, 3) f32 the frames leave in an empty map."""
    pts, valid = backproject(depth_u16, R, t, cam, dense)
    pts = pts[valid]
    s = slots(pts, dense["voxel_size"], int(dense["hash_capacity"]))
    _, first = np.unique(s, return_index=True)
    return pts[np.sort(first)][: int(dense["cloud_capacity"])]


def cloud_diff(program_xyz, reference_xyz) -> int:
    """Rows that differ (to the last bit) plus the difference in count."""
    a, b = np.asarray(program_xyz, F32), np.asarray(reference_xyz, F32)
    n = min(len(a), len(b))
    return int(np.any(a[:n] != b[:n], axis=1).sum()) + abs(len(a) - len(b))
