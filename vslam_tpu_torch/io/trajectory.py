"""TUM-format trajectory export.

Port of `vslam_tpu/io/trajectory.py`: positions-only and full quaternion
TUM trajectories (`timestamp tx ty tz qx qy qz qw`), and a reader for
either. Quaternions come from `ops.se3.quat_from_matrix` (Shepperd's
method, f32), so the files have the JAX package's bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from vslam_tpu_torch.ops import se3


def _as_numpy(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def save_trajectory(path, timestamps, positions):
    """Positions-only TUM file: full 8-column lines with the identity
    quaternion, so standard TUM tools accept it."""
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for ts, p in zip(_as_numpy(timestamps), _as_numpy(positions)):
            f.write(f"{ts:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} 0 0 0 1\n")


def save_trajectory_full(path, timestamps, rotations, positions):
    """Full TUM file with quaternions of the camera-to-world rotations."""
    R = torch.as_tensor(np.asarray(_as_numpy(rotations), dtype=np.float32))
    q = se3.quat_from_matrix(R).numpy()
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for ts, p, qi in zip(_as_numpy(timestamps), _as_numpy(positions), q):
            f.write(
                f"{ts:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                f"{qi[0]:.6f} {qi[1]:.6f} {qi[2]:.6f} {qi[3]:.6f}\n"
            )


def load_trajectory(path):
    """Read back either format -> (timestamps, positions, quats or None)."""
    ts, pos, quat = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            ts.append(float(p[0]))
            pos.append([float(x) for x in p[1:4]])
            if len(p) >= 8:
                quat.append([float(x) for x in p[4:8]])
    return np.asarray(ts), np.asarray(pos), (np.asarray(quat) if quat else None)
