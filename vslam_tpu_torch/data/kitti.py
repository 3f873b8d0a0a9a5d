"""KITTI odometry dataset support (the BASELINE.json stretch config).

The port's own copy of `vslam_tpu/data/kitti.py`.

Layout: `sequences/NN/image_0/XXXXXX.png` (grayscale), `times.txt`,
`calib.txt` (P0..P3 projection rows), and optional `poses/NN.txt`
(3x4 row-major ground-truth poses, cam0 frame). Monocular-only — depth
comes from MiDaS or stays empty (Essential-matrix + scale-chain mode).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class KittiSequence:
    root: str  # .../sequences/NN
    image_paths: List[str]
    timestamps: np.ndarray  # (N,)
    fx: float
    fy: float
    cx: float
    cy: float
    gt_R: Optional[np.ndarray] = None  # (M, 3, 3) cam-to-world
    gt_t: Optional[np.ndarray] = None  # (M, 3)

    def __len__(self):
        return len(self.image_paths)


def load_sequence(seq_dir: str, poses_file: Optional[str] = None, camera: int = 0) -> KittiSequence:
    img_dir = os.path.join(seq_dir, f"image_{camera}")
    names = sorted(n for n in os.listdir(img_dir) if n.endswith(".png"))
    paths = [os.path.join(img_dir, n) for n in names]

    times_path = os.path.join(seq_dir, "times.txt")
    if os.path.exists(times_path):
        ts = np.loadtxt(times_path, dtype=np.float64).reshape(-1)
    else:
        ts = np.arange(len(paths)) * 0.1

    fx = fy = cx = cy = None
    calib_path = os.path.join(seq_dir, "calib.txt")
    if os.path.exists(calib_path):
        with open(calib_path) as f:
            for line in f:
                if line.startswith(f"P{camera}:"):
                    vals = [float(x) for x in line.split()[1:]]
                    P = np.asarray(vals).reshape(3, 4)
                    fx, fy, cx, cy = P[0, 0], P[1, 1], P[0, 2], P[1, 2]
    if fx is None:
        fx = fy = 718.856  # KITTI default
        cx, cy = 607.1928, 185.2157

    gt_R = gt_t = None
    if poses_file is None:
        # conventional location: ../../poses/NN.txt
        seq_name = os.path.basename(seq_dir.rstrip("/"))
        cand = os.path.join(seq_dir, "..", "..", "poses", f"{seq_name}.txt")
        if os.path.exists(cand):
            poses_file = cand
    if poses_file and os.path.exists(poses_file):
        raw = np.loadtxt(poses_file, dtype=np.float64).reshape(-1, 3, 4)
        gt_R = raw[:, :, :3].astype(np.float32)
        gt_t = raw[:, :, 3].astype(np.float32)

    return KittiSequence(
        root=seq_dir, image_paths=paths, timestamps=ts[: len(paths)],
        fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
        gt_R=gt_R, gt_t=gt_t,
    )


def load_gray(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img
