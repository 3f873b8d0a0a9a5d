"""TUM RGB-D dataset parsing and frame loading.

The port's own copy of `vslam_tpu/data/tum.py` (host-side numpy and cv2,
nothing of the JAX package). It rebuilds the reference's L1 data layer
(`src/main.cpp:42-244`): `associations.txt` pairing, `rgb.txt` /
`depth.txt` timestamp binary-search pairing (<= 20 ms),
`accelerometer.txt`, `groundtruth.txt`, and the directory-scan fallback
with filename-timestamp parsing (`src/main.cpp:177-193`). Depth PNGs are 16-bit, value/5000 -> meters,
zero = invalid (`src/Frame.cpp:47-54`).

Host-side (NumPy + cv2 image decode). The app stacks the decoded frames
into fixed-shape arrays; see `vslam_tpu_torch.data.loader`.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

_TS_RE = re.compile(r"(\d+\.\d+)")


@dataclass
class FrameEntry:
    timestamp: float
    rgb_path: str
    depth_path: Optional[str] = None


@dataclass
class TumSequence:
    root: str
    frames: List[FrameEntry] = field(default_factory=list)
    accel: Optional[np.ndarray] = None  # (N, 4): t, ax, ay, az
    gt: Optional[np.ndarray] = None  # (M, 8): t, tx, ty, tz, qx, qy, qz, qw

    def __len__(self):
        return len(self.frames)


def _parse_list_file(path: str) -> List[Tuple[float, str]]:
    """Parse a TUM-style `timestamp filename` list (rgb.txt / depth.txt)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) >= 2:
                out.append((float(parts[0]), parts[1]))
    return out


def _pair_by_timestamp(rgb, depth, max_dt=0.02):
    """Binary-search nearest-depth pairing (`src/main.cpp:42-85`)."""
    if not depth:
        return [(t, p, None) for t, p in rgb]
    dts = np.array([t for t, _ in depth])
    out = []
    for t, p in rgb:
        i = int(np.clip(np.searchsorted(dts, t), 1, len(dts) - 1))
        j = i if abs(dts[i] - t) < abs(t - dts[i - 1]) else i - 1
        out.append((t, p, depth[j][1] if abs(dts[j] - t) <= max_dt else None))
    return out


def load_sequence(root: str) -> TumSequence:
    """Load a TUM sequence directory.

    Priority (matching `src/main.cpp:143-205`): `associations.txt`, then
    `rgb.txt` + `depth.txt` pairing, then a raw `rgb/` directory scan with
    filename timestamps.
    """
    seq = TumSequence(root=root)
    assoc = os.path.join(root, "associations.txt")
    rgb_txt = os.path.join(root, "rgb.txt")

    if os.path.exists(assoc):
        with open(assoc) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                p = line.split()
                # format: ts_rgb rgb_path ts_depth depth_path (or swapped)
                if len(p) >= 4:
                    if "rgb" in p[1]:
                        seq.frames.append(
                            FrameEntry(float(p[0]), os.path.join(root, p[1]), os.path.join(root, p[3]))
                        )
                    else:
                        seq.frames.append(
                            FrameEntry(float(p[2]), os.path.join(root, p[3]), os.path.join(root, p[1]))
                        )
    elif os.path.exists(rgb_txt):
        rgb = _parse_list_file(rgb_txt)
        depth_txt = os.path.join(root, "depth.txt")
        depth = _parse_list_file(depth_txt) if os.path.exists(depth_txt) else []
        for t, rp, dp in _pair_by_timestamp(rgb, depth):
            seq.frames.append(
                FrameEntry(
                    t,
                    os.path.join(root, rp),
                    os.path.join(root, dp) if dp else None,
                )
            )
    else:
        rgb_dir = os.path.join(root, "rgb")
        if os.path.isdir(rgb_dir):
            for name in sorted(os.listdir(rgb_dir)):
                m = _TS_RE.search(name)
                if m:
                    seq.frames.append(
                        FrameEntry(float(m.group(1)), os.path.join(rgb_dir, name))
                    )

    accel_path = os.path.join(root, "accelerometer.txt")
    if os.path.exists(accel_path):
        rows = []
        with open(accel_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                p = line.split()
                if len(p) >= 4:
                    rows.append([float(x) for x in p[:4]])
        seq.accel = np.asarray(rows, dtype=np.float64) if rows else None

    gt_path = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_path):
        rows = []
        with open(gt_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                p = line.split()
                if len(p) >= 8:
                    rows.append([float(x) for x in p[:8]])
        seq.gt = np.asarray(rows, dtype=np.float64) if rows else None

    return seq


def load_rgb(path: str) -> np.ndarray:
    """Load an RGB image -> (H, W, 3) uint8 (RGB order)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img[..., ::-1].copy()


def load_gray(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img


def load_depth(path: str, depth_scale: float = 5000.0) -> np.ndarray:
    """16-bit depth PNG -> meters (float32); zero stays invalid
    (`src/Frame.cpp:47-54`)."""
    import cv2

    raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if raw is None:
        raise FileNotFoundError(path)
    return raw.astype(np.float32) / depth_scale
