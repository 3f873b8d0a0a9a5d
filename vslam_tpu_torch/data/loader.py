"""Frame feed for the app: the cv2 sequence reader.

Port of `vslam_tpu/data/loader.py`'s `PythonSequenceLoader` and
`open_sequence`, with the same `get` / `prefetch` / `frames` / `len`
interface. The JAX package's `NativeSequenceLoader` (ctypes over the
library it builds from `vslam_tpu/native/dataloader.cpp`: libpng decode
and a prefetch ring) is not ported: the port never loads the JAX
package's library, and
`open_sequence` always returns the cv2 reader (`ROADMAP.md` queues a
native reader of the port's own).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from vslam_tpu_torch.data import tum


class PythonSequenceLoader:
    """cv2-based TUM sequence reader."""

    def __init__(self, root: str, width=640, height=480, depth_scale=5000.0):
        self.seq = tum.load_sequence(root)
        self.width = width
        self.height = height
        self.depth_scale = depth_scale

    def __len__(self):
        return len(self.seq)

    def timestamps(self):
        return np.array([f.timestamp for f in self.seq.frames])

    def prefetch(self, *a, **k):
        pass

    def get(self, idx) -> Tuple[np.ndarray, np.ndarray, float]:
        """Returns (rgb uint8 (H, W, 3), depth float32 meters (H, W), ts);
        a frame without a depth image gets all-zero depth."""
        e = self.seq.frames[idx]
        rgb = tum.load_rgb(e.rgb_path)
        depth = (
            tum.load_depth(e.depth_path, self.depth_scale)
            if e.depth_path
            else np.zeros(rgb.shape[:2], np.float32)
        )
        return rgb, depth, e.timestamp

    def frames(self, step=1) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        for i in range(0, len(self), step):
            yield self.get(i)

    def close(self):
        pass


def open_sequence(root: str, **kw) -> PythonSequenceLoader:
    return PythonSequenceLoader(root, **kw)
