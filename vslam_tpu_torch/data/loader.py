"""Frame feed for the apps: a prefetching sequence reader and the cv2 reader.

Port of `vslam_tpu/data/loader.py`: `NativeSequenceLoader`,
`PythonSequenceLoader` and `open_sequence`, with the same `get` /
`prefetch` / `frames` / `timestamps` / `len` / `close` interface.

The JAX package's native loader is a C++ library
(`vslam_tpu/native/dataloader.cpp`): TUM parsing, libpng decoding and a
prefetch ring of decode threads. The port never loads that library, and
the H100 machine has no libpng headers to build one of its own, so the
port's `NativeSequenceLoader` keeps the library's design in Python:

  * the frame list follows the library's rules, not the cv2 reader's:
    `associations.txt` in either column order (the pair whose path holds
    `rgb` is the colour image), else each `rgb.txt` entry takes the
    nearest `depth.txt` entry within 20 ms, a later tie winning (with
    neither file, where the library finds no frame, `data.tum`'s scan of
    `rgb/`);
  * decoding is cv2's (`cv2.imread` releases the interpreter lock, so
    the worker threads decode in parallel), normalised to what the
    library's libpng calls give: 8-bit RGB from gray, gray+alpha, RGBA,
    palette and 16-bit colour images (alpha dropped, 16 bits cut to the
    high byte); depth from gray PNGs only, 8-bit gray widened to 16 bits,
    anything else read as no depth;
  * the ring holds one result per queued index. `get` waits up to 10 s
    for a queued frame, then decodes at once (a frame never queued is
    decoded at once, without the library's wait), and frees the frame
    once it is fetched.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from vslam_tpu_torch.data import tum

FETCH_WAIT_S = 10.0
DEPTH_MATCH_S = 0.02


def _skip(line: str) -> bool:
    """The library's `starts_with_hash`: blank lines and comments."""
    s = line.strip()
    return not s or s.startswith("#")


def _list_file(path: str) -> List[Tuple[float, str]]:
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            if _skip(line):
                continue
            tok = line.split()
            if len(tok) >= 2:
                out.append((float(tok[0]), tok[1]))
    return out


def sequence_entries(root: str) -> List[Tuple[float, str, Optional[str]]]:
    """(timestamp, rgb path, depth path or None) per frame, by the native
    library's rules (`dataloader.cpp:load_sequence_entries`). A directory
    with neither `associations.txt` nor `rgb.txt`, where the library finds
    no frame, gets `data.tum`'s scan of `rgb/`."""
    assoc = os.path.join(root, "associations.txt")
    frames = []
    if os.path.exists(assoc):
        with open(assoc) as f:
            for line in f:
                if _skip(line):
                    continue
                tok = line.split()
                if len(tok) < 4:
                    continue
                t1, p1, t2, p2 = float(tok[0]), tok[1], float(tok[2]), tok[3]
                if "rgb" in p1:
                    frames.append((t1, f"{root}/{p1}", f"{root}/{p2}"))
                else:
                    frames.append((t2, f"{root}/{p2}", f"{root}/{p1}"))
        return frames
    if not os.path.exists(os.path.join(root, "rgb.txt")):
        return [(f.timestamp, f.rgb_path, f.depth_path) for f in tum.load_sequence(root).frames]
    depth = _list_file(os.path.join(root, "depth.txt"))
    for ts, name in _list_file(os.path.join(root, "rgb.txt")):
        best, dpath = DEPTH_MATCH_S, None
        for dts, dname in depth:
            d = abs(dts - ts)
            if d <= best:
                best, dpath = d, f"{root}/{dname}"
        frames.append((ts, f"{root}/{name}", dpath))
    return frames


def decode_rgb(path: str) -> Optional[np.ndarray]:
    """uint8 (H, W, 3) RGB as the library's libpng settings give it, or
    None when the file does not decode."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        return None
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    elif img.shape[2] == 2:  # gray + alpha
        img = np.repeat(img[..., :1], 3, axis=-1)
    else:  # BGR or BGRA
        img = img[..., 2::-1]
    return np.ascontiguousarray(img)


def decode_depth(path: Optional[str]) -> Optional[np.ndarray]:
    """uint16 (H, W) raw depth from a gray PNG (8-bit widened), or None
    (no path, no decode, or not a gray image)."""
    import cv2

    if path is None:
        return None
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None or img.ndim != 2:
        return None
    return img.astype(np.uint16)


class NativeSequenceLoader:
    """Prefetching TUM sequence reader: a ring of decode threads (see the
    module docstring for how it mirrors the JAX package's C++ loader)."""

    def __init__(self, root: str, width=640, height=480, depth_scale=5000.0,
                 workers: int = 2):
        self.entries = sequence_entries(root)
        self.width = width
        self.height = height
        self.depth_scale = depth_scale
        self.workers = workers
        self._cv = threading.Condition()
        self._todo = collections.deque()
        self._queued = set()
        self._done = {}
        self._threads: List[threading.Thread] = []
        self._stop = False

    def __len__(self):
        return len(self.entries)

    def timestamps(self):
        return np.array([e[0] for e in self.entries])

    def _decode(self, idx):
        _, rgb_path, depth_path = self.entries[idx]
        return decode_rgb(rgb_path), decode_depth(depth_path)

    def _work(self):
        while True:
            with self._cv:
                while not self._todo and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                idx = self._todo.popleft()
            res = self._decode(idx)
            with self._cv:
                self._done[idx] = res
                self._cv.notify_all()

    def prefetch(self, start=0, step=1, count=None):
        """Queue frames start, start + step, ... (count of them, default to
        the end) for the decode threads, starting `workers` of them."""
        if count is None:
            count = (len(self) - start + step - 1) // step
        with self._cv:
            for i in range(count):
                idx = start + i * step
                if idx < len(self):
                    self._todo.append(idx)
                    self._queued.add(idx)
            self._cv.notify_all()
        for _ in range(len(self._threads), max(1, self.workers)):
            t = threading.Thread(target=self._work, daemon=True)
            t.start()
            self._threads.append(t)

    def _fetch(self, idx):
        with self._cv:
            if idx in self._queued:
                self._cv.wait_for(lambda: idx in self._done, timeout=FETCH_WAIT_S)
                self._queued.discard(idx)
                if idx in self._done:
                    return self._done.pop(idx)
        return self._decode(idx)

    def get(self, idx) -> Tuple[np.ndarray, np.ndarray, float]:
        """Returns (rgb uint8 (H, W, 3), depth float32 meters (H, W), ts);
        a frame without depth gets all-zero depth."""
        if not 0 <= idx < len(self):
            raise IOError(f"frame {idx} failed to decode")
        rgb, depth_raw = self._fetch(idx)
        if rgb is None:
            raise IOError(f"frame {idx} failed to decode")
        h, w = rgb.shape[:2]
        if (h, w) != (self.height, self.width):
            raise ValueError(f"frame {idx} is {w}x{h}, expected {self.width}x{self.height}")
        if depth_raw is None or depth_raw.shape != (h, w):
            depth_raw = np.zeros((h, w), np.uint16)
        return rgb, depth_raw.astype(np.float32) / self.depth_scale, self.entries[idx][0]

    def frames(self, step=1) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        self.prefetch(0, step)
        for i in range(0, len(self), step):
            yield self.get(i)

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join()
        self._threads = []

    def __del__(self):
        self.close()


class PythonSequenceLoader:
    """cv2-based TUM sequence reader (the `data.tum` frame list)."""

    def __init__(self, root: str, width=640, height=480, depth_scale=5000.0, workers=0):
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


def open_sequence(root: str, prefer_native=True, **kw):
    """The prefetching reader, or with `prefer_native=False` the cv2
    reader."""
    if prefer_native:
        return NativeSequenceLoader(root, **kw)
    return PythonSequenceLoader(root, **kw)
