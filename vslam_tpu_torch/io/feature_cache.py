"""Deterministic feature-replay cache, SPCF-binary compatible.

The port's own copy of `vslam_tpu/io/feature_cache.py`: the same bytes
for the same arrays. The reference persists extracted SuperPoint
features keyed by a sequential frame counter, "for deterministic GPU
results" (`src/FeatureExtractor.cpp:262-381`,
`include/FeatureExtractor.h:26`): magic `SPCF` (0x53504346) | version 1 |
N entries of [frame_idx, num_kp, kp records (x, y, size, angle, response,
octave, class_id), desc_rows, desc_cols, desc_type(cv enum), raw data].

This module reads/writes that exact byte layout (so caches interoperate
with the reference binary) and converts to/from the framework's fixed-
capacity padded arrays. A fast `.npz` variant is also provided for bulk
on-device replay.
"""

from __future__ import annotations

import struct
from typing import Dict, NamedTuple

import numpy as np

MAGIC = 0x53504346
VERSION = 1
CV_32F = 5  # cv::Mat type enum for float32 descriptors


class CachedFeatures(NamedTuple):
    xy: np.ndarray  # (n, 2)
    score: np.ndarray  # (n,)
    desc: np.ndarray  # (n, D) float32


def save_spcf(path: str, cache: Dict[int, CachedFeatures]):
    """Write the reference-compatible binary layout."""
    with open(path, "wb") as f:
        f.write(struct.pack("<III", MAGIC, VERSION, len(cache)))
        for idx in sorted(cache):
            cf = cache[idx]
            n = len(cf.xy)
            f.write(struct.pack("<ii", idx, n))
            for k in range(n):
                f.write(
                    struct.pack(
                        "<fffffii",
                        float(cf.xy[k, 0]),
                        float(cf.xy[k, 1]),
                        8.0,  # size (reference stores kp.size; SP uses 8)
                        -1.0,  # angle
                        float(cf.score[k]),
                        0,  # octave
                        -1,  # class_id
                    )
                )
            d = np.ascontiguousarray(cf.desc, dtype=np.float32)
            f.write(struct.pack("<iii", d.shape[0], d.shape[1] if d.size else 0, CV_32F))
            if d.size:
                f.write(d.tobytes())


def load_spcf(path: str) -> Dict[int, CachedFeatures]:
    with open(path, "rb") as f:
        data = f.read()
    off = 0

    def rd(fmt):
        nonlocal off
        vals = struct.unpack_from(fmt, data, off)
        off += struct.calcsize(fmt)
        return vals

    magic, version, n_entries = rd("<III")
    if magic != MAGIC or version != VERSION:
        raise ValueError(f"bad SPCF header: magic={magic:#x} version={version}")
    out = {}
    for _ in range(n_entries):
        frame_idx, num_kp = rd("<ii")
        xy = np.zeros((num_kp, 2), np.float32)
        score = np.zeros(num_kp, np.float32)
        for k in range(num_kp):
            x, y, _size, _angle, resp, _oct, _cid = rd("<fffffii")
            xy[k] = (x, y)
            score[k] = resp
        rows, cols, dtype = rd("<iii")
        if rows > 0 and cols > 0:
            if dtype != CV_32F:
                raise ValueError(f"unsupported descriptor cv type {dtype}")
            desc = np.frombuffer(data, dtype="<f4", count=rows * cols, offset=off).reshape(rows, cols).copy()
            off += rows * cols * 4
        else:
            desc = np.zeros((0, 0), np.float32)
        out[frame_idx] = CachedFeatures(xy, score, desc)
    return out


# ---------------------------------------------------------------------------
# Padded-array conversion + fast npz path
# ---------------------------------------------------------------------------


def to_padded(cache: Dict[int, CachedFeatures], max_keypoints: int, desc_dim: int):
    """Dict -> stacked (N, K, ...) arrays with validity masks, ordered by
    frame index (device-replayable in one upload)."""
    idxs = sorted(cache)
    N = len(idxs)
    xy = np.zeros((N, max_keypoints, 2), np.float32)
    score = np.zeros((N, max_keypoints), np.float32)
    desc = np.zeros((N, max_keypoints, desc_dim), np.float32)
    valid = np.zeros((N, max_keypoints), bool)
    for i, fi in enumerate(idxs):
        cf = cache[fi]
        n = min(len(cf.xy), max_keypoints)
        xy[i, :n] = cf.xy[:n]
        score[i, :n] = cf.score[:n]
        if cf.desc.size:
            desc[i, :n] = cf.desc[:n, :desc_dim]
        valid[i, :n] = True
    return xy, score, desc, valid, np.asarray(idxs, np.int32)


def from_padded(xy, score, desc, valid, frame_ids=None) -> Dict[int, CachedFeatures]:
    N = xy.shape[0]
    ids = frame_ids if frame_ids is not None else np.arange(N)
    out = {}
    for i in range(N):
        n = int(valid[i].sum())
        out[int(ids[i])] = CachedFeatures(
            np.asarray(xy[i, :n]), np.asarray(score[i, :n]), np.asarray(desc[i, :n])
        )
    return out


def save_npz(path: str, xy, score, desc, valid, frame_ids=None):
    np.savez_compressed(
        path, xy=xy, score=score, desc=desc, valid=valid,
        frame_ids=frame_ids if frame_ids is not None else np.arange(xy.shape[0]),
    )


def load_npz(path: str):
    z = np.load(path)
    return z["xy"], z["score"], z["desc"], z["valid"], z["frame_ids"]
