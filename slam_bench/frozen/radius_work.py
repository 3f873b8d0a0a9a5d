"""The least work of a radius match on given inputs, and its time floor
on one H100: a frozen copy.

Copied from `chip_smoke.py` at commit a3a4213 (`radius_work`, `bound`,
`H100_BF16_FLOPS`, `H100_BYTES_PER_S`). The count depends only on the
operation's inputs, so a roofline share built on it reads the same work
whatever implements the match.
"""

from __future__ import annotations

import numpy as np

H100_BF16_FLOPS = 989e12  # dense tensor-core bf16, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet


def bound_s(nbytes: int, flops: int) -> float:
    """The least seconds one H100 takes for this work: bytes at the HBM
    rate or operations at the bf16 peak, whichever is longer."""
    return max(nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS)


def radius_work(uv_q, valid_q, uv_db, valid_db, D, radius_px):
    """The least work of a radius match on these inputs (numpy arrays,
    leading member dimension optional). The outputs depend only on the
    (row, keypoint) pairs that pass the gates (row valid, keypoint valid,
    squared pixel distance <= radius^2 in f32, each step rounded), so:
      bytes: every row's and keypoint's pixels (8 B) and validity (1 B),
             the descriptors (2 D B) of the rows and keypoints that have
             a candidate pair, every output written once (9 B per
             keypoint, 4 B per row);
      flops: 2 D per candidate pair.
    Returns dict(nbytes, flops, rows_with_candidates,
    keypoints_with_candidates, pairs_in_radius), summed over members."""
    uq, vq, ud, vd = (np.asarray(x) for x in (uv_q, valid_q, uv_db, valid_db))
    if uq.ndim == 2:
        uq, vq, ud, vd = uq[None], vq[None], ud[None], vd[None]
    r2 = np.float32(radius_px) * np.float32(radius_px)
    nbytes = flops = rows = kps = pairs = 0
    for b in range(uq.shape[0]):
        q, d = uq[b].astype(np.float32), ud[b].astype(np.float32)
        K, M = q.shape[0], d.shape[0]
        with np.errstate(invalid="ignore", over="ignore"):
            dx = d[:, None, 0] - q[None, :, 0]
            dy = d[:, None, 1] - q[None, :, 1]
            pd2 = dx * dx + dy * dy
            cand = (pd2 <= r2) & vd[b].astype(bool)[:, None] & vq[b].astype(bool)[None, :]
        n_rows, n_kps = int(cand.any(1).sum()), int(cand.any(0).sum())
        rows, kps, pairs = rows + n_rows, kps + n_kps, pairs + int(cand.sum())
        nbytes += 9 * (M + K) + 2 * D * (n_rows + n_kps) + 9 * K + 4 * M
        flops += 2 * D * int(cand.sum())
    return dict(nbytes=nbytes, flops=flops, rows_with_candidates=rows,
                keypoints_with_candidates=kps, pairs_in_radius=pairs)
