"""Descriptor matching: dense distance matrices and the fused matchers.

Port of `vslam_tpu/ops/matching.py`. Descriptors are compared through
dot products (||a - b||^2 = 2 - 2 a.b for unit vectors); bf16 inputs are
upcast and multiplied in f32, which is what the JAX package computes on
the CPU.

Three matchers have hand-written CUDA kernels (`ops.cuda_matching`):
`radius_descriptor_match_fused` (local-map tracking, every frame),
`radius_descriptor_match_fused_batched` (the same for B sequences at
once, the multi-sequence step) and `knn2_ratio_match_streaming`
(whole-map recovery). On a CUDA tensor they always launch the kernel, at
any map size; on a CPU tensor they run the plain versions below
(`radius_descriptor_match_fused_plain`,
`radius_descriptor_match_fused_batched_plain`, `top2_match_plain`), which
the kernels are held against on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_BIG = 1e9


def l2_distance_matrix(desc1, desc2, valid1=None, valid2=None):
    """(N, D) x (M, D) -> (N, M) L2 distances; invalid rows/cols -> BIG."""
    dots = desc1.float() @ desc2.float().T
    d = torch.sqrt(torch.clamp(2.0 - 2.0 * dots, min=0.0))
    if valid1 is not None:
        d = torch.where(valid1[:, None], d, _BIG)
    if valid2 is not None:
        d = torch.where(valid2[None, :], d, _BIG)
    return d


class MatchResult(NamedTuple):
    idx: torch.Tensor  # (N,) for each desc1 row, matched desc2 index
    valid: torch.Tensor  # (N,) bool: passed ratio (+ mutual) test
    dist: torch.Tensor  # (N,) f32 best distance


def _top2(d):
    """Row-wise (best, second, argbest) of a distance matrix; ties go to
    the lowest column (first occurrence)."""
    d1 = torch.amin(d, dim=1)
    j = torch.argmin(d, dim=1)
    cols = torch.arange(d.shape[1], device=d.device)[None, :]
    d2 = torch.min(torch.where(cols == j[:, None], _BIG, d), dim=1).values
    return d1, d2, j


def knn2_ratio_match(desc1, desc2, valid1=None, valid2=None, ratio=0.75, mutual=True,
                     max_dist=None):
    """KNN-2 + Lowe ratio (+ optional mutual-NN) matcher:
    keep (i -> j) iff d1(i) < ratio * d2(i)."""
    d = l2_distance_matrix(desc1, desc2, valid1, valid2)
    d1, d2, j = _top2(d)
    ok = d1 < ratio * d2
    if max_dist is not None:
        ok = ok & (d1 < max_dist)
    ok = ok & (d1 < _BIG * 0.5)
    if valid1 is not None:
        ok = ok & valid1
    if mutual:
        col_best = torch.argmin(d, dim=0)
        ok = ok & (col_best[j] == torch.arange(d.shape[0], device=d.device))
    return MatchResult(j.to(torch.int32), ok, d1)


def top2_match_plain(desc_db, valid_db, desc_q):
    """Plain counterpart of the top-2 kernel: for each query, the two
    smallest distances over valid db rows and the argbest (lowest row on
    ties). Returns (d1 (Kq,), d2 (Kq,), idx (Kq,) int32)."""
    d = l2_distance_matrix(desc_q, desc_db, None, valid_db)
    d1, d2, j = _top2(d)
    return d1, d2, j.to(torch.int32)


def knn2_ratio_match_streaming(desc_q, desc_db, valid_q, valid_db, ratio=0.75):
    """Whole-map KNN-2 + ratio matcher (recovery matches the frame against
    every map point, no mutual check). CUDA tensors go to the top-2
    kernel; CPU tensors take the dense path the JAX package takes there."""
    if desc_db.is_cuda:
        from vslam_tpu_torch.ops import cuda_matching

        d1, d2, idx = cuda_matching.top2_match(desc_db, valid_db, desc_q)
        ok = (d1 < ratio * d2) & (d1 < _BIG * 0.5) & valid_q
        return MatchResult(idx, ok, d1)
    return knn2_ratio_match(desc_q, desc_db, valid_q, valid_db, ratio=ratio, mutual=False)


def pixel_dist2_matrix(uv_db, uv_q):
    """(M, 2) x (K, 2) -> (M, K) squared pixel distances via the
    |a|^2 + |b|^2 - 2ab identity (f32 products)."""
    n_db = torch.sum(uv_db * uv_db, dim=-1)
    n_q = torch.sum(uv_q * uv_q, dim=-1)
    cross = uv_db @ uv_q.T
    return torch.clamp(n_db[:, None] + n_q[None, :] - 2.0 * cross, min=0.0)


def radius_descriptor_match(desc_q, uv_q, valid_q, desc_db, uv_db, valid_db, radius_px,
                            desc_thresh, pix_d2=None):
    """Local-map matcher: each db entry's best query keypoint within
    `radius_px` under `desc_thresh`, then per-keypoint dedup keeping the
    best db entry (lowest row on ties). Returns (mp_idx (K,) int32 or -1,
    kp_ok (K,), dist (K,))."""
    d = l2_distance_matrix(desc_db, desc_q, valid_db, valid_q)
    if pix_d2 is None:
        pix_d2 = pixel_dist2_matrix(uv_db, uv_q)
    d = torch.where(pix_d2 <= radius_px * radius_px, d, _BIG)
    best_d = torch.amin(d, dim=1)
    best_kp = torch.argmin(d, dim=1)
    mp_ok = (best_d < desc_thresh) & valid_db
    K = desc_q.shape[0]
    ks = torch.arange(K, device=d.device)
    claim = torch.where(
        (best_kp[:, None] == ks[None, :]) & mp_ok[:, None], best_d[:, None], _BIG
    )
    best_dist_per_kp = torch.amin(claim, dim=0)
    best_mp_per_kp = torch.argmin(claim, dim=0)
    kp_ok = best_dist_per_kp < _BIG * 0.5
    mp_idx = torch.where(kp_ok, best_mp_per_kp, -1).to(torch.int32)
    return mp_idx, kp_ok, best_dist_per_kp


def radius_descriptor_match_fused_plain(desc_q, uv_q, valid_q, desc_db, uv_db, valid_db,
                                        radius_px, desc_thresh):
    """Plain counterpart of the radius kernel (the JAX package's XLA
    path): (mp_idx (K,), kp_ok (K,), dist (K,), min_pix_d2 (M,)), where
    min_pix_d2[i] is the squared pixel distance from db projection i to
    the nearest valid keypoint."""
    pix_d2 = pixel_dist2_matrix(uv_db, uv_q)
    mp_idx, kp_ok, dist = radius_descriptor_match(
        desc_q, uv_q, valid_q, desc_db, uv_db, valid_db,
        radius_px=radius_px, desc_thresh=desc_thresh, pix_d2=pix_d2,
    )
    min_pix_d2 = torch.amin(torch.where(valid_q[None, :], pix_d2, _BIG), dim=-1)
    return mp_idx, kp_ok, dist, min_pix_d2


def radius_descriptor_match_fused(desc_q, uv_q, valid_q, desc_db, uv_db, valid_db,
                                  radius_px, desc_thresh):
    """Local-map radius matcher + found-counter distances. CUDA tensors go
    to the radius kernel; CPU tensors take the plain version."""
    if desc_db.is_cuda:
        from vslam_tpu_torch.ops import cuda_matching

        return cuda_matching.radius_match(
            desc_q, uv_q, valid_q, desc_db, uv_db, valid_db,
            radius_px=float(radius_px), desc_thresh=float(desc_thresh),
        )
    return radius_descriptor_match_fused_plain(
        desc_q, uv_q, valid_q, desc_db, uv_db, valid_db, radius_px, desc_thresh
    )


def radius_descriptor_match_fused_batched_plain(desc_q, uv_q, valid_q, desc_db, uv_db,
                                                valid_db, radius_px, desc_thresh):
    """Plain counterpart of the batched radius kernel: the single plain
    version member by member. Arguments carry a leading batch dimension B;
    returns (mp_idx (B, K), kp_ok (B, K), dist (B, K), min_pix_d2 (B, M))."""
    outs = [
        radius_descriptor_match_fused_plain(*args, radius_px, desc_thresh)
        for args in zip(desc_q, uv_q, valid_q, desc_db, uv_db, valid_db)
    ]
    return tuple(torch.stack(f) for f in zip(*outs))


def radius_descriptor_match_fused_batched(desc_q, uv_q, valid_q, desc_db, uv_db, valid_db,
                                          radius_px, desc_thresh):
    """`radius_descriptor_match_fused` for B independent (keypoints, map)
    pairs. CUDA tensors go to the batched radius kernel (one launch for
    all members); CPU tensors take the plain version."""
    if desc_db.is_cuda:
        from vslam_tpu_torch.ops import cuda_matching

        return cuda_matching.radius_match_batched(
            desc_q, uv_q, valid_q, desc_db, uv_db, valid_db,
            radius_px=float(radius_px), desc_thresh=float(desc_thresh),
        )
    return radius_descriptor_match_fused_batched_plain(
        desc_q, uv_q, valid_q, desc_db, uv_db, valid_db, radius_px, desc_thresh
    )
