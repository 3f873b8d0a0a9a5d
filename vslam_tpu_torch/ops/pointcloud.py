"""Point-cloud neighbourhood ops: exact brute-force k-NN and what is built
on it (the reference's KD-tree epilogue).

Port of `vslam_tpu/ops/pointcloud.py`: statistical outlier removal, the
PCA surface filter, normal estimation, planar densification, MLS
projection, distance-adaptive downsampling, fan triangulation and the
`beautify_cloud` chain that runs them after a run. All masked and
static-shape; the 3x3 eigenproblems use the port's `linalg.eigh_small`
(the same closed form as the JAX package).

Numerics:
- squared distances are |q|^2 + |p|^2 - 2 q.p, as the JAX package
  computes them, in chunks of query rows; the three-term sums are
  written out in a fixed order (not a matrix product), so the card and
  the CPU round them alike;
- neighbours are a stable ascending sort of those distances: equal
  distances keep the lower index first, as XLA's `top_k` does;
- the covariance products run with TF32 off (`linalg.f32_matmuls`).
"""

from __future__ import annotations

import torch

from vslam_tpu_torch.ops import gridhash, linalg

_BIG = 1e18


def _sq(x):
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def knn(points, valid, k, query=None, chunk=2048):
    """Exact k-NN (excluding self when `query` is None).

    points (N, 3), valid (N,); query (Q, 3) or None. Returns (dist (Q, k)
    squared distances ascending, idx (Q, k) int64), k clipped to N - 1
    (self-query) or N. (The JAX package's `query_valid`, which masks
    nothing there, is not taken.)"""
    self_query = query is None
    if self_query:
        query = points
    N, Q = points.shape[0], query.shape[0]
    k = min(k, N - 1 if self_query else N)
    pn = _sq(points)
    cols = torch.arange(N, device=points.device)
    dists, idxs = [], []
    for s in range(0, Q, chunk):
        qc = query[s:s + chunk]
        dot = (qc[:, None, 0] * points[None, :, 0] + qc[:, None, 1] * points[None, :, 1]
               + qc[:, None, 2] * points[None, :, 2])
        d = _sq(qc)[:, None] + pn[None, :] - 2.0 * dot
        d = torch.where(valid[None, :], d, _BIG)
        if self_query:
            rows = torch.arange(s, s + qc.shape[0], device=points.device)
            d = torch.where(rows[:, None] == cols[None, :], _BIG, d)
        sd, si = torch.sort(d, dim=-1, stable=True)
        dists.append(sd[:, :k])
        idxs.append(si[:, :k])
    return torch.clamp(torch.cat(dists), min=0.0), torch.cat(idxs)


def statistical_outlier_removal(points, valid, k=20, std_ratio=2.0):
    """SOR: drop points whose mean k-NN distance exceeds mean + std_ratio
    * std over the cloud. Returns the new valid mask."""
    d2, _ = knn(points, valid, k)
    mean_d = torch.where(valid, torch.mean(torch.sqrt(d2), dim=-1), 0.0)
    n = torch.clamp(torch.sum(valid), min=1)
    mu = torch.sum(mean_d) / n
    var = torch.sum(torch.where(valid, (mean_d - mu) ** 2, 0.0)) / n
    return valid & (mean_d <= mu + std_ratio * torch.sqrt(var))


def _pca_neighborhoods(points, valid, k, idx=None):
    """Covariance eigendecomposition of each point's k-NN: (eigvals
    ascending (N, 3), eigvecs as columns (N, 3, 3), mean (N, 3))."""
    if idx is None:
        _, idx = knn(points, valid, k)
    nbr = points[idx]
    mean = torch.mean(nbr, dim=1)
    c = nbr - mean[:, None, :]
    with linalg.f32_matmuls():
        cov = torch.einsum("nki,nkj->nij", c, c) / k
    w, V = linalg.eigh_small(cov)
    return w, V, mean


def estimate_normals(points, valid, k=16, viewpoint=None):
    """Normals: the smallest PCA eigenvector, turned toward `viewpoint`
    (3,) when one is given."""
    _, V, _ = _pca_neighborhoods(points, valid, k)
    normals = V[..., :, 0]
    if viewpoint is not None:
        flip = torch.sum(normals * (viewpoint - points), dim=-1) < 0
        normals = torch.where(flip[:, None], -normals, normals)
    return normals


def surface_aware_filter(points, valid, k=20, min_anisotropy=0.3):
    """Keep points whose neighbourhood is anisotropic: 1 - lambda_min /
    lambda_max >= min_anisotropy. Returns the new valid mask."""
    w, _, _ = _pca_neighborhoods(points, valid, k)
    aniso = 1.0 - w[..., 0] / torch.clamp(w[..., 2], min=1e-12)
    return valid & (aniso >= min_anisotropy)


def densify_surfaces(points, valid, k=8, max_new_per_point=2, max_gap=0.08):
    """Planar densification: the midpoints toward each point's farthest
    `max_new_per_point` of k neighbours, projected onto its tangent plane,
    where that neighbour lies within (1e-4, max_gap). Returns (new points
    (N * max_new, 3), new valid). (The JAX package's unused PRNG key is
    not taken.)"""
    d2, idx = knn(points, valid, k)
    _, V, _ = _pca_neighborhoods(points, valid, k, idx=idx)
    sel = idx[:, -max_new_per_point:]
    seld = torch.sqrt(d2)[:, -max_new_per_point:]
    mid = 0.5 * (points[:, None, :] + points[sel])
    n_vec = V[..., :, 0]
    off = torch.sum((mid - points[:, None, :]) * n_vec[:, None, :], dim=-1)
    proj = mid - off[..., None] * n_vec[:, None, :]
    ok = valid[:, None] & (seld > 1e-4) & (seld < max_gap)
    return proj.reshape(-1, 3), ok.reshape(-1)


def project_to_mls(points, valid, k=12):
    """First-order MLS: each valid point moved onto the least-squares plane
    of its neighbourhood."""
    _, V, mean = _pca_neighborhoods(points, valid, k)
    n_vec = V[..., :, 0]
    off = torch.sum((points - mean) * n_vec, dim=-1)
    return torch.where(valid[:, None], points - off[:, None] * n_vec, points)


def adaptive_downsample(points, valid, origin, bins=(2.0, 5.0, 10.0),
                        voxel_sizes=(0.01, 0.03, 0.08, 0.20)):
    """Distance-adaptive voxel downsample: finer voxels near `origin`, one
    hash table of 2^20 slots per distance level; the first point of a
    voxel wins (a scatter-min of point indices; invalid points go to the
    last slot). Returns the keep mask."""
    dev = points.device
    dist = torch.sqrt(_sq(points - origin))
    level = torch.searchsorted(torch.tensor(bins, dtype=torch.float32, device=dev), dist)
    vs = torch.tensor(voxel_sizes, dtype=torch.float32, device=dev)[level]
    coords = torch.floor(points / vs[:, None]).to(torch.int32)
    C = 1 << 20
    slot = gridhash.voxel_hash(coords, C).long() + level * C
    N = points.shape[0]
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    tab = torch.full((4 * C,), N, dtype=torch.int32, device=dev)
    tab.scatter_reduce_(0, torch.where(valid, slot, 4 * C - 1), torch.where(valid, idx, N),
                        "amin", include_self=True)
    return valid & (tab[slot] == idx)


def fan_triangulation(points, valid, k=6, max_edge=0.05):
    """Local fan meshing: triangles (i, n_j, n_{j+1}) over each point's
    consecutive near neighbours. Returns (faces (N * (k-1), 3) int32,
    face valid)."""
    d2, idx = knn(points, valid, k)
    d = torch.sqrt(d2)
    idx = idx.to(torch.int32)
    i0 = torch.arange(points.shape[0], dtype=torch.int32, device=points.device)[:, None]
    a, b = idx[:, :-1], idx[:, 1:]
    faces = torch.stack([i0.expand(a.shape), a, b], dim=-1)
    ok = valid[:, None] & (d[:, :-1] < max_edge) & (d[:, 1:] < max_edge)
    return faces.reshape(-1, 3), ok.reshape(-1)


def beautify_cloud(points, valid, traj=None, margin=3.0, k_sor=25, sor_std=0.6,
                   k_surf=25, surf_aniso=0.4, k_normals=20):
    """The reference's epilogue chain: trajectory bounding box (+- margin)
    -> SOR(25, 0.6) -> surface-aware filter(25, 0.4) -> planar
    densification -> normals (k = 20). Runs after a run, so it reads its
    counts back on the host, as the JAX package does.

    points (N, 3) and valid (N,) on any device; traj (T, 3) camera
    positions (numpy or tensor) or None. Returns (points (M, 3), normals
    (M, 3)) f32 tensors on the points' device."""
    points = points.to(torch.float32)
    valid = valid.to(torch.bool)
    n = int(points.shape[0])
    if n < 8 or int(valid.sum()) < 8:
        pts = points[valid]
        return pts, torch.zeros_like(pts)
    if traj is not None and len(traj):
        traj = torch.as_tensor(traj, dtype=torch.float32).to(points.device)
        lo = traj.min(dim=0).values - margin
        hi = traj.max(dim=0).values + margin
        valid = valid & torch.all((points >= lo) & (points <= hi), dim=-1)
    valid = statistical_outlier_removal(points, valid, k=min(k_sor, n - 1), std_ratio=sor_std)
    valid = surface_aware_filter(points, valid, k=min(k_surf, n - 1), min_anisotropy=surf_aniso)
    new_pts, new_ok = densify_surfaces(points, valid)
    pts = torch.cat([points[valid], new_pts[new_ok]])
    if len(pts) < 4:
        return pts, torch.zeros_like(pts)
    ones = torch.ones(len(pts), dtype=torch.bool, device=pts.device)
    return pts, estimate_normals(pts, ones, k=min(k_normals, len(pts) - 1))
