"""Screened-Poisson surface reconstruction on a regular grid.

Port of `vslam_tpu/ops/poisson.py`: an oriented point cloud in, a
density-trimmed triangle mesh out, with no external process (the
reference's `--poisson` shells out to PoissonRecon and SurfaceTrimmer,
`src/main.cpp:1406-1458`). Every stage is a dense tensor program:

1. **Splat** the oriented normals and a scalar density onto an ``R^3``
   grid with trilinear weights (`index_add_`; on the card its atomics add
   in no fixed order, so the card's grid differs from the CPU's in the
   last bits and the app's smoke holds the two meshes to a geometric
   tolerance, not bit for bit).
2. **Smooth** with a separable binomial blur.
3. **Solve** ``lap(chi) = div(V)`` spectrally: one forward and one
   inverse 3-D FFT (`torch.fft`), the periodic 7-point Laplacian being
   diagonal in Fourier space.
4. **Iso level** = mean of ``chi`` at the input points.
5. **Extract** with marching tetrahedra (6 tets per cube, tables derived
   at import); the surface-crossing tets are compacted to a static
   capacity with a stable argsort.
6. **Trim** triangles whose local splat density is below a fraction of
   the median per-sample density (the SurfaceTrimmer equivalent).

Where XLA's CPU code contracts a multiply and an add into one FMA (the
trilinear gather's weighted sum, the grid positions, the edge
interpolation), the port adds the exact f64 product and rounds once, so
the CPU port agrees with the JAX package to its FFT's rounding.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Marching-tetrahedra tables (derived, not transcribed).
#
# Cube corners are indexed by bits (dx + 2*dy + 4*dz). The cube splits into
# 6 tetrahedra around the main diagonal c0 -> c7: one tet per permutation of
# the axis order, with vertices (0, e_p0, e_p0 + e_p1, 7).
# ---------------------------------------------------------------------------

_AXIS_BIT = {0: 1, 1: 2, 2: 4}  # x, y, z -> corner-index bit


def _build_tet_tables():
    from itertools import permutations

    tets = []
    for p in permutations(range(3)):
        v0 = 0
        v1 = _AXIS_BIT[p[0]]
        v2 = v1 + _AXIS_BIT[p[1]]
        v3 = 7
        tets.append((v0, v1, v2, v3))
    tets = np.asarray(tets, np.int32)  # (6, 4) cube-corner ids

    edge_pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]

    def eid(a, b):
        return edge_pairs.index((min(a, b), max(a, b)))

    tri_edges = np.zeros((16, 2, 3), np.int32)
    ntri = np.zeros(16, np.int32)
    for case in range(1, 15):
        inside = [i for i in range(4) if (case >> i) & 1]
        outside = [i for i in range(4) if not (case >> i) & 1]
        if len(inside) == 1:
            a = inside[0]
            tri_edges[case, 0] = [eid(a, o) for o in outside]
            ntri[case] = 1
        elif len(inside) == 3:
            a = outside[0]
            tri_edges[case, 0] = [eid(a, i) for i in inside]
            ntri[case] = 1
        else:  # 2 in / 2 out: the 4 crossing edges form a quad
            a, b = inside
            c, d = outside
            quad = [eid(a, c), eid(a, d), eid(b, d), eid(b, c)]
            tri_edges[case, 0] = [quad[0], quad[1], quad[2]]
            tri_edges[case, 1] = [quad[0], quad[2], quad[3]]
            ntri[case] = 2
    return tets, np.asarray(edge_pairs, np.int32), tri_edges, ntri


_TETS, _EDGE_PAIRS, _TRI_EDGES, _NTRI = _build_tet_tables()

# Cube-corner offsets in (x, y, z), matching the bit convention above.
_CORNER_OFF = np.stack(
    [np.array([(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1]) for c in range(8)]
).astype(np.int32)  # (8, 3)


def _fma(a, b, c):
    """a * b + c rounded once to f32 (XLA's contracted multiply-add)."""
    return (a.double() * b.double() + c.double()).float()


def _corner_weights(points, origin, h, R):
    """Base cell (N, 3), the 8 corner grid coordinates (N, 8, 3) and
    trilinear weights (N, 8) of world points (N, 3)."""
    g = (points - origin) / h
    base = torch.clamp(torch.floor(g).to(torch.int64), 0, R - 2)
    frac = torch.clamp(g - base.to(torch.float32), 0.0, 1.0)
    corner = torch.from_numpy(_CORNER_OFF.astype(np.int64)).to(points.device)  # (8, 3)
    idx = base[:, None, :] + corner[None, :, :]
    f = torch.where(corner[None, :, :] == 1, frac[:, None, :], 1.0 - frac[:, None, :])
    w = f[..., 0] * f[..., 1] * f[..., 2]
    return idx, w


def _trilinear_splat(points, vals, valid, origin, h, resolution):
    """Scatter-add `vals` (N, C) into an (R, R, R, C) grid with trilinear
    weights: one flat scalar scatter-add per channel."""
    R = resolution
    idx, w = _corner_weights(points, origin, h, R)
    w = torch.where(valid[:, None], w, 0.0)
    flat = ((idx[..., 0] * R + idx[..., 1]) * R + idx[..., 2]).reshape(-1)
    out = []
    for c in range(vals.shape[-1]):
        contrib = (w * vals[:, c:c + 1]).reshape(-1)
        out.append(torch.zeros(R * R * R, dtype=torch.float32, device=points.device)
                   .index_add_(0, flat, contrib))
    return torch.stack(out, dim=-1).reshape(R, R, R, -1)


def _binomial_blur(x, passes):
    """Separable (1, 2, 1)/4 blur along the 3 grid axes, `passes` times."""
    for _ in range(passes):
        for ax in range(3):
            x = 0.5 * x + 0.25 * (torch.roll(x, 1, dims=ax) + torch.roll(x, -1, dims=ax))
    return x


def _divergence(V, h):
    """Central-difference divergence of a periodic vector field (R,R,R,3)."""
    d = 0.0
    for ax in range(3):
        comp = V[..., ax]
        d = d + (torch.roll(comp, -1, dims=ax) - torch.roll(comp, 1, dims=ax)) / (2.0 * h)
    return d


def _poisson_solve_fft(rhs, h):
    """chi with lap(chi) = rhs under periodic BCs, via the diagonal
    Fourier representation of the discrete 7-point Laplacian."""
    R = rhs.shape[0]
    k = torch.fft.fftfreq(R, device=rhs.device).to(torch.float32)
    lam1 = (2.0 * torch.cos(np.float32(2.0 * np.pi) * k) - 2.0) / (h * h)
    L = lam1[:, None, None] + lam1[None, :, None] + lam1[None, None, :]
    F = torch.fft.fftn(rhs)
    zero = L == 0.0
    F = torch.where(zero, torch.zeros((), dtype=F.dtype, device=F.device),
                    F / torch.where(zero, 1.0, L))
    return torch.real(torch.fft.ifftn(F)).to(torch.float32)


def _trilinear_gather(grid, points, origin, h):
    """Sample a scalar (R, R, R) grid at world points (N, 3); the 8 terms
    are summed corner by corner, each as one multiply-add."""
    R = grid.shape[0]
    idx, w = _corner_weights(points, origin, h, R)
    vals = grid[idx[..., 0], idx[..., 1], idx[..., 2]]
    acc = torch.zeros(points.shape[0], dtype=torch.float32, device=points.device)
    for c in range(8):
        acc = _fma(w[:, c], vals[:, c], acc)
    return acc


def _nanmedian(x):
    """Median of the non-NaN entries (the mean of the two middle ones for
    an even count, as `jnp.nanmedian`); NaN when there are none."""
    s = torch.sort(x).values  # NaNs sort last
    n = torch.sum(~torch.isnan(x))
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    med = 0.5 * s[lo] + 0.5 * s[hi]
    return torch.where(n > 0, med, torch.nan)


# ---------------------------------------------------------------------------
# Isosurface extraction
# ---------------------------------------------------------------------------


def reconstruct(points, valid, normals, origin, h, resolution=96, tet_capacity=65536,
                blur_passes=2, trim_frac=0.08):
    """Oriented points -> triangle soup on the chi iso-surface, on the
    points' device.

    Args:
      points: (N, 3) world positions; valid: (N,) mask.
      normals: (N, 3) unit normals pointing into free space.
      origin: (3,) world position of grid node (0, 0, 0).
      h: grid spacing (world units per cell), a float or () tensor.
      resolution: grid side R.
      tet_capacity: max surface-crossing tetrahedra processed; each emits
        up to 2 triangles. Overflow reported via n_active_tets.
      blur_passes: binomial smoothing passes on the splatted fields.
      trim_frac: keep triangles whose local splat density >= trim_frac *
        median per-sample density (0 disables the trim).

    Returns dict:
      tri_verts: (2 * tet_capacity, 3, 3) float32 world coordinates.
      tri_valid: (2 * tet_capacity,) bool (density-trimmed).
      tri_valid_untrimmed: (2 * tet_capacity,) bool.
      n_active_tets: () int64: tets the surface crosses; above
        tet_capacity the soup is truncated.
      chi, density, iso: solve diagnostics.
    """
    R = resolution
    dev = points.device
    points = points.to(torch.float32)
    normals = normals.to(device=dev, dtype=torch.float32)
    valid = valid.to(device=dev, dtype=torch.bool)
    origin = torch.as_tensor(origin, dtype=torch.float32).to(dev)
    h = torch.as_tensor(h, dtype=torch.float32).to(dev)

    vals = torch.cat([normals, torch.ones((points.shape[0], 1), device=dev)], -1)
    grid = _trilinear_splat(points, vals, valid, origin, h, R)
    grid = _binomial_blur(grid, blur_passes)
    V, density = grid[..., :3], grid[..., 3]

    chi = _poisson_solve_fft(_divergence(V, h), h)

    # Iso level: mean of chi at the valid samples.
    chi_at = _trilinear_gather(chi, points, origin, h)
    wsum = torch.clamp(torch.sum(valid.to(torch.float32)), min=1.0)
    iso = torch.sum(torch.where(valid, chi_at, 0.0)) / wsum

    f = chi - iso  # zero-crossing field
    inside = f > 0.0

    # Packed cube-corner inside bits: (R-1)^3.
    case8 = torch.zeros((R - 1,) * 3, dtype=torch.int64, device=dev)
    for c in range(8):
        dx, dy, dz = (int(v) for v in _CORNER_OFF[c])
        case8 = case8 + (inside[dx:R - 1 + dx, dy:R - 1 + dy, dz:R - 1 + dz].to(torch.int64) << c)

    tets = torch.from_numpy(_TETS.astype(np.int64)).to(dev)  # (6, 4)
    cube_flat = case8.reshape(-1)
    tet_bits = (cube_flat[:, None, None] >> tets[None, :, :]) & 1  # (Nc, 6, 4)
    tet_case = torch.sum(tet_bits << torch.arange(4, device=dev), dim=-1)  # (Nc, 6)
    ntri_tab = torch.from_numpy(_NTRI.astype(np.int64)).to(dev)
    active = (ntri_tab[tet_case] > 0).reshape(-1)
    n_active_tets = torch.sum(active)

    # Compact active tets to capacity (stable argsort keeps low indices).
    T = tet_capacity
    order = torch.argsort(torch.where(active, 0, 1).to(torch.int32), stable=True)
    sel = order[:T]
    sel_ok = active[sel]

    Nc1 = R - 1
    cube_id = sel // 6
    tet_id = sel % 6
    base = torch.stack([cube_id // (Nc1 * Nc1), (cube_id // Nc1) % Nc1, cube_id % Nc1], dim=-1)

    corners = tets[tet_id]  # (T, 4) cube-corner ids
    coff = torch.from_numpy(_CORNER_OFF.astype(np.int64)).to(dev)[corners]  # (T, 4, 3)
    gcoord = base[:, None, :] + coff
    fvals = f[gcoord[..., 0], gcoord[..., 1], gcoord[..., 2]]  # (T, 4)
    pos = _fma(gcoord.to(torch.float32), h, origin)  # (T, 4, 3)

    case_sel = tet_case.reshape(-1)[sel]
    tri_e = torch.from_numpy(_TRI_EDGES.astype(np.int64)).to(dev)[case_sel]  # (T, 2, 3)
    pair = torch.from_numpy(_EDGE_PAIRS.astype(np.int64)).to(dev)[tri_e]  # (T, 2, 3, 2)

    ids_a = pair[..., 0].reshape(T, 6)
    ids_b = pair[..., 1].reshape(T, 6)
    va = torch.gather(fvals, 1, ids_a).reshape(T, 2, 3)
    vb = torch.gather(fvals, 1, ids_b).reshape(T, 2, 3)
    pa = torch.gather(pos, 1, ids_a[..., None].expand(-1, -1, 3)).reshape(T, 2, 3, 3)
    pb = torch.gather(pos, 1, ids_b[..., None].expand(-1, -1, 3)).reshape(T, 2, 3, 3)

    denom = va - vb
    t = va / torch.where(torch.abs(denom) < 1e-20, 1e-20, denom)
    t = torch.clamp(t, 0.0, 1.0)
    verts = _fma(t[..., None], pb - pa, pa)  # (T, 2, 3, 3)

    tri_ok = sel_ok[:, None] & (torch.arange(2, device=dev)[None, :] < ntri_tab[case_sel][:, None])

    # Density trim (SurfaceTrimmer equivalent): triangle centroid's local
    # splat density vs a fraction of the median per-sample density.
    dens_at = _trilinear_gather(density, points, origin, h)
    med = torch.nan_to_num(_nanmedian(torch.where(valid, dens_at, torch.nan)), nan=0.0)
    centroid = torch.mean(verts, dim=-2).reshape(-1, 3)
    cdens = _trilinear_gather(density, centroid, origin, h).reshape(T, 2)
    trimmed = tri_ok & (cdens >= trim_frac * med)

    return {
        "tri_verts": verts.reshape(-1, 3, 3),
        "tri_valid": trimmed.reshape(-1),
        "tri_valid_untrimmed": tri_ok.reshape(-1),
        "n_active_tets": n_active_tets,
        "chi": chi,
        "density": density,
        "iso": iso,
    }


# ---------------------------------------------------------------------------
# Host wrapper: bounds, welding, PLY-ready output
# ---------------------------------------------------------------------------


def poisson_mesh(points, normals, valid=None, resolution=96, margin_frac=0.15,
                 tet_capacity=65536, trim_frac=0.08, blur_passes=2, device="cuda"):
    """Oriented cloud (numpy) -> welded (verts, faces): grid bounds with a
    periodic-wrap margin on the host, `reconstruct` on `device`, and the
    triangle soup welded into shared vertices on the host.

    Returns (verts (V, 3) float32, faces (F, 3) int32) as numpy arrays;
    both empty when fewer than 4 valid points."""
    pts = np.asarray(points, np.float32)
    nrm = np.asarray(normals, np.float32)
    if valid is None:
        valid = np.ones(len(pts), bool)
    valid = np.asarray(valid, bool)
    if valid.sum() < 4:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    vp = pts[valid]
    lo, hi = vp.min(0), vp.max(0)
    span = float(max((hi - lo).max(), 1e-3))
    pad = span * margin_frac
    origin = (lo + hi) / 2.0 - (span / 2.0 + pad)
    h = (span + 2.0 * pad) / (resolution - 1)

    dev = torch.device(device)
    out = reconstruct(
        torch.from_numpy(pts).to(dev), torch.from_numpy(valid).to(dev),
        torch.from_numpy(nrm).to(dev), np.asarray(origin, np.float32), np.float32(h),
        resolution=resolution, tet_capacity=tet_capacity, blur_passes=blur_passes,
        trim_frac=trim_frac,
    )
    tv = out["tri_verts"][out["tri_valid"]].cpu().numpy()
    if len(tv) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # Weld: quantize to a small fraction of the cell size so shared tet
    # edges (bit-identical interpolations) collapse to one vertex.
    q = np.round(tv.reshape(-1, 3) / (h * 1e-3)).astype(np.int64)
    uq, inv = np.unique(q, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    verts = np.zeros((len(uq), 3), np.float64)
    counts = np.zeros(len(uq), np.int64)
    np.add.at(verts, inv, tv.reshape(-1, 3).astype(np.float64))
    np.add.at(counts, inv, 1)
    verts = (verts / counts[:, None]).astype(np.float32)
    faces = inv.reshape(-1, 3).astype(np.int32)
    # Drop degenerate faces (two corners welded together).
    keep = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return verts, faces[keep]
