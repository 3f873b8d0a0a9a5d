"""The port's point-cloud ops (`vslam_tpu_torch.ops.pointcloud`) against
the JAX package's `vslam_tpu.ops.pointcloud`, on the same numpy inputs.

Tolerance:
- On integer coordinates every squared distance is exact in f32, so
  ties are real: `knn`'s indices must equal JAX's (the lower index first,
  as XLA's `top_k` orders ties), and its distances are equal.
- On general f32 coordinates the q.p term rounds in another order (the
  port sums three products in a fixed order; XLA's CPU dot may fuse),
  so distances agree within 2e-5 (measured 3.8e-6 on squared distances
  up to ~30), and indices are held wherever the next distance is more
  than that apart (a near-tie may trade places).
- Masks (SOR, surface filter, downsampling, face validity) are equal;
  points and normals within 1e-5 (normals from the same closed-form 3x3
  eigensolver on covariances within f32 rounding; measured 5.7e-7)
  wherever a point's set of neighbours is determined, i.e. its k-th and
  next distance are more than 2e-5 apart (about 0.1% of the points of
  the dense test clouds are not, and take another neighbour).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vslam_tpu.ops import pointcloud as j_pc
from vslam_tpu_torch.ops import pointcloud as t_pc

DIST_ATOL = 2e-5
ATOL = 1e-5


def _cloud(seed, n=1200, e=2.0):
    """Two noisy planes (floor and wall, e m across) with a few far
    outliers."""
    rng = np.random.default_rng(seed)
    h = n // 2
    floor = np.c_[rng.uniform(-e, e, h), 1.5 + rng.normal(0, 0.003, h), rng.uniform(-e, e, h)]
    wall = np.c_[np.full(n - h, 3.0) + rng.normal(0, 0.003, n - h), rng.uniform(-e, e, n - h),
                 rng.uniform(-e, e, n - h)]
    pts = np.concatenate([floor, wall]).astype(np.float32)
    pts[::40] += rng.normal(0, 1.0, (len(pts[::40]), 3)).astype(np.float32)
    return pts, rng.random(n) > 0.1


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _sure(dj, k_next):
    """Where a neighbour's index is determined: its distance is more than
    DIST_ATOL from the one before and the one after (dj (Q, k + 1): the
    k neighbours and the next one)."""
    gap = np.diff(dj, axis=1)
    lo = np.concatenate([np.full((len(dj), 1), np.inf), gap], axis=1)
    return ((lo > DIST_ATOL) & (np.concatenate([gap, np.full((len(dj), 1), np.inf)], axis=1)
                                > DIST_ATOL))[:, :k_next]


def _set_sure(pts, valid, k):
    """Rows whose set of k neighbours is determined: the k-th and the next
    distance (JAX's) are more than DIST_ATOL apart."""
    d, _ = j_pc.knn(jnp.asarray(pts), jnp.asarray(valid), k + 1)
    d = np.asarray(d)
    sure = d[:, k] - d[:, k - 1] > DIST_ATOL
    assert sure.mean() > 0.8
    return sure


def _assert_knn_close(dj, ij, dt, it):
    dj, ij = np.asarray(dj), np.asarray(ij)
    dt, it = dt.numpy(), it.numpy()
    np.testing.assert_allclose(dt, dj, atol=DIST_ATOL, rtol=0)
    sure = _sure(dj, dj.shape[1])
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(it[sure], ij[sure])


@pytest.mark.parametrize("k", [2, 6, 12])
def test_knn_ties_go_to_the_lower_index(k):
    """Points on a 4x4x4 integer grid, repeated: many equal distances,
    invalid points among them."""
    rng = np.random.default_rng(k)
    pts = rng.integers(0, 4, (300, 3)).astype(np.float32)
    valid = rng.random(300) > 0.2
    dj, ij = j_pc.knn(jnp.asarray(pts), jnp.asarray(valid), k)
    dt, it = t_pc.knn(_t(pts), _t(valid), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert (np.diff(dt.numpy(), axis=1) == 0).any()


def test_knn_general_and_query(rng):
    pts, valid = _cloud(1)
    dj, ij = j_pc.knn(jnp.asarray(pts), jnp.asarray(valid), 10, chunk=256)
    dt, it = t_pc.knn(_t(pts), _t(valid), 10, chunk=256)
    _assert_knn_close(dj, ij, dt, it)
    q = rng.normal(0, 1, (70, 3)).astype(np.float32)
    qv = np.ones(70, bool)
    dj, ij = j_pc.knn(jnp.asarray(pts), jnp.asarray(valid), 5, query=jnp.asarray(q),
                      query_valid=jnp.asarray(qv))
    dt, it = t_pc.knn(_t(pts), _t(valid), 5, query=_t(q))
    _assert_knn_close(dj, ij, dt, it)


def test_knn_clips_k_to_the_cloud():
    pts = np.arange(12, dtype=np.float32).reshape(4, 3)
    dt, it = t_pc.knn(_t(pts), torch.ones(4, dtype=torch.bool), 10)
    assert dt.shape == it.shape == (4, 3)
    assert (it.numpy() != np.arange(4)[:, None]).all()


@pytest.mark.parametrize("seed", [2, 3])
def test_filters_vs_jax(seed):
    pts, valid = _cloud(seed)
    pj, vj, pt, vt = jnp.asarray(pts), jnp.asarray(valid), _t(pts), _t(valid)
    sj = np.asarray(j_pc.statistical_outlier_removal(pj, vj, k=20, std_ratio=1.0))
    st = t_pc.statistical_outlier_removal(pt, vt, k=20, std_ratio=1.0).numpy()
    np.testing.assert_array_equal(st, sj)
    assert 0 < st.sum() < valid.sum()
    aj = np.asarray(j_pc.surface_aware_filter(pj, vj, k=12, min_anisotropy=0.98))
    at = t_pc.surface_aware_filter(pt, vt, k=12, min_anisotropy=0.98).numpy()
    np.testing.assert_array_equal(at, aj)
    assert 0 < at.sum() < valid.sum()


def test_normals_mls_and_densify_vs_jax():
    pts, valid = _cloud(4, e=0.5)
    pj, vj, pt, vt = jnp.asarray(pts), jnp.asarray(valid), _t(pts), _t(valid)
    vp = np.array([0.0, 0.0, 0.0], np.float32)
    nj = np.asarray(j_pc.estimate_normals(pj, vj, k=16, viewpoint=jnp.asarray(vp)))
    nt = t_pc.estimate_normals(pt, vt, k=16, viewpoint=_t(vp)).numpy()
    sure = _set_sure(pts, valid, 16)
    np.testing.assert_allclose(nt[sure], nj[sure], atol=ATOL, rtol=0)
    sure = _set_sure(pts, valid, 12)
    np.testing.assert_allclose(t_pc.project_to_mls(pt, vt).numpy()[sure],
                               np.asarray(j_pc.project_to_mls(pj, vj))[sure], atol=ATOL, rtol=0)
    dj, okj = j_pc.densify_surfaces(pj, vj, None)
    dt, okt = t_pc.densify_surfaces(pt, vt)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt.numpy().sum() > 100
    # each new point sits toward one of the two farthest of 8 neighbours:
    # held where those two are determined (the 9th decides the 8th)
    d9, _ = j_pc.knn(pj, vj, 9)
    sure = _sure(np.asarray(d9), 8)[:, -2:].all(axis=1).repeat(2)
    assert sure.mean() > 0.8
    np.testing.assert_allclose(dt.numpy()[sure], np.asarray(dj)[sure], atol=ATOL, rtol=0)


def test_adaptive_downsample_vs_jax():
    """Four distance levels; invalid points go to the last slot and never
    win."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-12, 12, (4000, 3)).astype(np.float32)
    pts[:1000] = rng.uniform(-1, 1, (1000, 3)) * 0.03  # dense near the origin
    valid = rng.random(4000) > 0.1
    origin = np.zeros(3, np.float32)
    kj = np.asarray(j_pc.adaptive_downsample(jnp.asarray(pts), jnp.asarray(valid),
                                             jnp.asarray(origin)))
    kt = t_pc.adaptive_downsample(_t(pts), _t(valid), _t(origin)).numpy()
    np.testing.assert_array_equal(kt, kj)
    assert 0 < kt[:1000].sum() < valid[:1000].sum() and not kt[~valid].any()


def test_fan_triangulation_vs_jax():
    """On an integer grid (exact distances, many ties) every face equals
    JAX's."""
    rng = np.random.default_rng(6)
    pts = np.unique(rng.integers(0, 6, (400, 3)), axis=0).astype(np.float32)
    valid = rng.random(len(pts)) > 0.1
    fj, oj = j_pc.fan_triangulation(jnp.asarray(pts), jnp.asarray(valid), max_edge=1.5)
    ft, ot = t_pc.fan_triangulation(_t(pts), _t(valid), max_edge=1.5)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(ft.numpy()[ot.numpy()], np.asarray(fj)[np.asarray(oj)])
    assert ft.dtype == torch.int32 and ot.numpy().sum() > 100


def test_beautify_cloud_vs_jax():
    """The whole chain: trajectory box, SOR, surface filter, densification,
    normals. Equal counts; points and normals within ATOL."""
    pts, valid = _cloud(7, n=2000, e=0.6)
    traj = np.c_[np.linspace(0, 1, 10), np.zeros(10), np.linspace(0, 1, 10)].astype(np.float32)
    pj, nj = j_pc.beautify_cloud(pts, valid, traj=traj)
    pt, nt = t_pc.beautify_cloud(_t(pts), _t(valid), traj=traj)
    assert pt.shape == pj.shape and len(pj) > valid.sum()
    np.testing.assert_allclose(pt.numpy(), pj, atol=ATOL, rtol=0)
    sure = _set_sure(pj, np.ones(len(pj), bool), 20)
    np.testing.assert_allclose(nt.numpy()[sure], nj[sure], atol=ATOL, rtol=0)
    few = t_pc.beautify_cloud(_t(pts[:6]), _t(valid[:6]))
    assert few[0].shape == (int(valid[:6].sum()), 3) and not few[1].any()
