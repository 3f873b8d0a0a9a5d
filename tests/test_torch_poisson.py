"""The port's Poisson surface reconstruction (`vslam_tpu_torch.ops.poisson`)
against the JAX package's, and its own accuracy and trim cases after
`tests/test_poisson.py`, on the CPU at small grids.

Tolerances against JAX (a unit sphere of 2,000 points at R 32):
- the tet tables and the splatted density: equal (the same scatter order
  on the CPU);
- chi: within 2e-6 (the FFTs of the two frameworks round otherwise;
  |chi| <= 0.14), the iso level within 1e-6;
- the active-tet count and both triangle masks: equal; the triangle
  vertices within 1e-5;
- the welded mesh at R 48: the same vertex and face counts, and every
  vertex within 1e-5 of one of the other mesh's (the weld's vertex order
  follows its quantized keys, which a rounding can reorder).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vslam_tpu.ops import poisson as j_poisson
from vslam_tpu_torch.io import ply
from vslam_tpu_torch.ops import poisson as t_poisson


def _sphere(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32)


def _nearest(a, b):
    """For each row of a, the distance to the nearest row of b."""
    from scipy.spatial import cKDTree

    return cKDTree(b).query(a)[0]


def test_tet_tables_equal_jax():
    for name in ("_TETS", "_EDGE_PAIRS", "_TRI_EDGES", "_NTRI", "_CORNER_OFF"):
        np.testing.assert_array_equal(getattr(t_poisson, name), getattr(j_poisson, name))
    corners = t_poisson._CORNER_OFF.astype(np.float64)
    vol = sum(abs(np.linalg.det(corners[t][1:] - corners[t][0])) / 6.0 for t in t_poisson._TETS)
    assert abs(vol - 1.0) < 1e-12


def test_reconstruct_matches_jax_on_a_sphere():
    v = _sphere(2000)
    valid = np.ones(len(v), bool)
    origin = np.asarray([-1.5, -1.5, -1.5], np.float32)
    h = np.float32(3.0 / 31)
    want = j_poisson.reconstruct(jnp.asarray(v), jnp.asarray(valid), jnp.asarray(v),
                                 jnp.asarray(origin), jnp.float32(h), resolution=32,
                                 tet_capacity=16384)
    want = {k: np.asarray(x) for k, x in want.items()}
    got = t_poisson.reconstruct(torch.from_numpy(v), torch.from_numpy(valid),
                                torch.from_numpy(v), origin, h, resolution=32,
                                tet_capacity=16384)
    got = {k: x.numpy() for k, x in got.items()}
    np.testing.assert_array_equal(got["density"], want["density"])
    np.testing.assert_allclose(got["chi"], want["chi"], atol=2e-6, rtol=0)
    np.testing.assert_allclose(got["iso"], want["iso"], atol=1e-6, rtol=0)
    assert int(got["n_active_tets"]) == int(want["n_active_tets"]) > 5000
    np.testing.assert_array_equal(got["tri_valid_untrimmed"], want["tri_valid_untrimmed"])
    np.testing.assert_array_equal(got["tri_valid"], want["tri_valid"])
    m = got["tri_valid_untrimmed"]
    np.testing.assert_allclose(got["tri_verts"][m], want["tri_verts"][m], atol=1e-5, rtol=0)


def test_poisson_mesh_matches_jax():
    v = _sphere(2000, seed=1)
    vj, fj = j_poisson.poisson_mesh(v, v, resolution=48, tet_capacity=32768)
    vt, ft = t_poisson.poisson_mesh(v, v, resolution=48, tet_capacity=32768, device="cpu")
    assert vt.shape == vj.shape and ft.shape == fj.shape and len(ft) > 4000
    assert _nearest(vt, vj).max() < 1e-5 and _nearest(vj, vt).max() < 1e-5
    assert ft.min() >= 0 and ft.max() < len(vt)


def test_sphere_reconstruction_accuracy():
    pts = _sphere(4000)
    verts, faces = t_poisson.poisson_mesh(pts, pts, resolution=48, tet_capacity=32768,
                                          device="cpu")
    assert len(verts) > 2000 and len(faces) > 4000
    r = np.linalg.norm(verts, axis=1)
    assert np.sqrt(np.mean((r - 1.0) ** 2)) < 0.02
    assert r.min() > 0.9 and r.max() < 1.1


def test_density_trim_removes_hallucinated_closure():
    v = _sphere(8000)
    v = v[v[:, 2] > 0.15][:2000]
    verts_u, faces_u = t_poisson.poisson_mesh(v, v, resolution=48, tet_capacity=32768,
                                              trim_frac=0.0, device="cpu")
    verts_t, faces_t = t_poisson.poisson_mesh(v, v, resolution=48, tet_capacity=32768,
                                              trim_frac=0.08, device="cpu")
    assert verts_u[:, 2].min() < -0.1  # the closure membrane
    assert verts_t[:, 2].min() > -0.05  # trimmed away
    assert len(faces_t) < len(faces_u)
    r = np.linalg.norm(verts_t, axis=1)
    assert np.sqrt(np.mean((r - 1.0) ** 2)) < 0.03


def test_reconstruct_reports_overflow_and_masks():
    pts = torch.from_numpy(_sphere(1000))
    out = t_poisson.reconstruct(pts, torch.ones(len(pts), dtype=torch.bool), pts,
                                np.asarray([-1.5, -1.5, -1.5], np.float32),
                                np.float32(3.0 / 31), resolution=32, tet_capacity=256)
    assert int(out["n_active_tets"]) > 256
    assert int(out["tri_valid_untrimmed"].sum()) > 256
    assert bool(torch.all(~out["tri_valid"] | out["tri_valid_untrimmed"]))


def test_masked_invalid_points_are_ignored():
    pts = _sphere(2000)
    allpts = np.concatenate([pts, np.full((500, 3), 50.0, np.float32)])
    nrm = np.concatenate([pts, np.tile([0, 0, 1.0], (500, 1))]).astype(np.float32)
    valid = np.concatenate([np.ones(2000, bool), np.zeros(500, bool)])
    verts, _ = t_poisson.poisson_mesh(allpts, nrm, valid=valid, resolution=40,
                                      tet_capacity=32768, device="cpu")
    r = np.linalg.norm(verts, axis=1)
    assert np.sqrt(np.mean((r - 1.0) ** 2)) < 0.03 and r.max() < 1.2


@pytest.mark.parametrize("n", [3, 0])
def test_too_few_points_give_an_empty_mesh(n):
    v, f = t_poisson.poisson_mesh(_sphere(5)[:n], _sphere(5)[:n], device="cpu")
    assert v.shape == (0, 3) and f.shape == (0, 3)


def test_ply_mesh_roundtrip(tmp_path):
    pts = _sphere(1500)
    verts, faces = t_poisson.poisson_mesh(pts, pts, resolution=32, tet_capacity=16384,
                                          device="cpu")
    path = str(tmp_path / "mesh.ply")
    ply.save_ply(path, verts, faces=faces)
    back = ply.load_ply(path)
    np.testing.assert_allclose(back["points"], verts, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(back["faces"]), faces)
