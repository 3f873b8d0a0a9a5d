"""RANSAC of the port (`vslam_tpu_torch.ops.ransac`) against the JAX
package with the same keys.

Tolerance: the minimal sets come from bit-exact threefry draws, so the
sampled indices must be equal. For the 3D-3D and fundamental RANSACs the
inlier masks are equal too and the refined models agree to 1e-4 (f32
rounding through the batched minimal solves and the weighted refit).

The essential RANSAC is held looser: its minimal 8-point solves in
normalised coordinates find the null vector of an 8x9 system by
shift-and-invert, which amplifies f32 rounding by the inverse gap between
the two smallest eigenvalues. On a near-degenerate sample a different
order of summation moves a hypothesis by up to ~1e-2, which can flip a
few 1 px Sampson decisions. So the `ok` flags are equal, the rotations
agree to 2e-3, the unit translations to 2e-2 and the inlier counts to 5%.
Degenerate inputs (too few valid matches) give the same `ok` flag in all
three.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vslam_tpu.ops import ransac as j_rs
from vslam_tpu.ops import se3 as j_se3
from vslam_tpu_torch.ops import linalg as t_la
from vslam_tpu_torch.ops import prng
from vslam_tpu_torch.ops import ransac as t_rs

FX, FY, CX, CY = 525.0, 525.0, 319.5, 239.5


def _keys(seed, fid):
    kj = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), fid), 7)[2]
    kt = prng.split(prng.fold_in(prng.prng_key(seed), fid), 7)[2]
    return kj, kt


def _cmp(jout, tout, atol=1e-4):
    jl = jax.tree.leaves(jout)
    tl = [x for x in jax.tree.leaves(tuple(tout), is_leaf=lambda v: isinstance(v, torch.Tensor))]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a, b = np.asarray(a), b.numpy()
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, atol=atol, rtol=1e-4)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _rot(rng, angle):
    w = rng.normal(size=3)
    w *= angle / np.linalg.norm(w)
    return np.asarray(j_se3.exp_so3(jnp.asarray(w, jnp.float32)))


def _matches_3d(rng, n=300, outliers=0.3):
    R = _rot(rng, 0.05)
    t = np.array([0.04, -0.01, 0.03], np.float32)
    src = (rng.uniform(-1.5, 1.5, (n, 3)) + [0, 0, 3.0]).astype(np.float32)
    dst = (src @ R.T + t + rng.normal(0, 0.005, (n, 3))).astype(np.float32)
    bad = rng.random(n) < outliers
    dst[bad] += rng.uniform(-0.5, 0.5, (bad.sum(), 3)).astype(np.float32)
    valid = rng.random(n) > 0.1
    return src, dst, valid


def _matches_2d(rng, n=300, outliers=0.25):
    X = rng.uniform(-2, 2, (n, 3)) + [0, 0, 5.0]
    R, t = _rot(rng, 0.08), np.array([0.3, 0.05, 0.02])
    X2 = X @ R.T + t

    def pix(P):
        return np.stack([FX * P[:, 0] / P[:, 2] + CX, FY * P[:, 1] / P[:, 2] + CY], -1)

    uv1 = pix(X) + rng.normal(0, 0.3, (n, 2))
    uv2 = pix(X2) + rng.normal(0, 0.3, (n, 2))
    bad = rng.random(n) < outliers
    uv2[bad] += rng.uniform(-60, 60, (bad.sum(), 2))
    valid = rng.random(n) > 0.1
    return uv1.astype(np.float32), uv2.astype(np.float32), valid


@pytest.mark.parametrize("fid", [0, 5, 77])
def test_sample_minimal_sets_equal(rng, fid):
    valid = rng.random(400) > 0.4
    kj, kt = _keys(42, fid)
    want = np.asarray(j_rs.sample_minimal_sets(kj, jnp.asarray(valid), 256, 3))
    got = t_rs.sample_minimal_sets(kt, torch.from_numpy(valid), 256, 3).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fid", [1, 2, 3])
def test_ransac_kabsch_3d3d(rng, fid):
    src, dst, valid = _matches_3d(rng)
    kj, kt = _keys(42, fid)
    kw = dict(num_hypotheses=128, inlier_thresh=0.05, max_translation=0.2,
              min_translation=1e-4, min_inliers=10)
    jo = jax.jit(lambda *a: j_rs.ransac_kabsch_3d3d(kj, *a, **kw))(*_j(src, dst, valid))
    with t_la.f32_matmuls():
        to = t_rs.ransac_kabsch_3d3d(kt, *_t(src, dst, valid), **kw)
    _cmp(jo, to)
    assert bool(to[2].ok)
    # Degenerate: two valid matches.
    few = np.zeros_like(valid)
    few[:2] = True
    jo = jax.jit(lambda *a: j_rs.ransac_kabsch_3d3d(kj, *a, **kw))(*_j(src, dst, few))
    with t_la.f32_matmuls():
        to = t_rs.ransac_kabsch_3d3d(kt, *_t(src, dst, few), **kw)
    assert bool(to[2].ok) == bool(jo[2].ok) is False
    np.testing.assert_array_equal(to[2].inlier_mask.numpy(), np.asarray(jo[2].inlier_mask))


@pytest.mark.parametrize("fid", [1, 2])
def test_ransac_fundamental(rng, fid):
    uv1, uv2, valid = _matches_2d(rng)
    kj, kt = _keys(7, fid)
    jo = jax.jit(lambda *a: j_rs.ransac_fundamental(kj, *a, num_hypotheses=64))(
        *_j(uv1, uv2, valid))
    with t_la.f32_matmuls():
        to = t_rs.ransac_fundamental(kt, *_t(uv1, uv2, valid), num_hypotheses=64)
    # F is normalised to unit norm; entries agree to 1e-4 absolute.
    _cmp(jo, to)
    assert bool(to[1].ok)


@pytest.mark.parametrize("fid", [1, 2, 3])
def test_ransac_essential(rng, fid):
    uv1, uv2, valid = _matches_2d(rng)
    kj, kt = _keys(9, fid)
    kw = dict(num_hypotheses=64, threshold_px=1.0, min_inliers=15)
    jo = jax.jit(lambda *a: j_rs.ransac_essential(kj, *a, FX, FY, CX, CY, **kw))(
        *_j(uv1, uv2, valid))
    with t_la.f32_matmuls():
        to = t_rs.ransac_essential(kt, *_t(uv1, uv2, valid), FX, FY, CX, CY, **kw)
    assert bool(to[3].ok) and bool(jo[3].ok)
    np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), atol=2e-3)
    np.testing.assert_allclose(to[1].numpy(), np.asarray(jo[1]), atol=2e-2)
    nj, nt = int(jo[3].num_inliers), int(to[3].num_inliers)
    assert abs(nt - nj) <= 0.05 * nj
    few = np.zeros_like(valid)
    few[:5] = True
    jo = jax.jit(lambda *a: j_rs.ransac_essential(kj, *a, FX, FY, CX, CY, **kw))(
        *_j(uv1, uv2, few))
    with t_la.f32_matmuls():
        to = t_rs.ransac_essential(kt, *_t(uv1, uv2, few), FX, FY, CX, CY, **kw)
    assert bool(to[3].ok) == bool(jo[3].ok) is False
