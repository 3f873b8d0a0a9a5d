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
from vslam_tpu_torch.ops import graphs as t_graphs
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


@pytest.mark.parametrize("cap", [0.2, 0.5])
def test_ransac_kabsch_3d3d_tensor_cap(rng, cap):
    """A 0-d tensor cap, as the tracking step derives it from the keyframe
    gap: matches 0.38 m apart fail under 0.2 m and pass under 0.5 m, with
    JAX's results either way."""
    src, dst, valid = _matches_3d(rng)
    dst = dst + np.array([0.3, 0.1, 0.1], np.float32)
    kj, kt = _keys(42, 4)
    kw = dict(num_hypotheses=128, inlier_thresh=0.05, min_translation=1e-4, min_inliers=10)
    jo = jax.jit(lambda *a: j_rs.ransac_kabsch_3d3d(kj, *a, max_translation=jnp.float32(cap),
                                                    **kw))(*_j(src, dst, valid))
    with t_la.f32_matmuls():
        to = t_rs.ransac_kabsch_3d3d(kt, *_t(src, dst, valid),
                                     max_translation=torch.tensor(cap), **kw)
    _cmp(jo, to)
    assert bool(to[2].ok) == (cap > 0.38)


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
    # The refit over all inliers sums a long axis in torch's order (t 8.9e-6,
    # R 9.6e-5 measured); the inlier decisions are equal.
    np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), atol=1e-5)
    np.testing.assert_allclose(to[1].numpy(), np.asarray(jo[1]), atol=1.2e-4)
    np.testing.assert_array_equal(to[3].inlier_mask.numpy(), np.asarray(jo[3].inlier_mask))
    few = np.zeros_like(valid)
    few[:5] = True
    jo = jax.jit(lambda *a: j_rs.ransac_essential(kj, *a, FX, FY, CX, CY, **kw))(
        *_j(uv1, uv2, few))
    with t_la.f32_matmuls():
        to = t_rs.ransac_essential(kt, *_t(uv1, uv2, few), FX, FY, CX, CY, **kw)
    assert bool(to[3].ok) == bool(jo[3].ok) is False


@pytest.mark.parametrize("set_size", [3, 8])
@pytest.mark.parametrize("fid", [0, 5, 77])
def test_draw_split_equals_sample_minimal_sets(rng, fid, set_size):
    """The host draw and its device half give the minimal sets that
    `sample_minimal_sets` (and the JAX package) give."""
    valid = rng.random(400) > 0.4
    kj, kt = _keys(42, fid)
    want = np.asarray(j_rs.sample_minimal_sets(kj, jnp.asarray(valid), 256, set_size))
    u = t_rs.draw_minimal_sets(kt, 400, 256, set_size)
    assert u.device.type == "cpu" and u.dtype == torch.int64
    got = t_rs.minimal_sets_from_draw(u, torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        t_rs.sample_minimal_sets(kt, torch.from_numpy(valid), 256, set_size).numpy(), want)


@pytest.mark.parametrize("which", ["fundamental", "essential"])
def test_epipolar_ransac_on_cpu_captures_no_graph(rng, which):
    """CPU inputs take the eager code: no capture, no replay, nothing
    counted."""
    uv1, uv2, valid = _t(*_matches_2d(rng))
    _, kt = _keys(9, 1)
    t_graphs.reset_stats()
    with t_la.f32_matmuls():
        if which == "fundamental":
            t_rs.ransac_fundamental(kt, uv1, uv2, valid, num_hypotheses=32)
        else:
            t_rs.ransac_essential(kt, uv1, uv2, valid, FX, FY, CX, CY, num_hypotheses=32)
    assert t_graphs.STATS == {}
    assert not t_graphs._GRAPHS


def _graph_keys(monkeypatch, calls):
    """The graph key each of `calls` (ransac callables) would capture
    under, recorded from `graphs.call` as the tracking step calls it."""
    keys = []
    graph_call = t_graphs.call

    def recording_call(fn, statics, inputs):
        keys.append(t_graphs.graph_key(fn, statics, inputs))
        return graph_call(fn, statics, inputs)

    monkeypatch.setattr(t_graphs, "call", recording_call)
    for call in calls:
        call()
    return keys


@pytest.mark.parametrize("pair", [("fgate", "essential"), ("essential", "loop"),
                                  ("fgate", "loop"), ("fgate", "fgate"), ("loop", "loop")])
def test_graph_key_separates_the_callers(rng, monkeypatch, pair):
    """The F-gate, the essential fallback and the loop-closure check (its
    own `min_inliers`) each get a graph of their own; one caller called
    again, with other values, finds its own."""
    from vslam_tpu_torch.config import SlamConfig

    config = SlamConfig()
    mc = config.motion
    uv1, uv2, valid = _t(*_matches_2d(rng, n=64))
    _, kt = _keys(9, 2)
    calls = {
        "fgate": lambda: t_rs.ransac_fundamental(
            kt, uv1, uv2, valid, num_hypotheses=mc.fm_ransac_iters,
            threshold_px=mc.fm_ransac_threshold_px),
        "essential": lambda: t_rs.ransac_essential(
            kt, uv1, uv2, valid, FX, FY, CX, CY, num_hypotheses=mc.em_ransac_iters,
            threshold_px=mc.em_ransac_threshold_px, min_inliers=config.frontend.min_inliers),
        "loop": lambda: t_rs.ransac_essential(
            kt, uv1 + 1.0, uv2, ~valid, FX, FY, CX, CY, num_hypotheses=mc.em_ransac_iters,
            threshold_px=mc.em_ransac_threshold_px, min_inliers=config.loop.min_inliers),
    }
    assert config.loop.min_inliers != config.frontend.min_inliers
    with t_la.f32_matmuls():
        k1, k2 = _graph_keys(monkeypatch, [calls[p] for p in pair])
    assert (k1 == k2) == (pair[0] == pair[1])
