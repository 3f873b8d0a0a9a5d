"""Geometry ops of the port (`vslam_tpu_torch.ops`: se3, camera, linalg,
kabsch, epipolar, triangulate, scale, ekf with its RTS smoothers, pnp)
against the JAX package, on the same numpy inputs made from a seed.

Tolerance: f32, atol 1e-5 / rtol 1e-5 on direct formulas. The port runs
the same analytic and shift-and-invert algorithms, so the results differ
only by f32 rounding in another order of summation. Iterative solvers
(eigen/SVD, Gauss-Newton, nullspace iterations) amplify those roundings,
and are held at 1e-4. Integer and bool outputs (ok flags, inlier masks)
must be equal, degenerate batches included. The RTS smoothers: the
port's two forms against JAX's within 1e-5 m, and the doubling scan
against the sequential form within 3e-4 m, the reassociation allowance
of `tests/test_ekf.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vslam_tpu.ops import camera as j_cam
from vslam_tpu.ops import ekf as j_ekf
from vslam_tpu.ops import epipolar as j_epi
from vslam_tpu.ops import kabsch as j_kb
from vslam_tpu.ops import linalg as j_la
from vslam_tpu.ops import pnp as j_pnp
from vslam_tpu.ops import scale as j_scale
from vslam_tpu.ops import se3 as j_se3
from vslam_tpu.ops import triangulate as j_tri
from vslam_tpu_torch.ops import camera as t_cam
from vslam_tpu_torch.ops import device as t_device
from vslam_tpu_torch.ops import ekf as t_ekf
from vslam_tpu_torch.ops import epipolar as t_epi
from vslam_tpu_torch.ops import kabsch as t_kb
from vslam_tpu_torch.ops import linalg as t_la
from vslam_tpu_torch.ops import pnp as t_pnp
from vslam_tpu_torch.ops import prng
from vslam_tpu_torch.ops import scale as t_scale
from vslam_tpu_torch.ops import se3 as t_se3
from vslam_tpu_torch.ops import triangulate as t_tri

FX, FY, CX, CY = 525.0, 525.0, 319.5, 239.5


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)]


def check(jfn, tfn, *args, atol=1e-5, rtol=1e-5):
    """Run jfn on jnp and tfn on torch copies of the numpy `args` (floats
    as f32); compare every output leaf. Returns the torch outputs."""
    def conv(a, to):
        if isinstance(a, np.ndarray):
            a = a.astype(np.float32) if a.dtype.kind == "f" else a
            return to(a)
        return a

    with jax.default_matmul_precision("float32"):
        jout = jfn(*[conv(a, jnp.asarray) for a in args])
    with t_la.f32_matmuls():
        tout = tfn(*[conv(a, lambda v: torch.from_numpy(np.array(v))) for a in args])
    jl, tl = _leaves(jout), _leaves(tout)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=f"leaf {i}")
        else:
            np.testing.assert_allclose(b, a, atol=atol, rtol=rtol, err_msg=f"leaf {i}")
    return tout


def rand_rot(rng, n, max_angle=np.pi):
    w = rng.normal(size=(n, 3))
    w *= (rng.uniform(0, max_angle, (n, 1)) / np.linalg.norm(w, axis=-1, keepdims=True))
    return np.asarray(j_se3.exp_so3(jnp.asarray(w.astype(np.float32))))


def keys(seed, fid=3):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), fid),
            prng.fold_in(prng.prng_key(seed), fid))


# ---------------------------------------------------------------- se3


def test_so3_exp_log(rng):
    w = rng.normal(size=(64, 3))
    w[:8] *= 1e-3  # small-angle branch
    w[8:16] *= (3.1 / np.linalg.norm(w[8:16], axis=-1, keepdims=True))  # near pi
    R = check(j_se3.exp_so3, t_se3.exp_so3, w)
    check(j_se3.log_so3, t_se3.log_so3, R.numpy(), atol=1e-4, rtol=1e-4)
    check(j_se3.hat, t_se3.hat, w)


def test_se3_compose_inverse_transform(rng):
    Ra, Rb = rand_rot(rng, 16), rand_rot(rng, 16)
    ta, tb = rng.normal(size=(16, 3)), rng.normal(size=(16, 3))
    pts = rng.normal(size=(16, 50, 3))
    check(j_se3.compose, t_se3.compose, Ra, ta, Rb, tb)
    check(j_se3.inverse, t_se3.inverse, Ra, ta)
    check(j_se3.relative, t_se3.relative, Ra, ta, Rb, tb)
    check(j_se3.rotate_rows, t_se3.rotate_rows, Ra, pts)
    check(j_se3.transform_points, t_se3.transform_points, Ra, ta, pts)


def test_se3_exp_log(rng):
    """exp_se3 / log_se3 against JAX on both sides of the series window
    (theta^2 = 1e-3) and near pi; log o exp is the identity below pi."""
    xi = rng.normal(size=(64, 6))
    xi[:8, 3:] *= 1e-3
    xi[8:16, 3:] *= 0.0
    xi[16:24, 3:] *= 3.0 / np.linalg.norm(xi[16:24, 3:], axis=-1, keepdims=True)
    R, t = check(j_se3.exp_se3, t_se3.exp_se3, xi)
    out = check(j_se3.log_se3, t_se3.log_se3, R.numpy(), t.numpy(), atol=1e-4, rtol=1e-4)
    inside = np.linalg.norm(xi[:, 3:], axis=-1) < 3.05
    np.testing.assert_allclose(out.numpy()[inside], xi.astype(np.float32)[inside], atol=1e-4)


def test_se3_jacobians_under_torch_func(rng):
    """The PGO solvers differentiate exp_se3 / log_se3 with
    `torch.func.vmap(torch.func.jacrev(...))` at xi = 0: the Jacobians are
    finite and equal JAX's `vmap(jacrev(...))` within 1e-4."""
    Ra, Rb = rand_rot(rng, 12, 0.5).copy(), rand_rot(rng, 12, 0.5)
    ta, tb = rng.normal(size=(12, 3)), rng.normal(size=(12, 3))
    Ra[:4] = Rb[:4]  # identity relative rotation: the small-angle branch

    def f(mod, lib):
        def res(xi, Ra, ta, Rb, tb):
            dR, dt = mod.exp_se3(xi)
            R2 = dR @ Ra
            t2 = (dR @ ta[..., None])[..., 0] + dt
            return mod.log_se3(*mod.relative(R2, t2, Rb, tb))
        return res

    xi0 = np.zeros((12, 6), np.float32)
    args = [a.astype(np.float32) for a in (xi0, Ra, ta, Rb, tb)]
    with jax.default_matmul_precision("float32"):
        jj = np.asarray(jax.vmap(jax.jacrev(f(j_se3, jnp)))(*map(jnp.asarray, args)))
    with t_la.f32_matmuls():
        tj = torch.func.vmap(torch.func.jacrev(f(t_se3, torch)))(
            *(torch.from_numpy(a) for a in args)).numpy()
    assert np.isfinite(tj).all()
    np.testing.assert_allclose(tj, jj, atol=1e-4, rtol=1e-4)


def _half_turns(rng, n):
    """Rotations within 1e-3 rad of a half-turn about random axes."""
    w = rng.normal(size=(n, 3))
    w *= (np.pi - 1e-3) / np.linalg.norm(w, axis=-1, keepdims=True)
    return np.asarray(j_se3.exp_so3(jnp.asarray(w.astype(np.float32))))


def test_quaternions(rng):
    """Shepperd's conversion on random rotations, the four branch
    extremes (identity and the three half-turns) and near-half-turns,
    then back to matrices."""
    R = np.concatenate([rand_rot(rng, 64),
                        np.stack([np.diag(d) for d in ([1, 1, 1], [1, -1, -1], [-1, 1, -1],
                                                       [-1, -1, 1])]).astype(np.float32),
                        _half_turns(rng, 16)])
    q = check(j_se3.quat_from_matrix, t_se3.quat_from_matrix, R, atol=1e-6, rtol=0)
    assert (q[:, 3] >= 0).all()
    check(j_se3.matrix_from_quat, t_se3.matrix_from_quat, q.numpy(), atol=1e-6, rtol=0)
    check(j_se3.matrix_from_quat, t_se3.matrix_from_quat,
          rng.normal(size=(20, 4)).astype(np.float32), atol=1e-6, rtol=0)


def test_renormalize_rotation(rng):
    R = rand_rot(rng, 32) + rng.normal(0, 1e-3, (32, 3, 3))
    check(j_se3.renormalize_rotation, t_se3.renormalize_rotation, R, atol=1e-5)
    check(j_se3.orthonormalize, t_se3.orthonormalize, R, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- camera


def test_camera(rng):
    pts = rng.normal(size=(200, 3)) + np.array([0, 0, 2.0])
    pts[:10, 2] = -0.5  # behind the camera
    uv, _ = check(lambda p: j_cam.project(p, FX, FY, CX, CY),
                  lambda p: t_cam.project(p, FX, FY, CX, CY), pts, atol=1e-3)
    depth = rng.uniform(0.3, 5.0, 200)
    check(lambda u, d: j_cam.backproject(u, d, FX, FY, CX, CY),
          lambda u, d: t_cam.backproject(u, d, FX, FY, CX, CY), uv.numpy(), depth)
    check(lambda u: j_cam.normalize_pixels(u, FX, FY, CX, CY),
          lambda u: t_cam.normalize_pixels(u, FX, FY, CX, CY), uv.numpy())
    check(lambda u: j_cam.in_image(u, 640, 480), lambda u: t_cam.in_image(u, 640, 480),
          uv.numpy())


@pytest.mark.parametrize("chan", [False, True])
def test_bilinear_and_nearest_sample(rng, chan):
    """Pixels inside, on the last row/column and outside (clamped, or
    zeroed through `valid`); the batched form against `jax.vmap`."""
    img = rng.normal(size=(4, 9, 13) + ((3,) if chan else ())).astype(np.float32)
    uv = rng.uniform([-3, -3], [16, 12], (4, 50, 2)).astype(np.float32)
    uv[:, :4] = [[12.0, 8.0], [12.0, 0.0], [0.0, 8.0], [11.5, 7.5]]
    valid = rng.random((4, 50)) > 0.3
    check(j_cam.bilinear_sample, t_cam.bilinear_sample, img[0], uv[0])
    check(j_cam.bilinear_sample, t_cam.bilinear_sample, img[1], uv[1], valid[1])
    check(jax.vmap(j_cam.bilinear_sample), t_cam.bilinear_sample_batched, img, uv)
    check(jax.vmap(j_cam.bilinear_sample), t_cam.bilinear_sample_batched, img, uv, valid)
    uv[0, 4:8] = [[2.5, 1.5], [3.5, 0.5], [-0.5, 4.5], [12.5, 8.5]]  # halves round to even
    check(j_cam.nearest_sample, t_cam.nearest_sample, img[0], uv[0], atol=0, rtol=0)


# ---------------------------------------------------------------- linalg


def _spd(rng, b, n, cond=1e3):
    Q = np.linalg.qr(rng.normal(size=(b, n, n)))[0]
    ev = np.exp(rng.uniform(0, np.log(cond), (b, n)))
    return Q @ (ev[..., None] * np.swapaxes(Q, -1, -2))


def test_linalg_3x3(rng):
    A = rng.normal(size=(32, 3, 3))
    S = _spd(rng, 32, 3)
    check(jnp.linalg.det, t_la.det3, A, atol=1e-4)
    check(j_la.eigh3x3, t_la.eigh3x3, S, atol=1e-4, rtol=1e-4)
    check(j_la.svd3x3, t_la.svd3x3, A, atol=1e-4, rtol=1e-4)
    check(j_la.polar3x3, t_la.polar3x3, A, atol=1e-4, rtol=1e-4)
    check(j_la.polar_newton3x3, t_la.polar_newton3x3, rand_rot(rng, 32) + 0.01 * A,
          atol=1e-5)


@pytest.mark.parametrize("n", [4, 6, 9])
def test_linalg_small(rng, n):
    S = _spd(rng, 16, n)
    g = rng.normal(size=(16, n))
    check(j_la.eigh_small, t_la.eigh_small, S, atol=1e-4, rtol=1e-4)
    check(j_la.smallest_eigvec_psd, t_la.smallest_eigvec_psd, S, atol=1e-4, rtol=1e-4)
    check(j_la.inv_spd_small, t_la.inv_spd_small, S, atol=1e-4, rtol=1e-4)
    check(j_la.cholesky_solve_small, t_la.cholesky_solve_small, S, g, atol=1e-4, rtol=1e-4)


def test_svd4x4_nullvec(rng):
    X = np.concatenate([rng.normal(size=(16, 3, 3)), np.ones((16, 3, 1))], -1)
    A = np.concatenate([X, rng.normal(0, 1e-3, (16, 1, 4))], 1)
    check(j_la.svd4x4_nullvec, t_la.svd4x4_nullvec, A, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- kabsch


def test_kabsch(rng):
    R = rand_rot(rng, 8)
    t = rng.normal(size=(8, 3))
    src = rng.normal(size=(8, 40, 3))
    dst = np.einsum("bij,bnj->bni", R, src) + t[:, None] + rng.normal(0, 1e-3, (8, 40, 3))
    w = (rng.random((8, 40)) > 0.2).astype(np.float32)
    w[0] = 0.0  # degenerate: no support
    check(j_kb.kabsch, t_kb.kabsch, src, dst, w, atol=1e-4, rtol=1e-4)
    check(lambda *a: j_kb.kabsch(*a, with_scale=True),
          lambda *a: t_kb.kabsch(*a, with_scale=True), src, dst * 1.3, w, atol=1e-4, rtol=1e-4)
    check(j_kb.rigid_residuals, t_kb.rigid_residuals, R, t, src, dst)


# ---------------------------------------------------------------- epipolar


def _two_views(rng, n=120, noise=0.3):
    X = rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 5.0])
    R = rand_rot(rng, 1, 0.1)[0]
    t = np.array([0.3, 0.05, 0.02])
    uv1 = np.stack([FX * X[:, 0] / X[:, 2] + CX, FY * X[:, 1] / X[:, 2] + CY], -1)
    X2 = X @ R.T + t
    uv2 = np.stack([FX * X2[:, 0] / X2[:, 2] + CX, FY * X2[:, 1] / X2[:, 2] + CY], -1)
    return uv1 + rng.normal(0, noise, uv1.shape), uv2 + rng.normal(0, noise, uv2.shape), R, t


def test_eight_point_and_distances(rng):
    uv1, uv2, _, _ = _two_views(rng)
    w = (rng.random(len(uv1)) > 0.1).astype(np.float32)
    F = check(lambda a, b, c: j_epi.eight_point(a, b, weights=c, nullvec_iters=10),
              lambda a, b, c: t_epi.eight_point(a, b, weights=c, nullvec_iters=10),
              uv1, uv2, w, atol=1e-4, rtol=1e-3)
    check(j_epi.epipolar_distance, t_epi.epipolar_distance, F.numpy(), uv1, uv2,
          atol=1e-4, rtol=1e-4)
    check(j_epi.sampson_distance, t_epi.sampson_distance, F.numpy(), uv1, uv2,
          atol=1e-4, rtol=1e-4)
    # Degenerate: no weight at all.
    check(lambda a, b, c: j_epi.eight_point(a, b, weights=c),
          lambda a, b, c: t_epi.eight_point(a, b, weights=c),
          uv1, uv2, np.zeros_like(w), atol=1e-4, rtol=1e-3)


def test_essential_pose_recovery(rng):
    uv1, uv2, _, _ = _two_views(rng, noise=0.1)
    xn1 = np.asarray(j_cam.normalize_pixels(jnp.asarray(uv1, jnp.float32), FX, FY, CX, CY))
    xn2 = np.asarray(j_cam.normalize_pixels(jnp.asarray(uv2, jnp.float32), FX, FY, CX, CY))
    E = check(lambda a, b: j_epi.eight_point(a, b, essential=True, nullvec_iters=10),
              lambda a, b: t_epi.eight_point(a, b, essential=True, nullvec_iters=10),
              xn1, xn2, atol=1e-4, rtol=1e-3)
    check(j_epi.decompose_essential, t_epi.decompose_essential, E.numpy(), atol=1e-4, rtol=1e-4)
    mask = rng.random(len(uv1)) > 0.05
    R, t, _, _ = check(
        lambda e, a, b, m: j_epi.recover_pose(e, a, b, FX, FY, CX, CY, mask=m),
        lambda e, a, b, m: t_epi.recover_pose(e, a, b, FX, FY, CX, CY, mask=m),
        E.numpy(), uv1, uv2, mask, atol=1e-4, rtol=1e-4,
    )
    check(lambda *a: j_epi.refine_pose_sampson(*a, iters=8),
          lambda *a: t_epi.refine_pose_sampson(*a, iters=8),
          R.numpy(), t.numpy(), xn1, xn2, mask.astype(np.float32), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- triangulate, scale


def test_triangulate_two_view(rng):
    uv1, uv2, R, t = _two_views(rng, noise=0.2)
    # Camera-to-world poses: view 1 at identity, view 2 = inverse(R, t).
    R2, t2 = R.T, -R.T @ t
    check(
        lambda *a: j_tri.triangulate_two_view(*a, FX, FY, CX, CY),
        lambda *a: t_tri.triangulate_two_view(*a, FX, FY, CX, CY),
        np.eye(3), np.zeros(3), R2, t2, uv1, uv2, atol=1e-3, rtol=1e-4,
    )


def test_two_view_scale(rng):
    R = rand_rot(rng, 1, 0.1)[0]
    t = np.array([0.2, 0.0, 0.05])
    p1 = rng.uniform(-1, 1, (80, 3)) + np.array([0, 0, 3.0])
    p2 = p1 @ R.T + t + rng.normal(0, 2e-3, (80, 3))
    valid = rng.random(80) > 0.2
    t_unit = t / np.linalg.norm(t)
    check(lambda *a: j_scale.two_view_scale(*a, min_matches=10),
          lambda *a: t_scale.two_view_scale(*a, min_matches=10),
          R, t_unit, p1, p2, valid, atol=1e-5)
    check(lambda *a: j_scale.two_view_scale(*a, min_matches=10),
          lambda *a: t_scale.two_view_scale(*a, min_matches=10),
          R, t_unit, p1, p2, np.zeros(80, bool), atol=1e-5)


def test_two_view_scale_reads_nothing_back(rng):
    """The scale's quantiles select by a device index, with no read back
    to the host (on the card each read waits for the stream; the stress
    world's dropout takes this path 19 times)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    reads = []

    class CountReads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket.__name__ in ("_local_scalar_dense", "nonzero"):
                reads.append(func)
            return func(*args, **(kwargs or {}))

    p1 = torch.from_numpy(rng.uniform(-1, 1, (40, 3)).astype(np.float32) + 3.0)
    p2 = p1 + torch.tensor([0.2, 0.0, 0.05])
    with CountReads():
        t_scale.two_view_scale(torch.eye(3), torch.tensor([1.0, 0.0, 0.0]), p1, p2,
                               torch.ones(40, dtype=torch.bool))
    assert reads == []


# ---------------------------------------------------------------- ekf


def test_ekf_step(rng):
    pos = rng.normal(size=3)

    def run(mod, to):
        st = mod.initialize(to(pos.astype(np.float32)), to(np.float32(0.5)))
        outs = []
        for i, (dt, z) in enumerate(zip([0.0, 0.033, 0.05, 2.0], rng_z)):
            st = mod.predict(st, to(np.float32(dt)), sigma_a=1.0, decay=0.95)
            st = mod.update_visual_gated(st, to(z), to(np.float32(0.02)), gate=0.3,
                                         enabled=to(np.bool_(i != 2)))
            st = mod.update_height(st, to(np.array([0, -1, 0], np.float32)),
                                   to(np.float32(0.1)), 0.05, enabled=to(np.bool_(True)))
            st, fused = mod.clamp_step(st, to(pos.astype(np.float32)), to(np.float32(dt)),
                                       max_step=0.1)
            outs.append((st, fused))
        return outs

    rng_z = (pos + rng.normal(0, 0.1, (4, 3))).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        jo = run(j_ekf, jnp.asarray)
    with t_la.f32_matmuls():
        to_ = run(t_ekf, lambda a: torch.from_numpy(np.array(a)))
    for a, b in zip(_leaves(jo), _leaves(to_)):
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- pnp


def _pnp_problem(rng, n=150, outliers=0.2):
    R_wc = rand_rot(rng, 1, 0.2)[0]
    t_wc = np.array([0.1, -0.05, 0.2])
    X = rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 5.0])
    R_cw, t_cw = R_wc.T, -R_wc.T @ t_wc
    Xc = X @ R_cw.T + t_cw
    uv = np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX, FY * Xc[:, 1] / Xc[:, 2] + CY], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    bad = rng.random(n) < outliers
    uv[bad] += rng.uniform(-80, 80, (bad.sum(), 2))
    return X, uv, R_cw, t_cw


def test_gn_refine_pose(rng):
    X, uv, R_cw, t_cw = _pnp_problem(rng)
    w = (rng.random(len(X)) > 0.1).astype(np.float32)
    R0 = rand_rot(rng, 1, 0.02)[0] @ R_cw
    check(lambda *a: j_pnp.gn_refine_pose(*a, FX, FY, CX, CY, iters=10, huber_px=4.0),
          lambda *a: t_pnp.gn_refine_pose(*a, FX, FY, CX, CY, iters=10, huber_px=4.0),
          R0, t_cw + 0.02, X, uv, w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_pnp(rng, seed):
    """The port's PnP RANSAC against JAX's under `jax.jit` with the key and
    intrinsics closed over, as the tracker runs it (XLA then multiplies by
    the reciprocal of fx and fy; eager JAX divides).

    Degenerate case: with 3 valid points every 6-point minimal set repeats
    points and the DLT is rank deficient; both refuse, with the same mask
    and count, and the poses they return agree within 1e-3."""
    X, uv, _, _ = _pnp_problem(rng)
    valid = rng.random(len(X)) > 0.1
    kj, kt = keys(seed)
    jfn = jax.jit(lambda x, u, v: j_pnp.ransac_pnp(kj, x, u, v, FX, FY, CX, CY, num_hypotheses=64))
    out = check(
        jfn,
        lambda x, u, v: t_pnp.ransac_pnp(kt, x, u, v, FX, FY, CX, CY, num_hypotheses=64),
        X, uv, valid, atol=1e-4, rtol=1e-4,
    )
    assert bool(out.ok)
    # Degenerate: too few valid correspondences -> both refuse.
    few = np.zeros(len(X), bool)
    few[:3] = True
    out = check(
        jfn,
        lambda x, u, v: t_pnp.ransac_pnp(kt, x, u, v, FX, FY, CX, CY, num_hypotheses=64),
        X, uv, few, atol=1e-3, rtol=1e-3,
    )
    assert not bool(out.ok) and int(out.num_inliers) == 0


def _ekf_snapshots(rng, n):
    """Snapshots of a real filter run (predict + gated update per frame,
    with dt = 0 frames that skip the predict), as numpy (N, ...) leaves."""
    @jax.jit
    def step(st, dt, z):
        pred = j_ekf.predict(st, dt)
        return pred, j_ekf.update_visual_gated(pred, z, 0.02)

    st = j_ekf.initialize(jnp.zeros(3), 0.0)
    rows = []
    pos = np.zeros(3)
    for k in range(n):
        dt = np.float32(0.0 if k % 9 == 4 else 0.1)
        pos = pos + rng.normal(0, 0.02, 3)
        pred, st = step(st, dt, jnp.asarray(pos, jnp.float32))
        rows.append((pred.x, pred.P, st.x, st.P, dt))
    x_pred, P_pred, x_filt, P_filt, dt = (np.stack([np.asarray(r[i]) for r in rows])
                                          for i in range(5))
    return x_pred, P_pred, x_filt, P_filt, dt, np.arange(n, dtype=np.int32)


@pytest.mark.parametrize("n", [1, 2, 129])
def test_rts_smoothers(rng, n):
    """Both RTS forms against JAX's on a filter run with invalid frames
    (and N = 1, which returns the filtered positions); the doubling scan
    against the sequential form."""
    snaps = _ekf_snapshots(rng, n)
    valid = rng.random(n) > 0.25
    jsn = j_ekf.EKFSnapshot(*map(jnp.asarray, snaps))
    tsn = t_ekf.EKFSnapshot(*(torch.from_numpy(a) for a in snaps))
    with jax.default_matmul_precision("float32"):
        j_seq = np.asarray(j_ekf.rts_smooth(jsn, jnp.asarray(valid)))
        j_par = np.asarray(j_ekf.rts_smooth_assoc(jsn, jnp.asarray(valid)))
    with t_la.f32_matmuls():
        t_seq = t_ekf.rts_smooth(tsn, torch.from_numpy(valid)).numpy()
        t_par = t_ekf.rts_smooth_assoc(tsn, torch.from_numpy(valid)).numpy()
    assert t_seq.shape == t_par.shape == (n, 3)
    np.testing.assert_allclose(t_seq, j_seq, atol=1e-5)
    np.testing.assert_allclose(t_par, j_par, atol=1e-5)
    np.testing.assert_allclose(t_par, t_seq, atol=3e-4)
    # Invalid frames keep their filtered position in both forms.
    keep = ~valid
    keep[-1] = True
    np.testing.assert_array_equal(t_seq[keep], snaps[2][keep, :3])
    np.testing.assert_allclose(t_par[keep], snaps[2][keep, :3], atol=1e-6)


def test_suffix_compose_is_the_backward_recursion(rng):
    """The doubling scan's entry k equals map_k o ... o map_{n-1} composed
    one at a time, for lengths that are not powers of two."""
    for n in (1, 3, 5, 33):
        A = rng.normal(0, 0.4, (n, 6, 6))
        a = rng.normal(size=(n, 6))
        A_cum, a_cum = t_ekf.suffix_compose(torch.from_numpy(A), torch.from_numpy(a))
        MA, ma = np.eye(6), np.zeros(6)
        for k in range(n - 1, -1, -1):
            MA, ma = A[k] @ MA, a[k] + A[k] @ ma
            np.testing.assert_allclose(A_cum[k].numpy(), MA, atol=1e-10)
            np.testing.assert_allclose(a_cum[k].numpy(), ma, atol=1e-10)


# ------------------------------------------- division by a config constant
#
# Under `jax.jit` with the configuration closed over, XLA rewrites
# `x / c` for a constant c into `x * (1 / c)`, the reciprocal folded in
# f32. Each case runs the JAX function jitted with its constants closed
# over (as `tracking_step` and `run_coupled` run it) and the port's
# function on the same inputs on the CPU, and asserts bitwise equality.
# Inputs: 1e5 values from a seed plus every pixel of the tiny world
# (160x120, fx = fy = 120, cx 79.5, cy 59.5; `config.tiny_test_config`).

TINY = dict(fx=120.0, fy=120.0, cx=79.5, cy=59.5)
DEPTH_SCALE = 5000.0


def _pixels(rng, n=100_000, width=160, height=120):
    vv, uu = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    grid = np.stack([uu, vv], -1).reshape(-1, 2).astype(np.float32)
    rand = rng.uniform(0, [width, height], (n, 2)).astype(np.float32)
    return np.concatenate([grid, rand])


def _site_backproject(rng):
    uv = _pixels(rng)
    d = rng.uniform(0.1, 8.0, len(uv)).astype(np.float32)
    for cam in (TINY, dict(fx=FX, fy=FY, cx=CX, cy=CY)):
        yield (jax.jit(lambda a, b, c=cam: j_cam.backproject(a, b, **c))(uv, d),
               t_cam.backproject(torch.from_numpy(uv), torch.from_numpy(d), **cam))


def _site_normalize_pixels(rng):
    uv = _pixels(rng)
    for cam in (TINY, dict(fx=FX, fy=FY, cx=CX, cy=CY)):
        yield (jax.jit(lambda a, c=cam: j_cam.normalize_pixels(a, **c))(uv),
               t_cam.normalize_pixels(torch.from_numpy(uv), **cam))


def _site_essential_to_pixel_f(rng):
    """`ransac.py:111`: the entries of K^-1 (`1 / fx`, `-cx / fx`). Both
    packages take them as Python's f64 quotients rounded to f32, so XLA
    has no division to rewrite here. E = e_20 makes F's last row K^-1's
    first row over its norm with no rounding in the products; the second
    row's values go through the first by swapping the axes. At (525,
    239.5) XLA's norm sums with an FMA (1 ulp from a plain sum: F's
    normalisation, not a constant division), so that row is held through
    the port's `k_inverse` against the JAX function's own expression."""
    from vslam_tpu.ops import ransac as j_ransac
    from vslam_tpu_torch.ops import ransac as t_ransac

    E = np.zeros((1, 3, 3), np.float32)
    E[0, 2, 0] = 1.0
    for f, c in ((120.0, 79.5), (120.0, 59.5), (FX, CX)):
        cam = dict(fx=f, fy=f, cx=c, cy=c)
        yield (jax.jit(lambda e, c=cam: j_ransac._E_to_pixel_F(e, **c))(E),
               t_ransac._E_to_pixel_F(torch.from_numpy(E), **cam))
    for cam in (TINY, dict(fx=FX, fy=FY, cx=CX, cy=CY)):
        fx, fy, cx, cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
        want = jnp.array(  # `vslam_tpu/ops/ransac.py:195-198`
            [[1.0 / fx, 0.0, -cx / fx], [0.0, 1.0 / fy, -cy / fy], [0.0, 0.0, 1.0]],
            dtype=jnp.float32)
        yield want, t_ransac.k_inverse(fx, fy, cx, cy, torch.float32, "cpu")


def _site_depth_scale(rng):
    """`vslam_tpu/core/coupled.py:111,156,216,241`: integer depth / scale."""
    from vslam_tpu_torch.core import frontend as t_front

    d = np.concatenate([np.arange(65536), rng.integers(0, 65536, 100_000)]).astype(np.uint16)
    want = jax.jit(lambda a: a.astype(jnp.float32) / DEPTH_SCALE)(d)
    yield want, t_front.depth_meters(torch.from_numpy(d.astype(np.int32)), DEPTH_SCALE)


def _site_unit_gray(rng):
    """`vslam_tpu/core/coupled.py:45`, `models/depthnet.py:106`: gray / 255."""
    g = np.concatenate([np.arange(256), rng.integers(0, 256, 100_000)]).astype(np.uint8)
    want = jax.jit(lambda a: a.astype(jnp.float32) / 255.0)(g)
    yield want, t_cam.unit_gray(torch.from_numpy(g))


def _site_voxel_coords(rng):
    from vslam_tpu.ops import gridhash as j_gh
    from vslam_tpu_torch.ops import gridhash as t_gh

    p = rng.uniform(-6.0, 6.0, (100_000, 3)).astype(np.float32)
    p[:1000] = np.round(p[:1000] / 0.02) * np.float32(0.02)  # on voxel faces
    for vs in (0.02, 0.05):
        yield (jax.jit(lambda a, v=vs: j_gh.voxel_coords(a, v))(p),
               t_gh.voxel_coords(torch.from_numpy(p), vs))


def _site_backproject_frame(rng):
    """At the identity pose, so the rotation's products add no rounding."""
    from vslam_tpu.ops import gridhash as j_gh
    from vslam_tpu_torch.ops import gridhash as t_gh

    depth = rng.uniform(0.05, 6.0, (8, 120, 160)).astype(np.float32)
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    for d in depth:
        want = jax.jit(lambda a: j_gh.backproject_frame(
            a, None, R, t, pixel_step=1, **TINY))(d)
        got = t_gh.backproject_frame(torch.from_numpy(d), None, torch.from_numpy(R),
                                     torch.from_numpy(t), pixel_step=1, **TINY)
        yield want, got


DIVISION_SITES = {
    "camera.backproject": _site_backproject,
    "camera.normalize_pixels": _site_normalize_pixels,
    "ransac._E_to_pixel_F": _site_essential_to_pixel_f,
    "frontend.depth_meters": _site_depth_scale,
    "camera.unit_gray": _site_unit_gray,
    "gridhash.voxel_coords": _site_voxel_coords,
    "gridhash.backproject_frame": _site_backproject_frame,
}


@pytest.mark.parametrize("site", sorted(DIVISION_SITES))
def test_constant_division_rounds_as_jit(site):
    """Bitwise: the port's CPU result equals the jitted JAX function's."""
    rng = np.random.default_rng(7)
    for want, got in DIVISION_SITES[site](rng):
        jl, tl = _leaves(want), _leaves(got)
        assert len(jl) == len(tl)
        for i, (a, b) in enumerate(zip(jl, tl)):
            assert a.shape == b.shape and a.dtype == b.dtype, (i, a.dtype, b.dtype)
            np.testing.assert_array_equal(b, a, err_msg=f"{site} leaf {i}")


# ------------------------------------------------------- small functions


def test_denormalize_inverts_normalize(rng):
    xn = rng.normal(size=(500, 2))
    out = check(lambda a: j_cam.denormalize(a, FX, FY, CX, CY),
                lambda a: t_cam.denormalize(a, FX, FY, CX, CY), xn)
    back = t_cam.normalize_pixels(out, FX, FY, CX, CY)
    np.testing.assert_allclose(back.numpy(), xn.astype(np.float32), atol=1e-5)


@pytest.mark.parametrize("batch", [(), (4,), (2, 3)])
def test_identity_pose(batch):
    Rj, tj = j_se3.identity_pose(batch=batch)
    Rt, tt = t_se3.identity_pose(batch=batch)
    np.testing.assert_array_equal(Rt.numpy(), np.asarray(Rj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    assert Rt.dtype == torch.float32 and Rt.is_contiguous()


def test_essential_from_fundamental(rng):
    F = rng.normal(size=(16, 3, 3))
    check(lambda f: j_epi.essential_from_fundamental(f, FX, FY, CX, CY),
          lambda f: t_epi.essential_from_fundamental(f, FX, FY, CX, CY), F,
          atol=1e-5, rtol=1e-5)


# ------------------------------------------- minimal solves as XLA rounds them
#
# XLA's CPU code contracts a product into the add or subtract that consumes
# it (one rounding), sums a short axis in its own fixed order and calls
# glibc's cosf / sinf / atan2f. Each stage below runs jitted in JAX and in
# the port on the same 1e4 inputs (random 3x3 matrices, some near
# singular; 3-point Kabsch sets and 8-point epipolar sets with 10% zero
# weights; 6-point DLT sets), held bit for bit.

B_STAGE = 10_000


def _mats(rng, n=3):
    A = rng.normal(size=(B_STAGE, n, n)).astype(np.float32)
    A[::7, n - 1] = A[::7, 0] + 1e-4 * A[::7, 1]  # near-singular rows
    return A


def _stage_fma(rng):
    a, b, c = (rng.normal(size=B_STAGE).astype(np.float32) * 10 for _ in range(3))
    return (jax.jit(lambda x, y, z: x * y + z)(a, b, c),
            t_device.fma(*(torch.from_numpy(v) for v in (a, b, c))))


def _stage_det3(rng):
    A = _mats(rng)
    return jax.jit(jnp.linalg.det)(A), t_la.det3(torch.from_numpy(A))


def _kabsch_sets(rng):
    src = rng.normal(size=(B_STAGE, 3, 3)).astype(np.float32) * 2
    dst = (src + rng.normal(size=src.shape) * 0.1).astype(np.float32)
    w = (rng.random((B_STAGE, 3)) > 0.1).astype(np.float32)
    return src, dst, w


def _stage_kabsch_moments(rng):
    """The weighted means and H, `vslam_tpu/ops/kabsch.py`'s lines."""
    def jfn(src, dst, weights):
        w = weights / jnp.maximum(jnp.sum(weights, axis=-1, keepdims=True), 1e-9)
        mu_src = jnp.sum(src * w[..., None], axis=-2)
        mu_dst = jnp.sum(dst * w[..., None], axis=-2)
        sc, dc = src - mu_src[..., None, :], dst - mu_dst[..., None, :]
        return mu_src, mu_dst, jnp.einsum("...ni,...nj->...ij", dc * w[..., None], sc)

    src, dst, w = _kabsch_sets(rng)
    tw = torch.from_numpy(w)
    tw = tw / torch.clamp(torch.sum(tw, dim=-1, keepdim=True), min=1e-9)
    mu_s, mu_d, _, H = t_kb.moments(torch.from_numpy(src), torch.from_numpy(dst), tw)
    return jax.jit(jfn)(src, dst, w), (mu_s, mu_d, H)


def _stage_kabsch(rng):
    src, dst, w = _kabsch_sets(rng)
    return (jax.jit(j_kb.kabsch)(src, dst, w)[:2],
            t_kb.kabsch(*(torch.from_numpy(v) for v in (src, dst, w)))[:2])


def _stage_svd3x3(rng):
    A = _mats(rng)
    return jax.jit(j_la.svd3x3)(A), t_la.svd3x3(torch.from_numpy(A))


def _stage_eigh3x3(rng):
    A = _mats(rng)
    S = np.einsum("bji,bjk->bik", A, A).astype(np.float32)
    return jax.jit(j_la.eigh3x3)(S), t_la.eigh3x3(torch.from_numpy(S))


def _stage_hartley(rng):
    uv = rng.uniform(0, 640, size=(B_STAGE, 8, 2)).astype(np.float32)
    w = (rng.random((B_STAGE, 8)) > 0.1).astype(np.float32)
    return (jax.jit(j_epi._hartley_normalize)(uv, w),
            t_epi._hartley_normalize(torch.from_numpy(uv), torch.from_numpy(w)))


def _stage_eight_point(rng):
    uv1 = rng.uniform(0, 640, size=(B_STAGE, 8, 2)).astype(np.float32)
    uv2 = (uv1 + rng.normal(size=uv1.shape) * 5).astype(np.float32)
    x1, x2 = uv1 / 500, uv2 / 500
    want = (jax.jit(j_epi.eight_point)(uv1, uv2),
            jax.jit(lambda a, b: j_epi.eight_point(a, b, essential=True))(x1, x2))
    got = (t_epi.eight_point(torch.from_numpy(uv1), torch.from_numpy(uv2)),
           t_epi.eight_point(torch.from_numpy(x1), torch.from_numpy(x2), essential=True))
    return want, got


def _dlt_sets(rng):
    X = (rng.normal(size=(B_STAGE, 6, 3)) * 2 + [0, 0, 6]).astype(np.float32)
    xn = (X[..., :2] / X[..., 2:3] + rng.normal(size=(B_STAGE, 6, 2)) * 1e-3).astype(np.float32)
    return X, xn


def _stage_dlt_build(rng):
    """The DLT's normal matrix and its null vector, `_dlt_pose`'s lines."""
    def jfn(X, xn):
        Xh = jnp.concatenate([X, jnp.ones_like(X[..., :1])], axis=-1)
        zeros = jnp.zeros_like(Xh)
        x, y = xn[..., 0:1], xn[..., 1:2]
        A = jnp.concatenate([jnp.concatenate([Xh, zeros, -x * Xh], axis=-1),
                             jnp.concatenate([zeros, Xh, -y * Xh], axis=-1)], axis=-2)
        AtA = jnp.einsum("...ni,...nj->...ij", A, A)
        return AtA, j_la.smallest_eigvec_psd(AtA)

    X, xn = _dlt_sets(rng)
    AtA = t_pnp.dlt_normal_matrix(torch.from_numpy(X), torch.from_numpy(xn))
    return jax.jit(jfn)(X, xn), (AtA, t_la.smallest_eigvec_psd(AtA))


def _stage_dlt_pose(rng):
    X, xn = _dlt_sets(rng)
    return jax.jit(j_pnp._dlt_pose)(X, xn), t_pnp._dlt_pose(torch.from_numpy(X),
                                                            torch.from_numpy(xn))


def _stage_cholesky_solve(rng):
    A = rng.normal(size=(B_STAGE, 8, 6)).astype(np.float32)
    H = np.einsum("bki,bkj->bij", A, A).astype(np.float32)
    g = rng.normal(size=(B_STAGE, 6)).astype(np.float32)
    return (jax.jit(j_la.cholesky_solve_small)(H, g),
            t_la.cholesky_solve_small(torch.from_numpy(H), torch.from_numpy(g)))


STAGES = [_stage_fma, _stage_det3, _stage_kabsch_moments, _stage_kabsch, _stage_svd3x3,
          _stage_eigh3x3, _stage_hartley, _stage_eight_point, _stage_dlt_build,
          _stage_dlt_pose, _stage_cholesky_solve]


@pytest.mark.parametrize("stage", STAGES, ids=[f.__name__[7:] for f in STAGES])
def test_minimal_solves_round_as_jit(rng, stage):
    want, got = stage(rng)
    want, got = jax.tree.leaves(want), _leaves(got)
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        a = np.asarray(a)
        np.testing.assert_array_equal(b.view(np.int32), a.view(np.int32), err_msg=f"leaf {i}")
