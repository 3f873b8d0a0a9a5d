"""The port's pose-graph optimization (`vslam_tpu_torch.ops.pgo`) against
the JAX package's `vslam_tpu.ops.pgo`, on the problems of
`tests/test_pgo.py` (the drifting square with its true loop edge, with and
without the consensus-DCS weights, and with a wrong loop edge among good
ones) brought over leaf by leaf through numpy.

Tolerance: `optimize` runs the same damped Gauss-Newton (per-edge
`jacrev` Jacobians, one Cholesky per iteration) in f32 with the sums in
another order, so poses agree within 1e-4 (measured below 1e-6);
`total_chi2` within a relative 1e-5, the DCS weights within 1e-5;
`correct_trajectory` and `correct_map_points` within 1e-5 m; the
odometry edges' endpoints equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_pgo import _square_problem, make_drifting_loop
from vslam_tpu.ops import pgo as j_pgo
from vslam_tpu.ops import se3 as j_se3
from vslam_tpu_torch.core.state import from_numpy
from vslam_tpu_torch.ops import pgo as t_pgo
from vslam_tpu_torch.ops.linalg import f32_matmuls

N = 12


def _to_port(prob):
    """A JAX PGOProblem as the port's, through numpy."""
    return t_pgo.PGOProblem(*(v if v is None or isinstance(v, float)
                              else from_numpy(np.asarray(v), "cpu") for v in prob))


def _true_edge(R_gt, t_gt, i, j, off=0.0):
    Rr, tr = j_se3.relative(jnp.asarray(R_gt[i]), jnp.asarray(t_gt[i]),
                            jnp.asarray(R_gt[j]), jnp.asarray(t_gt[j]))
    return i, j, np.asarray(Rr), np.asarray(tr) + np.array([off, 0, 0], np.float32)


def _problem(case):
    R_gt, t_gt, R_est, t_est, R_odo, t_odo = make_drifting_loop(N)
    extra, robust = [], None
    if case in ("wrong_edge", "wrong_edge_plain"):
        extra = [_true_edge(R_gt, t_gt, 8, 2), _true_edge(R_gt, t_gt, 9, 3),
                 _true_edge(R_gt, t_gt, 6, 1, off=0.8)]
    if case in ("dcs", "wrong_edge"):
        robust = np.concatenate([np.zeros(N - 1, bool), np.ones(1 + len(extra), bool)])
    return _square_problem(N, R_est, t_est, R_odo, t_odo, R_gt, t_gt, extra_edges=extra,
                           e_robust=robust)


@pytest.mark.parametrize("case", ["plain", "dcs", "wrong_edge", "wrong_edge_plain"])
def test_optimize_vs_jax(case):
    prob = _problem(case)
    tprob = _to_port(prob)
    Rj, tj = j_pgo.optimize(prob, iterations=15)
    with f32_matmuls():
        Rt, tt = t_pgo.optimize(tprob, iterations=15)
        chi_t = [float(t_pgo.total_chi2(tprob, R, t)) for R, t in ((tprob.R, tprob.t), (Rt, tt))]
        w_t = t_pgo.robust_weights(tprob)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy()[0], np.asarray(prob.t)[0], atol=1e-6)  # gauge
    chi_j = [float(j_pgo.total_chi2(prob, prob.R, prob.t)), float(j_pgo.total_chi2(prob, Rj, tj))]
    np.testing.assert_allclose(chi_t, chi_j, rtol=1e-5)
    assert chi_t[1] < chi_t[0]
    w_j = j_pgo.robust_weights(prob)
    assert (w_t is None) == (w_j is None)
    if w_j is not None:
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-5)
        if case == "wrong_edge":
            assert w_t[-1] < 0.1 and (w_t[:-1] == 1.0).all()  # the wrong edge crushed


def test_build_odometry_edges_on_a_wrapped_ring(rng):
    """Slots out of temporal order with invalid ones among them: edges
    join consecutive frame ids, as JAX's do."""
    V = 10
    R = np.asarray(j_se3.exp_so3(jnp.asarray(rng.normal(0, 0.3, (V, 3)).astype(np.float32))))
    t = rng.normal(size=(V, 3)).astype(np.float32)
    fid = rng.permutation(V).astype(np.int32) * 7
    valid = np.ones(V, bool)
    valid[[2, 5]] = False
    out_j = j_pgo.build_odometry_edges(jnp.asarray(R), jnp.asarray(t), jnp.asarray(valid),
                                       jnp.asarray(fid), 0.05, 0.02)
    with f32_matmuls():
        out_t = t_pgo.build_odometry_edges(torch.from_numpy(R), torch.from_numpy(t),
                                           torch.from_numpy(valid), torch.from_numpy(fid),
                                           0.05, 0.02)
    for k, (a, b) in enumerate(zip(out_j, out_t)):
        a, b = np.asarray(a), b.numpy()
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=str(k))
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, err_msg=str(k))


def test_correct_trajectory_and_map_points_vs_jax(rng):
    """Frames before, between, on and after the keyframes (by frame id),
    keyframes in shuffled slots with invalid ones; map points owned by
    valid and invalid keyframes."""
    V, F, M = 8, 60, 40
    kf_ids = rng.permutation(np.arange(4, 52, 6))[:V].astype(np.int32)
    kf_valid = rng.random(V) > 0.2
    R_old = np.asarray(j_se3.exp_so3(jnp.asarray(rng.normal(0, 0.2, (V, 3)).astype(np.float32))))
    R_new = np.asarray(j_se3.exp_so3(jnp.asarray(rng.normal(0, 0.2, (V, 3)).astype(np.float32))))
    t_old = rng.normal(size=(V, 3)).astype(np.float32)
    t_new = (t_old + rng.normal(0, 0.1, (V, 3))).astype(np.float32)
    frame_ids = np.arange(F, dtype=np.float32)
    fR = np.tile(np.eye(3, dtype=np.float32), (F, 1, 1))
    ft = rng.normal(size=(F, 3)).astype(np.float32)
    args = (frame_ids, fR, ft, kf_ids, kf_valid, R_old, t_old, R_new, t_new)
    _, tj = j_pgo.correct_trajectory(*map(jnp.asarray, args))
    with f32_matmuls():
        _, tt = t_pgo.correct_trajectory(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)

    pts = rng.normal(size=(M, 3)).astype(np.float32)
    owner = rng.integers(0, V, M).astype(np.int32)
    margs = (pts, owner, kf_valid, R_old, t_old, R_new, t_new)
    mj = j_pgo.correct_map_points(*map(jnp.asarray, margs))
    with f32_matmuls():
        mt = t_pgo.correct_map_points(*(torch.from_numpy(a) for a in margs))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-5)
    np.testing.assert_array_equal(mt.numpy()[~kf_valid[owner]], pts[~kf_valid[owner]])


def test_problem_round_trip():
    """A JAX problem crosses to the port and back leaf for leaf."""
    prob = _problem("dcs")
    tprob = _to_port(prob)
    for a, b in zip(jax.tree.leaves(prob), jax.tree.leaves(tprob)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
