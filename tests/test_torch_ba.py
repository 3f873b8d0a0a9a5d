"""The port's bundle adjustment (`vslam_tpu_torch.ops.ba`) and the fused
PGO + BA backend (`core.pipeline.run_backend`) against the JAX package.

Inputs: the noisy-arc problem of `tests/test_ba.py` (5 poses, 120
points), and the loopy run of `tests/test_pipeline.py` (`_loopy_run`),
healthy and with the gross drift of `test_posthoc_single_edge_floor` so
that the post-hoc PGO and the whole-chain BA both act. JAX's state
crosses to the port through numpy.

Tolerances: the observation grid built for BA (candidate points, pixels,
mask) and the holdout split are equal; every gate decision (BA
significance, accept, the per-keyframe jump gate, the backend's
identity on a healthy run) is equal; poses and points within 1e-3 m and
rad (measured below 2e-6 m on the backend: the same LM and Schur solve in
another order of summation), costs within a relative 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_ba import make_ba_problem
from test_pipeline import _loopy_run
from vslam_tpu.core import pipeline as j_pl
from vslam_tpu.ops import ba as j_ba
from vslam_tpu_torch.config import LoopClosureConfig, tiny_test_config
from vslam_tpu_torch.core import pipeline as t_pl
from vslam_tpu_torch.core import tracking as t_tr
from vslam_tpu_torch.core.state import StepOutputs, from_numpy, to_numpy
from vslam_tpu_torch.ops import ba as t_ba
from vslam_tpu_torch.ops.linalg import f32_matmuls

BA_KW = dict(iterations=10, huber_px=5.0, gate2_px=4.0, point_prior_weight=1000.0,
             odo_trans_sigma=0.01, odo_rot_sigma=0.005, rtol=1e-4)


def _to_port(prob):
    return type(prob)(*(from_numpy(np.asarray(v), "cpu") for v in prob))


def _port_problem(prob):
    return t_ba.BAProblem(*(from_numpy(np.asarray(v), "cpu") for v in prob))


@pytest.fixture(scope="module")
def loopy():
    cfg_j, seq, res_j, _ = _loopy_run()
    cfg = dataclasses.replace(tiny_test_config(), loop=LoopClosureConfig(
        min_frame_gap=12, min_inliers=10, check_interval_kfs=2, max_jump=1.0, min_jump=-1.0,
        kf_stride=1, min_frames_between_accepts=0))
    st = res_j.final_state
    n = len(res_j.t)
    prof = (np.arange(n, dtype=np.float32) / (n - 1)) ** 1.5
    ddir = np.asarray([0.6, -0.2, 0.3], np.float32)
    ddir /= np.linalg.norm(ddir)
    kf_drift = (np.clip(np.asarray(st.keyframes.frame_id) / (n - 1), 0.0, 1.0)[:, None] ** 1.5
                * ddir[None, :]).astype(np.float32)
    drift = prof[:, None] * ddir[None, :]
    drifted = dataclasses.replace(
        res_j, t=res_j.t + drift, t_smoothed=res_j.t_smoothed + drift,
        final_state=st._replace(keyframes=st.keyframes._replace(
            t=st.keyframes.t + kf_drift, t_anchor=st.keyframes.t_anchor + kf_drift)))
    return dict(cfg_j=cfg_j, cfg=cfg, healthy=res_j, drifted=drifted)


def _port_result(res_j):
    outs = StepOutputs(*jax.tree.leaves(jax.tree.map(np.asarray, res_j.outputs)))
    return t_pl.RunResult(res_j.timestamps, res_j.R, res_j.t, res_j.t_smoothed,
                          from_numpy(outs, "cpu"),
                          from_numpy(jax.tree.map(np.asarray, res_j.final_state), "cpu"))


def test_bundle_adjust_robust_vs_jax():
    """The backend's BA settings (odometry edges, point prior, re-gate,
    early exit) on the noisy arc; the gates on the solution."""
    prob, *_ = make_ba_problem(np.random.default_rng(3))
    tprob = _port_problem(prob)
    Rj, tj, Xj, cj = j_ba.bundle_adjust_robust(prob, **BA_KW)
    t_tr.reset_stats()
    with f32_matmuls():
        Rt, tt, Xt, ct = t_ba.bundle_adjust_robust(tprob, **BA_KW)
        gates_t = [t_ba.window_cost(tprob, Rt, tt, Xt), t_ba.ba_significant(tprob, min_cost_per_obs=0.25),
                   t_ba.ba_accept_window(tprob, Rt, tt, Xt, min_cost_per_obs=0.25)]
    # The early exit reads its flag back once per iteration after the second.
    assert 0 < t_tr.STATS["branch_reads"] <= 2 * (BA_KW["iterations"] - 2)
    # measured 3.2e-6 / 1.3e-6 / 1.1e-5 (sums over the observations in
    # torch's order)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=5e-6)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=2e-6)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=2e-5)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)
    gates_j = [j_ba.window_cost(prob, Rj, tj, Xj), j_ba.ba_significant(prob, min_cost_per_obs=0.25),
               j_ba.ba_accept_window(prob, Rj, tj, Xj, min_cost_per_obs=0.25)]
    np.testing.assert_allclose(float(gates_t[0]), float(gates_j[0]), rtol=1e-4)
    assert bool(gates_t[1]) == bool(gates_j[1]) and bool(gates_t[2]) == bool(gates_j[2])


def test_ba_problem_and_gated_solve_vs_jax(loopy):
    """The whole-chain BA stage of the backend on the drifted run after
    its post-hoc PGO: the observation grid, the holdout split, the gated
    solve's decisions and result, and the per-keyframe jump gate."""
    cfg_j, cfg = loopy["cfg_j"], loopy["cfg"]
    pj = j_pl.run_posthoc_pgo(loopy["drifted"], cfg_j)
    st_np = jax.tree.map(np.asarray, pj.final_state)
    sj = jax.tree.map(jnp.asarray, st_np)
    st = from_numpy(st_np, "cpu")
    P = cfg.opt.ba_global_max_points
    order_j = jnp.argsort(jnp.where(sj.keyframes.valid, sj.keyframes.frame_id,
                                    jnp.iinfo(jnp.int32).max)).astype(jnp.int32)
    Xj, uvj, mj, candj = j_pl._build_ba_obs(sj.map, sj.keyframes, order_j, cfg_j, P)
    order = t_pl._chain_order(st.keyframes)
    with f32_matmuls():
        Xt, uvt, mt, candt = t_pl._build_ba_obs(st.map, st.keyframes, order, cfg, P)
    np.testing.assert_array_equal(order.numpy(), np.asarray(order_j))
    np.testing.assert_array_equal(candt.numpy(), np.asarray(candj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert mt.sum() > 50
    np.testing.assert_array_equal(uvt.numpy()[mt.numpy()], np.asarray(uvj)[np.asarray(mj)])
    np.testing.assert_array_equal(Xt.numpy(), np.asarray(Xj))

    W_ = order.shape[0]
    ii = jnp.arange(W_, dtype=jnp.uint32)[:, None]
    jj = jnp.arange(P, dtype=jnp.uint32)[None, :]
    h = (ii * jnp.uint32(2654435761) + jj * jnp.uint32(40503)) % jnp.uint32(1000)
    np.testing.assert_array_equal(t_pl._holdout_mask(W_, P, 0.1, "cpu").numpy(),
                                  np.asarray(h < 100))

    pose_ok_j = sj.keyframes.valid[order_j]
    mask_j = mj & pose_ok_j[:, None]
    c = cfg_j.camera
    prob_j = j_ba.BAProblem(
        R=sj.keyframes.R[order_j], t=sj.keyframes.t[order_j], pose_valid=pose_ok_j, X=Xj,
        point_valid=jnp.sum(mask_j, axis=0) >= 2, uv=uvj, obs_valid=mask_j,
        fx=jnp.asarray(c.fx), fy=jnp.asarray(c.fy), cx=jnp.asarray(c.cx), cy=jnp.asarray(c.cy))
    Rj, tj, Xoj, accj = j_pl._ba_gated_solve_jit(prob_j, cfg_j, cfg_j.opt.ba_global_iterations)
    with f32_matmuls():
        prob_t = t_pl._ba_problem(st.keyframes, order, st.keyframes.valid[order], Xt, uvt, mt, cfg)
        Rt, tt, Xot, acct = t_pl._ba_gated_solve(prob_t, cfg, cfg.opt.ba_global_iterations)
    assert bool(acct) == bool(accj)
    # measured 6.0e-7 / 4.2e-7 / 9.5e-7
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-6)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-6)
    np.testing.assert_allclose(Xot.numpy(), np.asarray(Xoj), atol=2e-6)
    jump_j = np.linalg.norm(np.asarray(tj) - np.asarray(prob_j.t), axis=-1) < cfg.opt.ba_max_jump
    jump_t = np.linalg.norm(tt.numpy() - prob_t.t.numpy(), axis=-1) < cfg.opt.ba_max_jump
    np.testing.assert_array_equal(jump_t, jump_j)


@pytest.mark.parametrize("case", ["healthy", "drifted"])
def test_run_backend_vs_jax(loopy, case):
    """`run_backend` on the healthy run is an identity in both packages;
    on the drifted run both move the trajectory the same way. The
    sequential passes (`run_posthoc_pgo` then `run_windowed_ba`) give the
    fused backend's result."""
    res_j = loopy[case]
    rb_j = j_pl.run_backend(res_j, loopy["cfg_j"])
    res_t = _port_result(res_j)
    rb_t = t_pl.run_backend(res_t, loopy["cfg"])
    ident_j = np.array_equal(rb_j.t_smoothed, res_j.t_smoothed)
    ident_t = np.array_equal(rb_t.t_smoothed, res_t.t_smoothed)
    assert ident_t == ident_j == (case == "healthy")
    np.testing.assert_allclose(rb_t.t_smoothed, rb_j.t_smoothed, atol=1e-3)
    np.testing.assert_allclose(rb_t.t, rb_j.t, atol=1e-3)
    np.testing.assert_allclose(rb_t.final_state.keyframes.t.numpy(),
                               np.asarray(rb_j.final_state.keyframes.t), atol=1e-3)
    np.testing.assert_allclose(rb_t.final_state.map.pos.numpy(),
                               np.asarray(rb_j.final_state.map.pos), atol=1e-3)
    seq_t = t_pl.run_windowed_ba(t_pl.run_posthoc_pgo(res_t, loopy["cfg"]), loopy["cfg"])
    np.testing.assert_allclose(seq_t.t_smoothed, rb_t.t_smoothed, atol=1e-5)
