"""The port's runners and in-run loop correction
(`vslam_tpu_torch.core.pipeline`) against the JAX package's
`vslam_tpu.core.pipeline`, on the loopy feature-level run of
`tests/test_pipeline.py` (`_loopy_run`: tiny configuration, relaxed loop
gates with `min_frame_gap` 12, 40 frames, at least 2 loop constraints).
JAX's final state crosses to the port leaf by leaf through numpy.

Tolerances:
  * in-run fold: below its floor (1e9 m) the state comes back bit-equal;
    on the drifted ring of `test_inrun_pgo_correct_floor_and_fold` both
    packages fold (counter + 1) and every folded leaf agrees within 1e-4
    (measured below 5e-6: the same Gauss-Newton in another order of
    summation);
  * the tracking run: decisions and loop counts equal, poses within 1e-4
    m (measured 2.3e-6), ATE within 1e-5 m;
  * RTS packaging (`result_from_outputs`, both smoother forms, with and
    without `keep_refine`) within 1e-5 m; post-hoc PGO within 1e-4 m;
  * stationarity and gravity from the stress world's accelerometer equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_pipeline import _loopy_run
from vslam_tpu.core import pipeline as j_pl
from vslam_tpu.data import synthetic as j_syn
from vslam_tpu_torch.config import LoopClosureConfig, tiny_test_config
from vslam_tpu_torch.core import pipeline as t_pl
from vslam_tpu_torch.core import tracking as t_tr
from vslam_tpu_torch.core.state import FrameFeatures, StepOutputs, from_numpy, to_numpy

DECISIONS = ("is_keyframe", "tracking_ok", "used_3d3d", "bridged", "recovered")


def _port_config():
    """`_loopy_run`'s configuration in the port."""
    return dataclasses.replace(tiny_test_config(), loop=LoopClosureConfig(
        min_frame_gap=12, min_inliers=10, check_interval_kfs=2, max_jump=1.0, min_jump=-1.0,
        kf_stride=1, min_frames_between_accepts=0))


@pytest.fixture(scope="module")
def loopy():
    cfg_j, seq, result, ate0 = _loopy_run()
    st_np = jax.tree.map(np.asarray, result.final_state)
    return dict(cfg_j=cfg_j, cfg=_port_config(), seq=seq, res=result, ate=ate0, st_np=st_np)


def _replace_opt(cfg, **kw):
    return dataclasses.replace(cfg, opt=dataclasses.replace(cfg.opt, **kw))


def _drifted(st_np, n):
    """The drifted ring of `test_inrun_pgo_correct_floor_and_fold`: 0.5 m
    of drift growing with frame id, the live pose moved with the newest
    keyframe."""
    kfs = st_np.keyframes
    ddir = np.asarray([0.6, -0.2, 0.3], np.float32)
    ddir /= np.linalg.norm(ddir)
    drift = (0.5 * np.clip(kfs.frame_id / (n - 1), 0.0, 1.0)[:, None]
             * ddir[None, :]).astype(np.float32)
    newest = int(np.argmax(np.where(kfs.valid, kfs.frame_id, -1)))
    return st_np._replace(keyframes=kfs._replace(t=kfs.t + drift), t=st_np.t + drift[newest])


def test_inrun_fold_below_its_floor_is_bit_equal(loopy):
    st = from_numpy(loopy["st_np"], "cpu")
    cfg_hi = _replace_opt(loopy["cfg"], inrun_min_correction_m=1e9)
    t_tr.reset_stats()
    out = t_pl.inrun_pgo_correct(st, cfg_hi)
    # At most the significance read; the fold's own gate is a select.
    assert t_tr.STATS["branch_reads"] <= 1
    for a, b in zip(jax.tree.leaves(loopy["st_np"]), jax.tree.leaves(to_numpy(out))):
        np.testing.assert_array_equal(b, a.view(np.uint16) if a.dtype.name == "bfloat16" else a)


def test_inrun_fold_matches_jax_on_a_drifted_ring(loopy):
    st_d = _drifted(loopy["st_np"], len(loopy["res"].t))
    j_fold = jax.jit(lambda s: j_pl.inrun_pgo_correct(s, loopy["cfg_j"]))
    j2 = jax.tree.map(np.asarray, j_fold(jax.tree.map(jnp.asarray, st_d)))
    t_pl.reset_stats()
    t2 = to_numpy(t_pl.inrun_pgo_correct(from_numpy(st_d, "cpu"), loopy["cfg"]))
    assert t_pl.STATS == {"inrun_calls": 1, "pgo_solves": 1}
    assert int(t2.inrun_corrections) == int(j2.inrun_corrections) == int(st_d.inrun_corrections) + 1
    for name, a, b in (("kf t", j2.keyframes.t, t2.keyframes.t),
                       ("kf R", j2.keyframes.R, t2.keyframes.R),
                       ("map", j2.map.pos, t2.map.pos), ("R", j2.R, t2.R), ("t", j2.t, t2.t),
                       ("kf_t", j2.kf_t, t2.kf_t), ("prev_t", j2.prev_t, t2.prev_t),
                       ("ekf x", j2.ekf.x, t2.ekf.x)):
        np.testing.assert_allclose(b, a, atol=1e-4, err_msg=name)
    # The fold moved the ring; anchors stay the tracked poses.
    assert np.abs(t2.keyframes.t - st_d.keyframes.t).max() > 0.05
    np.testing.assert_array_equal(t2.keyframes.t_anchor, st_d.keyframes.t_anchor)


def test_run_synthetic_vs_jax(loopy):
    """The port's tracking runner + RTS on the loopy sequence against the
    JAX run of the fixture."""
    res_j = loopy["res"]
    res_t, ate_t = t_pl.run_synthetic(loopy["seq"], loopy["cfg"], device="cpu")
    oj, ot = jax.tree.map(np.asarray, res_j.outputs), to_numpy(res_t.outputs)
    for name in DECISIONS:
        np.testing.assert_array_equal(getattr(ot, name), getattr(oj, name), err_msg=name)
    assert int(res_t.final_state.loops.valid.sum()) == int(loopy["st_np"].loops.valid.sum()) >= 2
    np.testing.assert_allclose(res_t.t, res_j.t, atol=1e-4)
    np.testing.assert_allclose(res_t.t_smoothed, res_j.t_smoothed, atol=1e-4)
    np.testing.assert_array_equal(res_t.timestamps, res_j.timestamps)
    assert abs(ate_t.rmse - loopy["ate"].rmse) <= 1e-5


@pytest.mark.parametrize("keep_refine", [True, False])
@pytest.mark.parametrize("rts_parallel", [True, False])
def test_result_from_outputs_vs_jax(loopy, keep_refine, rts_parallel):
    res_j = loopy["res"]
    rj = j_pl.result_from_outputs(res_j.final_state, res_j.outputs, keep_refine=keep_refine,
                                  rts_parallel=rts_parallel)
    outs = from_numpy(StepOutputs(*jax.tree.leaves(jax.tree.map(np.asarray, res_j.outputs))),
                      "cpu")
    rt = t_pl.result_from_outputs(None, outs, keep_refine=keep_refine, rts_parallel=rts_parallel)
    np.testing.assert_array_equal(rt.t, rj.t)
    np.testing.assert_allclose(rt.t_smoothed, rj.t_smoothed, atol=1e-5)
    assert not np.array_equal(rt.t_smoothed, rt.t)


def test_posthoc_pgo_vs_jax(loopy):
    """`run_posthoc_pgo` on the fixture's run with its newest loop edge
    only (the single-edge floor rejects: identity) and on the grossly
    drifted copy of `test_posthoc_single_edge_floor` (accepted)."""
    res_j, st_np = loopy["res"], loopy["st_np"]
    loops_v = st_np.loops.valid
    one_hot = np.zeros_like(loops_v)
    one_hot[int(np.nonzero(loops_v)[0][-1])] = True
    st1 = st_np._replace(loops=st_np.loops._replace(valid=one_hot))
    n = len(res_j.t)
    prof = (np.arange(n, dtype=np.float32) / (n - 1)) ** 1.5
    ddir = np.asarray([0.6, -0.2, 0.3], np.float32)
    ddir /= np.linalg.norm(ddir)
    kf_drift = (np.clip(st_np.keyframes.frame_id / (n - 1), 0.0, 1.0)[:, None] ** 1.5
                * ddir[None, :]).astype(np.float32)
    drifted_st = st1._replace(keyframes=st1.keyframes._replace(
        t=st1.keyframes.t + kf_drift, t_anchor=st1.keyframes.t_anchor + kf_drift))
    drift = prof[:, None] * ddir[None, :]
    outs = from_numpy(StepOutputs(*jax.tree.leaves(jax.tree.map(np.asarray, res_j.outputs))),
                      "cpu")
    for st_case, d, moves in ((st1, 0.0, False), (drifted_st, drift, True)):
        rj_in = dataclasses.replace(res_j, t=res_j.t + d, t_smoothed=res_j.t_smoothed + d,
                                    final_state=jax.tree.map(jnp.asarray, st_case))
        rj = j_pl.run_posthoc_pgo(rj_in, loopy["cfg_j"])
        rt_in = t_pl.RunResult(rj_in.timestamps, rj_in.R, rj_in.t, rj_in.t_smoothed, outs,
                               from_numpy(st_case, "cpu"))
        rt = t_pl.run_posthoc_pgo(rt_in, loopy["cfg"])
        np.testing.assert_allclose(rt.t_smoothed, rj.t_smoothed, atol=1e-4)
        np.testing.assert_allclose(rt.final_state.keyframes.t.numpy(),
                                   np.asarray(rj.final_state.keyframes.t), atol=1e-4)
        assert (np.abs(rt.t_smoothed - rt_in.t_smoothed).max() > 0.05) == moves


def test_chunked_runner_folds_between_chunks(loopy):
    """`run_tracking(chunk=8)` is the tracking loop chunk by chunk with
    `inrun_pgo_correct` after each chunk that accepted a loop constraint.
    Held on a configuration whose folds fire (no significance threshold,
    no correction floor), against that loop written out."""
    cfg = _replace_opt(loopy["cfg"], pgo_min_chi2_per_dof=0.0, inrun_min_correction_m=0.0)
    seq = loopy["seq"]
    gravity, h0 = t_pl.compute_gravity_direction(seq.accel, np.eye(3, dtype=np.float32))
    stat = t_pl.detect_stationary(seq.accel, seq.timestamps)
    frames = t_pl.features_from_synthetic(seq, stationary=stat, device="cpu")
    t_pl.reset_stats()
    res = t_pl.run_tracking(frames, cfg, gravity=gravity, initial_height=h0, chunk=8,
                            device="cpu")
    calls = t_pl.STATS["inrun_calls"]
    st = t_pl.init_state(cfg, gravity=gravity, initial_height=h0, device="cpu")
    n_calls = 0
    for s in range(0, frames.xy.shape[0], 8):
        n0 = int(st.loops.valid.sum())
        st, _ = t_tr.run_frames(st, FrameFeatures(*(x[s:s + 8] for x in frames)),
                                list(range(s, s + 8)), cfg)
        if int(st.loops.valid.sum()) > n0:
            st = t_pl.inrun_pgo_correct(st, cfg)
            n_calls += 1
    assert calls == n_calls >= 1 and int(res.final_state.inrun_corrections) >= 1
    for a, b in zip(jax.tree.leaves(to_numpy(res.final_state)), jax.tree.leaves(to_numpy(st))):
        np.testing.assert_array_equal(a, b)


def test_stationarity_and_gravity_vs_jax():
    """From the stress world's accelerometer rows (48 small frames, the
    pause inside): the same stationary frames and gravity axis."""
    d = j_syn.make_stress_image_sequence(48, width=32, height=24, fx=30.0, fy=30.0, cx=15.5,
                                         cy=11.5, num_landmarks=200, seed=101)
    for kw in (dict(), dict(window=0.2, threshold=0.3)):
        a = j_pl.detect_stationary(d["accel"], d["timestamps"], **kw)
        b = t_pl.detect_stationary(d["accel"], d["timestamps"], **kw)
        np.testing.assert_array_equal(b, a)
    assert a.any() and not a.all()
    ga, ha = j_pl.compute_gravity_direction(d["accel"], np.eye(3, dtype=np.float32))
    gb, hb = t_pl.compute_gravity_direction(d["accel"], np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(gb, ga)
    assert ha == hb == 0.0
    assert t_pl.compute_gravity_direction(None, np.eye(3)) == (None, 0.0)


def test_loop_path_reads_only_branch_predicates(loopy):
    """On the card every read of a device value back to the host waits for
    the stream. The chunked runner with folds that fire, RTS and the
    backend read back only the predicates that `tracking._cond` counts
    (each shows up on the CPU as one of the ATen ops counted here); the
    trajectories come back through copies."""
    from torch.utils._python_dispatch import TorchDispatchMode

    reads = []

    class CountReads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket.__name__ in ("_local_scalar_dense", "nonzero"):
                reads.append(func)
            return func(*args, **(kwargs or {}))

    cfg = _replace_opt(loopy["cfg"], pgo_min_chi2_per_dof=0.0, inrun_min_correction_m=0.0)
    seq = loopy["seq"]
    gravity, h0 = t_pl.compute_gravity_direction(seq.accel, np.eye(3, dtype=np.float32))
    frames = t_pl.features_from_synthetic(seq, device="cpu")
    t_tr.reset_stats()
    t_pl.reset_stats()
    with CountReads():
        res = t_pl.run_tracking(frames, cfg, gravity=gravity, initial_height=h0, chunk=8,
                                device="cpu")
        t_pl.run_backend(res, cfg)
    assert t_pl.STATS["inrun_calls"] >= 1 and t_pl.STATS["pgo_solves"] >= 1
    assert len(reads) == t_tr.STATS["branch_reads"] > 0
