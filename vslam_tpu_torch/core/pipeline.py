"""Runners and the post-hoc passes: tracking over a frame stream with the
in-run loop correction, RTS smoothing, pose-graph optimization and
bundle adjustment.

Port of `vslam_tpu/core/pipeline.py`:

  * `run_tracking` / `run_synthetic`: the tracking step over a packed
    frame stream, chunk by chunk with the in-run correction between chunks
    (`track_chunk`, which `core.coupled.run_coupled` shares), then RTS
    smoothing (`result_from_outputs`);
  * `inrun_pgo_correct`: the gain-gated PGO over the keyframe ring, folded
    back into the live tracking state when it moves the newest keyframe
    by more than `opt.inrun_min_correction_m`;
  * `run_backend`: post-hoc PGO, then whole-chain BA, each gain-gated
    (`run_posthoc_pgo` and `run_windowed_ba` are the same passes one at a
    time).

Each `lax.cond` of the JAX package becomes a Python `if` on a predicate
read back through `core.tracking._cond` (counted in
`tracking.STATS["branch_reads"]`); each select stays a `torch.where` on
the device. The geometry runs in full f32 (`ops.linalg.f32_matmuls`).
Results (`RunResult`) hold host numpy trajectories, as the JAX package's
do, and the device state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vslam_tpu_torch.config import SlamConfig
from vslam_tpu_torch.core import tracking
from vslam_tpu_torch.core.state import (
    FrameFeatures,
    StepOutputs,
    TrackState,
    copy_to,
    init_state,
)
from vslam_tpu_torch.ops import ba as ba_ops
from vslam_tpu_torch.ops import camera as cam
from vslam_tpu_torch.ops import device as dev_ops
from vslam_tpu_torch.ops import ekf as ekf_ops
from vslam_tpu_torch.ops import matching
from vslam_tpu_torch.ops import pgo
from vslam_tpu_torch.ops import se3
from vslam_tpu_torch.ops.linalg import f32_matmuls
from vslam_tpu_torch.utils import profiling

_I32_MAX = torch.iinfo(torch.int32).max

# Counters a caller can read after a run: calls of the in-run correction,
# and ring solves that passed their significance gate (in-run or post-hoc).
STATS = {"inrun_calls": 0, "pgo_solves": 0}


def reset_stats():
    for k in STATS:
        STATS[k] = 0


@dataclass
class RunResult:
    timestamps: np.ndarray  # (N,)
    R: np.ndarray  # (N, 3, 3) raw per-frame poses
    t: np.ndarray  # (N, 3)
    t_smoothed: np.ndarray  # (N, 3) RTS-smoothed positions
    outputs: StepOutputs  # stacked per-frame outputs (device)
    final_state: TrackState  # (device)


def _f32(x, device):
    """A () f32 tensor on `device` from a tensor or a Python number; a
    number is filled in on the device, with no host-to-device copy."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _to_dev(a, device):
    return dev_ops.to_device(torch.from_numpy(np.array(a)), device)


def features_from_synthetic(seq, stationary=None, device="cuda"):
    """Pack a feature-level synthetic sequence (`kp_xy`, `kp_desc`,
    `kp_depth`, `kp_valid`, `timestamps`) into stacked FrameFeatures on
    `device`."""
    N = seq.kp_xy.shape[0]
    if stationary is None:
        stationary = np.zeros(N, dtype=bool)
    dev = torch.device(device)
    return FrameFeatures(
        xy=torch.as_tensor(np.asarray(seq.kp_xy)).to(dev),
        desc=torch.as_tensor(np.asarray(seq.kp_desc)).to(dev),
        depth=torch.as_tensor(np.asarray(seq.kp_depth)).to(dev),
        valid=torch.as_tensor(np.asarray(seq.kp_valid)).to(dev),
        timestamp=torch.as_tensor(np.asarray(seq.timestamps, dtype=np.float32)).to(dev),
        stationary=torch.as_tensor(np.asarray(stationary)).to(dev),
        frame_id=torch.arange(N, dtype=torch.int32, device=dev),
    )


def compute_gravity_direction(accel, R0):
    """Mean accelerometer reading -> world frame -> the nearest axis
    (`src/Slam.cpp:1587-1616`). Returns (gravity (3,) f32 or None, initial
    height 0.0). Host-side."""
    if accel is None or len(accel) == 0:
        return None, 0.0
    g_cam = np.mean(np.asarray(accel)[:, 1:4], axis=0)
    g_world = np.asarray(R0) @ g_cam
    n = np.linalg.norm(g_world)
    if n < 1e-6:
        return None, 0.0
    g_world = g_world / n
    axis = int(np.argmax(np.abs(g_world)))
    snapped = np.zeros(3, dtype=np.float32)
    snapped[axis] = np.sign(g_world[axis])
    return snapped, 0.0


def detect_stationary(accel, timestamps, window=0.1, threshold=0.15):
    """Per-frame stationarity: the accelerometer magnitude's standard
    deviation within +-`window` s below `threshold`, over at least 5
    readings (`src/Slam.cpp:1621-1651`). Host-side, from prefix sums."""
    if accel is None or len(accel) == 0:
        return np.zeros(len(timestamps), dtype=bool)
    a = np.asarray(accel)
    mags = np.linalg.norm(a[:, 1:4], axis=-1)
    ts = a[:, 0]
    t = np.asarray(timestamps)
    lo = np.searchsorted(ts, t - window)
    hi = np.searchsorted(ts, t + window)
    n = (hi - lo).astype(np.int64)
    c1 = np.concatenate([[0.0], np.cumsum(mags)])
    c2 = np.concatenate([[0.0], np.cumsum(mags * mags)])
    nn = np.maximum(n, 1)
    mean = (c1[hi] - c1[lo]) / nn
    var = np.maximum((c2[hi] - c2[lo]) / nn - mean * mean, 0.0)
    return (n >= 5) & (np.sqrt(var) < threshold)


def track_chunk(st: TrackState, frames: FrameFeatures, frame_ids, config: SlamConfig,
                seed: int = 42):
    """One chunk of frames through the tracking step (`frame_ids` on the
    host), then, with `opt.inrun_pgo`, the in-run correction when the
    chunk accepted a new loop constraint (one counted read; the `pgo`
    span). Returns (state, stacked StepOutputs)."""
    n_loops0 = torch.sum(st.loops.valid)
    st, outs = tracking.run_frames(st, frames, frame_ids, config, seed)
    if config.opt.inrun_pgo and tracking._cond(torch.sum(st.loops.valid) > n_loops0):
        with profiling.span("pgo"):
            st = inrun_pgo_correct(st, config)
    return st, outs


def result_from_outputs(final_state: TrackState, outs: StepOutputs, smooth: bool = True,
                        keep_refine: bool = True, rts_parallel: bool = True) -> RunResult:
    """Package a run's outputs as a RunResult, RTS-smoothing the EKF
    snapshots (`rts_smooth_assoc`, or `rts_smooth` with `rts_parallel`
    False). `keep_refine` adds each frame's refinement after the EKF
    update (t_raw - x_filt) back on top of the smoothed position
    (`EKFConfig.smooth_keep_refine`)."""
    t_raw = outs.t.cpu().numpy()
    if smooth:
        N = t_raw.shape[0]
        dev = outs.t.device
        snaps = ekf_ops.EKFSnapshot(
            x_pred=outs.x_pred, P_pred=outs.P_pred, x_filt=outs.x_filt, P_filt=outs.P_filt,
            dt=outs.dt, frame_id=torch.arange(N, dtype=torch.int32, device=dev),
        )
        valid = torch.ones(N, dtype=torch.bool, device=dev)
        smoother = ekf_ops.rts_smooth_assoc if rts_parallel else ekf_ops.rts_smooth
        with f32_matmuls():
            t_smooth = smoother(snaps, valid).cpu().numpy()
        if keep_refine:
            t_smooth = t_smooth + (t_raw - outs.x_filt[:, :3].cpu().numpy())
    else:
        t_smooth = t_raw
    return RunResult(
        timestamps=outs.timestamp.cpu().numpy().astype(np.float64),
        R=outs.R.cpu().numpy(), t=t_raw, t_smoothed=t_smooth, outputs=outs,
        final_state=final_state,
    )


def run_tracking(frames: FrameFeatures, config: SlamConfig, state: Optional[TrackState] = None,
                 gravity=None, initial_height=0.0, seed: int = 42, smooth: bool = True,
                 chunk: Optional[int] = None, device="cuda") -> RunResult:
    """The tracking step over a packed frame stream on `device`, then RTS
    smoothing. With `chunk`, the stream runs in chunks of that many frames
    (N must be a multiple) with the in-run correction between them, as in
    `core.coupled.run_coupled`. A state handed in is copied."""
    dev = torch.device(device)
    if state is None:
        st = init_state(config, gravity=gravity, initial_height=initial_height, device=dev)
    else:
        st = copy_to(state, dev)
    frames = FrameFeatures(*(x.to(dev) for x in frames))
    ids = frames.frame_id.cpu().tolist()
    if chunk:
        if len(ids) % chunk:
            raise ValueError(f"{len(ids)} frames do not split into chunks of {chunk}")
        outs = []
        for s in range(0, len(ids), chunk):
            st, o = track_chunk(st, FrameFeatures(*(x[s:s + chunk] for x in frames)),
                                ids[s:s + chunk], config, seed)
            outs.append(o)
        outs = StepOutputs(*(torch.cat(f) for f in zip(*outs)))
    else:
        st, outs = tracking.run_frames(st, frames, ids, config, seed)
    return result_from_outputs(st, outs, smooth=smooth,
                               keep_refine=config.ekf.smooth_keep_refine,
                               rts_parallel=config.ekf.rts_parallel)


# ----------------------------------------------------------------------------
# Pose-graph optimization over the keyframe ring
# ----------------------------------------------------------------------------


def pgo_ring_solve(st: TrackState, gravity_opt, initial_height, config: SlamConfig,
                   iterations=None, single_edge_floor=True):
    """Gain-gated PGO over the keyframe ring, the fresh loop constraints
    and the height prior; shared by the post-hoc pass and the in-run
    correction. The solve runs only when the constraints are violated
    beyond `opt.pgo_min_chi2_per_dof` (one counted read); its result is
    kept only when it lowers the total chi^2 and, with loop edges, moves
    some keyframe by at least the correction floor (`single_edge_floor`:
    one loop edge must clear `pgo_single_loop_min_correction_m`, as the
    post-hoc pass requires; off for the in-run path). Returns (R, t) of
    the ring: its current poses when skipped or rejected."""
    kfs, loops, oc = st.keyframes, st.loops, config.opt
    dev = kfs.R.device
    if iterations is None:
        iterations = oc.pgo_iterations
    e_i, e_j, e_R, e_t, e_info, e_valid = pgo.build_odometry_edges(
        kfs.R, kfs.t, kfs.valid, kfs.frame_id, oc.pgo_odom_trans_sigma, oc.pgo_odom_rot_sigma)
    li = torch.clamp(loops.kf_from.long(), min=0)
    lj = torch.clamp(loops.kf_to.long(), min=0)
    # A wrapped ring may have overwritten a constraint's endpoint: usable
    # only while both slots still hold the frames recorded at creation.
    l_fresh = loops.valid & (kfs.frame_id[li] == loops.from_id) & (kfs.frame_id[lj] == loops.to_id)
    L = li.shape[0]
    l_info = torch.cat([torch.full((L, 3), 1.0 / oc.pgo_lc_trans_sigma**2, device=dev),
                        torch.full((L, 3), 1.0 / oc.pgo_lc_rot_sigma**2, device=dev)], dim=1)
    prob = pgo.PGOProblem(
        R=kfs.R, t=kfs.t, v_valid=kfs.valid,
        e_i=torch.cat([e_i, li]), e_j=torch.cat([e_j, lj]),
        e_R=torch.cat([e_R, loops.R_rel]), e_t=torch.cat([e_t, loops.t_rel]),
        e_info=torch.cat([e_info, l_info]), e_valid=torch.cat([e_valid, l_fresh]),
        # Consensus DCS on the loop edges only; odometry edges are trusted.
        e_robust=torch.cat([torch.zeros(e_i.shape[0], dtype=torch.bool, device=dev),
                            torch.ones(L, dtype=torch.bool, device=dev)]),
        dcs_phi=_f32(oc.pgo_loop_dcs_phi, dev),
        gravity=st.gravity if gravity_opt is None else gravity_opt,
        height=_f32(initial_height, dev),
        height_info=_f32(1.0 / oc.pgo_height_sigma**2, dev),
        height_on=st.has_height,
    )
    # Significance depends only on the input poses (odometry edges are
    # built from them, so their residual is zero): it gates the solve.
    chi2_before = pgo.total_chi2(prob, kfs.R, kfs.t)
    n_height = torch.sum(kfs.valid) * st.has_height
    dof = 6 * torch.sum(l_fresh) + n_height
    significant = chi2_before > oc.pgo_min_chi2_per_dof * torch.clamp(dof, min=1)
    if not tracking._cond(significant):
        return kfs.R, kfs.t
    STATS["pgo_solves"] += 1
    R_opt, t_opt = pgo.optimize(prob, iterations=iterations)
    chi2_after = pgo.total_chi2(prob, R_opt, t_opt)
    acc = chi2_after < chi2_before * (1.0 - 1e-5)
    # Correction floor with loop edges: a solve that moves no keyframe by
    # more than a loop edge's noise mostly injects that noise.
    max_dt = torch.max(torch.where(kfs.valid, se3.norm(t_opt - kfs.t), 0.0))
    n_loop = torch.sum(l_fresh)
    single_floor = (oc.pgo_single_loop_min_correction_m if single_edge_floor
                    else oc.pgo_loop_min_correction_m)
    floor = torch.where(n_loop >= 2, oc.pgo_loop_min_correction_m, single_floor)
    acc = acc & ((n_loop == 0) | (max_dt >= floor))
    return torch.where(acc, R_opt, kfs.R), torch.where(acc, t_opt, kfs.t)


def _pgo_pass(st: TrackState, res_R, res_t, res_t_smoothed, gravity_opt, initial_height,
              config: SlamConfig):
    """The post-hoc PGO pass: the ring solve, then the trajectory (raw and
    smoothed) corrected from the anchor (tracked) poses, which frames
    emitted before an in-run correction still carry, and the map points
    moved with their keyframes. Returns (R, t, t_corr, t_corr_s, pos)."""
    kfs = st.keyframes
    R_opt, t_opt = pgo_ring_solve(st, gravity_opt, initial_height, config)
    frame_ids = torch.arange(res_t.shape[0], dtype=torch.float32, device=res_t.device)
    _, t_corr = pgo.correct_trajectory(frame_ids, res_R, res_t, kfs.frame_id, kfs.valid,
                                       kfs.R_anchor, kfs.t_anchor, R_opt, t_opt)
    _, t_corr_s = pgo.correct_trajectory(frame_ids, res_R, res_t_smoothed, kfs.frame_id,
                                         kfs.valid, kfs.R_anchor, kfs.t_anchor, R_opt, t_opt)
    moved = pgo.correct_map_points(st.map.pos, torch.remainder(st.map.first_kf, kfs.valid.shape[0]),
                                   kfs.valid, kfs.R, kfs.t, R_opt, t_opt)
    return R_opt, t_opt, t_corr, t_corr_s, moved


# The leaves `inrun_pgo_correct` changes; every other leaf passes through.
_FOLDED = ("R", "t", "kf_R", "kf_t", "prev_R", "prev_t", "inrun_corrections")


def inrun_pgo_correct(st: TrackState, config: SlamConfig) -> TrackState:
    """In-run pose-graph correction: the ring solve (`pgo_ring_solve`,
    `opt.inrun_pgo_iterations`, no single-edge floor) folded back into the
    live state, so that later frames track against loop-consistent
    keyframes and map points. Keyframe poses (not their anchors) take the
    solution, map points move with their keyframes, and the current,
    previous and active-keyframe poses and the EKF mean move by the newest
    keyframe's rigid delta. The fold applies only when the newest keyframe
    moves by at least `opt.inrun_min_correction_m`; below that the state
    comes back bit-equal (a select on the device, no read back)."""
    STATS["inrun_calls"] += 1
    with f32_matmuls():
        kfs = st.keyframes
        R_opt, t_opt = pgo_ring_solve(st, None, st.initial_height, config,
                                      iterations=config.opt.inrun_pgo_iterations,
                                      single_edge_floor=False)
        newest = torch.argmax(torch.where(kfs.valid, kfs.frame_id, -1))
        R_new, t_new = dev_ops.take(R_opt, newest), dev_ops.take(t_opt, newest)
        R_old, t_old = dev_ops.take(kfs.R, newest), dev_ops.take(kfs.t, newest)
        apply = se3.norm(t_new - t_old) >= config.opt.inrun_min_correction_m
        moved = pgo.correct_map_points(
            st.map.pos, torch.remainder(st.map.first_kf, kfs.valid.shape[0]), kfs.valid,
            kfs.R, kfs.t, R_opt, t_opt)
        Rd, td = se3.compose(R_new, t_new, *se3.inverse(R_old, t_old))

        def move(R, t):
            return Rd @ R, (Rd @ t[..., None])[..., 0] + td

        R_cur, t_cur = move(st.R, st.t)
        R_prev, t_prev = move(st.prev_R, st.prev_t)
        x = torch.cat([t_cur, (Rd @ st.ekf.x[3:, None])[:, 0]])
        folded = dict(R=R_cur, t=t_cur, kf_R=R_new, kf_t=t_new, prev_R=R_prev, prev_t=t_prev,
                      inrun_corrections=st.inrun_corrections + 1)

        def sel(new, old):
            return torch.where(apply, new, old)

        return st._replace(
            keyframes=kfs._replace(R=sel(R_opt, kfs.R), t=sel(t_opt, kfs.t)),
            map=st.map._replace(pos=sel(moved, st.map.pos)),
            ekf=st.ekf._replace(x=sel(x, st.ekf.x)),
            **{k: sel(folded[k], getattr(st, k)) for k in _FOLDED},
        )


def run_posthoc_pgo(result: RunResult, config: SlamConfig, gravity=None, initial_height=0.0):
    """Post-hoc PGO over the keyframe ring, loop constraints and height
    prior (`Optimizer.cpp:654-863`), then the trajectory and map-point
    corrections. Returns a new RunResult (raw and smoothed corrected)."""
    st = result.final_state
    kfs = st.keyframes
    dev = kfs.R.device
    if not tracking._cond(torch.sum(kfs.valid) >= 2):
        return result
    with f32_matmuls():
        R_opt, t_opt, t_corr, t_corr_s, moved = _pgo_pass(
            st, _to_dev(result.R, dev), _to_dev(result.t, dev), _to_dev(result.t_smoothed, dev),
            None if gravity is None else _to_dev(np.asarray(gravity, np.float32), dev),
            initial_height, config)
    return RunResult(
        timestamps=result.timestamps, R=result.R, t=t_corr.cpu().numpy(),
        t_smoothed=t_corr_s.cpu().numpy(), outputs=result.outputs,
        final_state=st._replace(map=st.map._replace(pos=moved),
                                keyframes=kfs._replace(R=R_opt, t=t_opt)),
    )


# ----------------------------------------------------------------------------
# Bundle adjustment over the keyframe chain
# ----------------------------------------------------------------------------


def _set_rows(base, dest, values):
    """`base.at[dest].set(values, mode="drop")` for dest in [0, len(base)]
    (len(base) drops the row); the kept destinations are distinct."""
    n = base.shape[0]
    return torch.cat([base, base[:1]]).index_copy(0, dest.long(), values)[:n]


def _build_ba_obs(map_store, kfs, slots, config: SlamConfig, P: int, kf_chunk: int = 32):
    """The P map points with the most observations (ties to the lowest
    index, as XLA's top_k orders them), projected into every keyframe of
    `slots` and associated with its keypoints by the plain radius matcher.
    Returns (X (P, 3), uv (W, P, 2), mask (W, P), cand (P,))."""
    c = config.camera
    score = torch.where(map_store.valid, map_store.num_obs, -1)
    cand = torch.argsort(score, descending=True, stable=True)[:P]
    X, desc_pts, pt_ok = map_store.pos[cand], map_store.desc[cand], map_store.valid[cand]

    def per_kf(R, t, desc, xy, kp_valid):
        Rcw = R.T
        tcw = -(Rcw @ t)
        p_c = X @ Rcw.T + tcw
        uv_proj, front = cam.project(p_c, c.fx, c.fy, c.cx, c.cy)
        in_img = front & cam.in_image(uv_proj, c.width, c.height) & pt_ok
        mp_idx, kp_ok, _ = matching.radius_descriptor_match(
            desc, xy, kp_valid, desc_pts, uv_proj, in_img,
            radius_px=config.opt.ba_obs_radius_px, desc_thresh=config.opt.ba_obs_desc_threshold)
        return torch.where(kp_ok, mp_idx.long(), P)

    batched = torch.func.vmap(per_kf)
    slots = slots.long()
    dest = torch.cat([
        batched(kfs.R[s], kfs.t[s], kfs.desc[s], kfs.xy[s], kfs.kp_valid[s])
        for s in torch.split(slots, kf_chunk)
    ])
    W = slots.shape[0]
    # Keypoint pixels onto their matched points (a point is matched by at
    # most one keypoint of a keyframe); column P takes the unmatched.
    uv = torch.zeros((W, P + 1, 2), dtype=torch.float32, device=X.device)
    uv.scatter_(1, dest[..., None].expand(-1, -1, 2), kfs.xy[slots])
    mask = torch.zeros((W, P + 1), dtype=torch.bool, device=X.device)
    mask.scatter_(1, dest, True)
    return X, uv[:, :P], mask[:, :P], cand


def _ba_problem(kfs, slots, pose_ok, X, uv, mask, config: SlamConfig):
    c = config.camera
    dev = X.device
    mask = mask & pose_ok[:, None]
    return ba_ops.BAProblem(
        R=kfs.R[slots], t=kfs.t[slots], pose_valid=pose_ok, X=X,
        point_valid=torch.sum(mask, dim=0) >= 2, uv=uv, obs_valid=mask,
        fx=_f32(c.fx, dev), fy=_f32(c.fy, dev), cx=_f32(c.cx, dev), cy=_f32(c.cy, dev),
    )


def _ba_finish(kfs, map_pos, slots, t0_win, R_opt, t_opt, X_opt, cand, point_valid,
               res_R, res_t, res_t_smoothed, max_jump):
    """BA epilogue: per-keyframe jump gate (`Config.h:100`), keyframe
    write-back, trajectory correction, refined points written back."""
    accept = se3.norm(t_opt - t0_win) < max_jump
    KFC = kfs.R.shape[0]
    dest = torch.where(accept, slots, KFC)
    R_new = _set_rows(kfs.R, dest, R_opt)
    t_new = _set_rows(kfs.t, dest, t_opt)
    frame_ids = torch.arange(res_t.shape[0], dtype=torch.float32, device=res_t.device)
    _, t_corr = pgo.correct_trajectory(frame_ids, res_R, res_t, kfs.frame_id, kfs.valid,
                                       kfs.R, kfs.t, R_new, t_new)
    _, t_corr_s = pgo.correct_trajectory(frame_ids, res_R, res_t_smoothed, kfs.frame_id,
                                         kfs.valid, kfs.R, kfs.t, R_new, t_new)
    pos_new = _set_rows(map_pos, torch.where(point_valid, cand, map_pos.shape[0]), X_opt)
    return R_new, t_new, t_corr, t_corr_s, pos_new


def _holdout_mask(W: int, P: int, frac: float, device):
    """The deterministic ~`frac` of the (W, P) observation grid withheld
    from the solve: (i * 2654435761 + j * 40503) mod 2^32 mod 1000 <
    1000 frac, the JAX package's uint32 hash (computed in int64)."""
    ii = torch.arange(W, dtype=torch.int64, device=device)[:, None]
    jj = torch.arange(P, dtype=torch.int64, device=device)[None, :]
    h = ((ii * 2654435761 + jj * 40503) & 0xFFFFFFFF) % 1000
    return h < int(frac * 1000)


def _ba_gated_solve(prob: ba_ops.BAProblem, config: SlamConfig, iterations: int):
    """The BA solve inside its gates, shared by the fused backend and
    `run_windowed_ba`: (1) significance (one counted read: skip a solve
    the accept gate would reject), (2) `ba_accept_window`, (3) with
    `opt.ba_holdout_frac` > 0, a lower Huber cost on the withheld
    observations (abstaining below 32 of them). Returns (R, t, X, accept)."""
    oc = config.opt
    frac = oc.ba_holdout_frac
    prob_val = None
    prob_train = prob
    if frac > 0.0:
        W_, P_ = prob.obs_valid.shape
        val_m = _holdout_mask(W_, P_, frac, prob.obs_valid.device) & prob.obs_valid
        train_m = prob.obs_valid & ~val_m
        prob_train = prob._replace(obs_valid=train_m,
                                   point_valid=prob.point_valid & (torch.sum(train_m, dim=0) >= 2))
        prob_val = prob._replace(obs_valid=val_m)
    sig = ba_ops.ba_significant(prob_train, huber_px=oc.ba_huber_px,
                                min_cost_per_obs=oc.ba_chain_min_cost_per_obs)
    if not tracking._cond(sig):
        return prob.R, prob.t, prob.X, torch.zeros((), dtype=torch.bool, device=sig.device)
    R_o, t_o, X_o, _ = ba_ops.bundle_adjust_robust(
        prob_train, iterations=iterations, huber_px=oc.ba_huber_px, gate2_px=oc.ba_gate_px,
        point_prior_weight=oc.ba_point_prior_weight, odo_trans_sigma=oc.ba_odom_trans_sigma,
        odo_rot_sigma=oc.ba_odom_rot_sigma, rtol=oc.ba_converge_rtol,
    )
    acc = ba_ops.ba_accept_window(prob_train, R_o, t_o, X_o, huber_px=oc.ba_huber_px,
                                  min_cost_per_obs=oc.ba_chain_min_cost_per_obs)
    if prob_val is not None:
        n_val = torch.sum(prob_val.obs_valid & prob_val.pose_valid[:, None]
                          & prob_val.point_valid[None, :])
        c_before = ba_ops.window_cost(prob_val, prob.R, prob.t, prob.X, huber_px=oc.ba_huber_px)
        c_after = ba_ops.window_cost(prob_val, R_o, t_o, X_o, huber_px=oc.ba_huber_px)
        acc = acc & ((n_val < 32) | (c_after < c_before))
    return R_o, t_o, X_o, acc


def _chain_order(kfs):
    """Valid keyframes by frame id, oldest first, invalid slots last (BA
    fixes the first pose's gauge, which must be a real keyframe)."""
    return torch.argsort(torch.where(kfs.valid, kfs.frame_id, _I32_MAX), stable=True)


def run_windowed_ba(result: RunResult, config: SlamConfig, window: Optional[int] = None):
    """Post-hoc BA over the keyframe chain (`Optimizer.cpp:187-599`). By
    default the whole-chain problem of `run_backend`'s BA stage, solved on
    its own; `window=k` takes the last k valid keyframes. Observations
    come from projecting the map into each keyframe and radius-matching
    descriptors; the refined keyframe poses correct the trajectory through
    the interpolation pass, gated by `opt.ba_max_jump`."""
    st = result.final_state
    kfs = st.keyframes
    oc = config.opt
    dev = kfs.R.device
    kf_valid = kfs.valid.cpu().numpy()
    valid_slots = np.nonzero(kf_valid)[0]
    if len(valid_slots) < 3:
        return result
    iterations = oc.max_iterations
    if window is None:
        slots = _chain_order(kfs)
        P = oc.ba_global_max_points
        iterations = oc.ba_global_iterations
    else:
        order = np.argsort(kfs.frame_id.cpu().numpy()[valid_slots], kind="stable")
        slots = torch.as_tensor(valid_slots[order][-window:]).to(dev)
        P = oc.ba_max_points
    if not tracking._cond(torch.sum(st.map.valid) >= 16):
        return result
    with f32_matmuls():
        X, uv, mask, cand = _build_ba_obs(st.map, kfs, slots, config, P)
        pose_ok = kfs.valid[slots]
        prob = _ba_problem(kfs, slots, pose_ok, X, uv, mask, config)
        R_opt, t_opt, X_opt, accept = _ba_gated_solve(prob, config, iterations)
        R_opt = torch.where(accept, R_opt, prob.R)
        t_opt = torch.where(accept, t_opt, prob.t)
        X_opt = torch.where(accept, X_opt, prob.X)
        # Invalid padding rows never write back to the ring.
        slots_wb = torch.where(pose_ok, slots, kfs.R.shape[0])
        R_new, t_new, t_corr, t_corr_s, pos_new = _ba_finish(
            kfs, st.map.pos, slots_wb, prob.t, R_opt, t_opt, X_opt, cand, prob.point_valid,
            _to_dev(result.R, dev), _to_dev(result.t, dev), _to_dev(result.t_smoothed, dev),
            oc.ba_max_jump)
    return RunResult(
        timestamps=result.timestamps, R=result.R, t=t_corr.cpu().numpy(),
        t_smoothed=t_corr_s.cpu().numpy(), outputs=result.outputs,
        final_state=st._replace(map=st.map._replace(pos=pos_new),
                                keyframes=kfs._replace(R=R_new, t=t_new)),
    )


def _backend_pass(st: TrackState, res_R, res_t, res_t_smoothed, gravity_opt, initial_height,
                  config: SlamConfig):
    """Post-hoc PGO (with >= 2 keyframes), then whole-chain BA over the
    PGO result (with >= 3 keyframes and >= 16 map points), each gated.
    Returns (R, t, t_corr, t_corr_s, pos)."""
    kfs = st.keyframes
    oc = config.opt
    if tracking._cond(torch.sum(kfs.valid) >= 2):
        R1, t1, t_corr, t_corr_s, pos1 = _pgo_pass(st, res_R, res_t, res_t_smoothed,
                                                   gravity_opt, initial_height, config)
    else:
        R1, t1, t_corr, t_corr_s, pos1 = kfs.R, kfs.t, res_t, res_t_smoothed, st.map.pos
    kfs1 = kfs._replace(R=R1, t=t1)
    map1 = st.map._replace(pos=pos1)
    KFC = kfs1.R.shape[0]
    order = _chain_order(kfs1)
    can_ba = (torch.sum(kfs1.valid) >= 3) & (torch.sum(map1.valid) >= 16)
    if not (oc.enable_local_ba and tracking._cond(can_ba)):
        return R1, t1, t_corr, t_corr_s, pos1
    pose_ok = kfs1.valid[order]
    X, uv, mask, cand = _build_ba_obs(map1, kfs1, order, config, oc.ba_global_max_points)
    prob = _ba_problem(kfs1, order, pose_ok, X, uv, mask, config)
    R_opt, t_opt, X_opt, accept = _ba_gated_solve(prob, config, oc.ba_global_iterations)
    # Per-keyframe jump gate (`Config.h:100`) and the padding guard.
    ok_vec = accept & pose_ok & (se3.norm(t_opt - prob.t) < oc.ba_max_jump)
    dest = torch.where(ok_vec, order, KFC)
    R2 = _set_rows(kfs1.R, dest, R_opt)
    t2 = _set_rows(kfs1.t, dest, t_opt)
    pos2 = _set_rows(map1.pos, torch.where(accept & prob.point_valid, cand, map1.pos.shape[0]),
                     X_opt)
    frame_ids = torch.arange(res_t.shape[0], dtype=torch.float32, device=res_t.device)
    _, t_corr2 = pgo.correct_trajectory(frame_ids, res_R, t_corr, kfs1.frame_id, kfs1.valid,
                                        kfs1.R, kfs1.t, R2, t2)
    _, t_corr2_s = pgo.correct_trajectory(frame_ids, res_R, t_corr_s, kfs1.frame_id,
                                          kfs1.valid, kfs1.R, kfs1.t, R2, t2)
    return R2, t2, t_corr2, t_corr2_s, pos2


def run_backend(result: RunResult, config: SlamConfig, gravity=None, initial_height=0.0):
    """Post-hoc PGO, then whole-chain BA (`_backend_pass`), on the device
    of the result's state; `run_windowed_ba(run_posthoc_pgo(result,
    config), config)` in one pass. Both stages are gain-gated: on a
    healthy run the trajectory comes back unchanged."""
    st = result.final_state
    dev = st.R.device
    with f32_matmuls():
        R2, t2, t_corr, t_corr_s, pos2 = _backend_pass(
            st, _to_dev(result.R, dev), _to_dev(result.t, dev), _to_dev(result.t_smoothed, dev),
            None if gravity is None else _to_dev(np.asarray(gravity, np.float32), dev),
            initial_height, config)
    return RunResult(
        timestamps=result.timestamps, R=result.R, t=t_corr.cpu().numpy(),
        t_smoothed=t_corr_s.cpu().numpy(), outputs=result.outputs,
        final_state=st._replace(map=st.map._replace(pos=pos2),
                                keyframes=st.keyframes._replace(R=R2, t=t2)),
    )


def run_synthetic(seq, config: SlamConfig, use_imu=True, seed: int = 42, smooth=True,
                  chunk=None, device="cuda"):
    """A feature-level synthetic sequence end to end: gravity and
    stationarity from its accelerometer, tracking, smoothing. Returns
    (RunResult, ATE of the smoothed trajectory)."""
    from vslam_tpu_torch.eval import ate as ate_mod

    gravity, h0 = (None, 0.0)
    stationary = None
    if use_imu:
        gravity, h0 = compute_gravity_direction(seq.accel, np.eye(3, dtype=np.float32))
        stationary = detect_stationary(seq.accel, seq.timestamps)
    frames = features_from_synthetic(seq, stationary=stationary, device=device)
    result = run_tracking(frames, config, gravity=gravity, initial_height=h0, seed=seed,
                          smooth=smooth, chunk=chunk, device=device)
    ate_res = ate_mod.compute_ate(result.timestamps, result.t_smoothed, seq.timestamps, seq.t,
                                  with_scale=False)
    return result, ate_res
