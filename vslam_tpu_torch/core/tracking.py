"""The per-frame tracking step.

Port of `vslam_tpu/core/tracking.py:40-1167`: descriptor matching ->
fundamental gate -> 3D-3D RANSAC (or Essential + depth scale) -> EKF
fusion -> recovery -> local-map tracking -> PnP refinement -> keyframe
creation with triangulation + depth back-projection -> reprojection cull
-> periodic PnP -> loop-closure match and verify.

One body, `_track`, runs the step for a list of members: one for
`tracking_step`, B for `core.tracking_batched.tracking_step_batched` (the
JAX package's vmapped step). Every `lax.cond` of the JAX step becomes a
Python `if` on predicates read back from the device, all members' at once
(`_read`: one host sync, counted in `STATS["branch_reads"]` and, while the
span recorder of `utils.profiling` is on, charged to the innermost open
span); a hoisted block (bootstrap, bridge, essential fallback, recovery,
keyframe creation, periodic PnP, loop closure) then runs only for the
members whose predicate is set, so a member's ring is never written for
a block it skips. Where both branches are cheap the port selects with
`torch.where` and reads nothing. Those reads are meant to be the step's
only waits on the card: indexing by a device scalar, small constants and
the RANSAC draws go through `ops.device`. The always-on blocks run member
by member; the local map radius-matches all members in one call. The
step runs in full f32 (`linalg.f32_matmuls`).

Pure device work between two reads is a device function of flat tensors
that, on CUDA inputs, replays a captured CUDA graph (`ops.graphs`; the
members share one graph per function): the epipolar RANSACs
(`ops.ransac`), the 3D-3D half of `step.motion`, `_rigid_motion`
(keypoint depths, backprojection, translation cap and the Kabsch
RANSAC), and the two halves of `step.pose`, `_pose_fusion` (EKF fusion
and the recovery override) and `_pose_refinement` (GN-PnP refine and the
keyframe policy, up to the read of `is_kf`). CPU inputs run the same
functions eagerly.

Spans (`utils.profiling.span`, no-ops while the recorder is off; `frames`
the member-frames a block covers): `step` around each `tracking_step`,
and inside it one per block: `step.bootstrap` (the first frame),
`step.match` (keyframe match, bridge, F-gate), `step.motion` (motion
estimate, PnP recovery when due), `step.pose` (EKF fusion; later PnP
refinement and the keyframe decision, a second span), `step.map`
(local-map tracking with the radius kernel), `step.keyframe` (keyframe
frames only: insert, periodic PnP, re-pose, loop closure) and
`step.finish` (`_finish` and `contiguous_tree`). A span reads no device
value: the wait at a branch read lands in the block that reads.

In place: the keyframe ring (`state.keyframes`, 52 MB of descriptors at
the default capacity) is written in place when a keyframe is pushed or
re-posed, so `tracking_step` updates the ring of the state it is given;
every other field is replaced functionally. `core.coupled.run_coupled`
works on a copy of the state it is handed.

Random keys are the port's bit-exact threefry keys (`ops.prng`), kept on
the host.
"""

from __future__ import annotations

from itertools import compress
from types import SimpleNamespace
from typing import List, Tuple

import torch

from vslam_tpu_torch.config import SlamConfig
from vslam_tpu_torch.core.state import (
    FrameFeatures,
    KeyframeStore,
    MapStore,
    StepOutputs,
    TrackState,
    contiguous_tree,
)
from vslam_tpu_torch.ops import camera as cam
from vslam_tpu_torch.ops import device
from vslam_tpu_torch.ops import ekf as ekf_ops
from vslam_tpu_torch.ops import epipolar as epi_ops
from vslam_tpu_torch.ops import graphs
from vslam_tpu_torch.ops import matching
from vslam_tpu_torch.ops import pnp as pnp_ops
from vslam_tpu_torch.ops import prng
from vslam_tpu_torch.ops import ransac as rs
from vslam_tpu_torch.ops import scale as scale_ops
from vslam_tpu_torch.ops import se3
from vslam_tpu_torch.ops import triangulate as tri
from vslam_tpu_torch.ops.linalg import f32_matmuls
from vslam_tpu_torch.utils import profiling

# Counters a caller can read after a run: frames that took the tracking
# branch (not bootstrap), branch predicates read back from the device, and
# for each hoisted block the member-frames it ran for.
STATS = {"track_frames": 0, "branch_reads": 0, "bootstrap": 0, "bridge": 0, "essential": 0,
         "recover": 0, "keyframe": 0, "periodic_pnp": 0, "loop": 0}


def reset_stats():
    for k in STATS:
        STATS[k] = 0


def _read(preds) -> List[bool]:
    """Read 0-d branch predicates back from the device at once (one host
    sync: `bool` of one, `tolist` of the stack of several), counted in
    `STATS` and charged to the innermost open span."""
    STATS["branch_reads"] += 1
    profiling.count_read()
    if len(preds) == 1:
        return [bool(preds[0])]
    return torch.stack(preds).tolist()


def _cond(pred: torch.Tensor) -> bool:
    """Read one branch predicate back from the device (`_read`)."""
    return _read([pred])[0]


def _hoisted(block: str, records, attr: str, runs_if: bool = True) -> List[bool]:
    """For each record, whether hoisted `block` runs for it: its predicate
    `attr`, read back for all records at once, equals `runs_if`. Counts the
    member-frames it runs for; reads nothing when no record is left."""
    if not records:
        return []
    runs = [on == runs_if for on in _read([getattr(x, attr) for x in records])]
    STATS[block] += sum(runs)
    return runs


def _intr(config):
    c = config.camera
    return c.fx, c.fy, c.cx, c.cy


def _tree_where(c, a, b):
    return type(a)(*(torch.where(c, x, y) for x, y in zip(a, b)))


def _scatter_set(base, idx, mask, value):
    """`base.at[where(mask, idx, OOB)].set(value, mode="drop")` for a
    Python `value`, without a host sync: masked-off writes go to a spare
    slot that is cut off."""
    n = base.shape[0]
    ext = torch.cat([base, base[:1]])
    tgt = torch.where(mask, idx.long(), n)
    return ext.index_fill_(0, tgt, value)[:n]


def frame_at(frames: FrameFeatures, i: int) -> FrameFeatures:
    """Frame i of a stacked FrameFeatures batch."""
    return FrameFeatures(*(x[i] for x in frames))


def _single_view_scale(R_rel, t_rel, p_kf, xn_cur, valid):
    """Monocular scale from KF depth: per-match closed-form x/y scales,
    masked median over valid entries."""
    Rp = se3.rotate_rows(R_rel, p_kf)
    num_x = xn_cur[:, 0] * Rp[:, 2] - Rp[:, 0]
    den_x = t_rel[0] - xn_cur[:, 0] * t_rel[2]
    num_y = xn_cur[:, 1] * Rp[:, 2] - Rp[:, 1]
    den_y = t_rel[1] - xn_cur[:, 1] * t_rel[2]
    sx = num_x / torch.where(torch.abs(den_x) < 1e-6, torch.inf, den_x)
    sy = num_y / torch.where(torch.abs(den_y) < 1e-6, torch.inf, den_y)
    s_all = torch.cat([sx, sy])
    v_all = torch.cat([valid, valid]) & torch.isfinite(s_all) & (s_all > 0)
    s_sorted = torch.sort(torch.where(v_all, s_all, torch.inf)).values
    n = torch.sum(v_all)
    med = device.take(s_sorted, torch.clamp(n // 2, 0, s_all.shape[0] - 1))
    return torch.where(n >= 3, med, -1.0), n


def _masked_free_slot_insert(map_store: MapStore, new_pos, new_desc, new_valid, kf_id,
                             protect=None):
    """Insert up to K new points into map slots: free slots first, then
    the weakest established points (lowest found/visible ratio among
    points >= 3 keyframes old); young and `protect`ed slots are never
    evicted. Returns (map_store, slot_of_new (K,) with -1 = not inserted)."""
    M = map_store.valid.shape[0]
    K = new_valid.shape[0]
    dev = new_valid.device
    new_desc = new_desc.to(map_store.desc.dtype)
    free = ~map_store.valid
    n_new = torch.sum(new_valid)
    order = torch.argsort(torch.where(new_valid, 0, 1), stable=True)
    pos_c = new_pos[order]
    desc_c = new_desc[order]
    PROT = 1e9
    age = kf_id - map_store.first_kf
    ratio = map_store.found / torch.clamp(map_store.visible, min=1).to(torch.float32)
    dest_key = torch.where(free, 0.0, torch.where(age >= 3, 1.0 + ratio, PROT))
    if protect is not None:
        dest_key = torch.where(free, dest_key, torch.where(protect, PROT, dest_key))
    dest_order = torch.argsort(dest_key, stable=True)
    dest_rank = torch.empty(M, dtype=torch.int64, device=dev)
    dest_rank[dest_order] = torch.arange(M, device=dev)
    take = (dest_rank < n_new) & (dest_key < PROT)
    src = torch.clamp(dest_rank, 0, K - 1)
    pos_new = torch.where(take[:, None], pos_c[src], map_store.pos)
    desc_new = torch.where(take[:, None], desc_c[src], map_store.desc)
    one = torch.ones((), dtype=torch.int32, device=dev)
    new_map = MapStore(
        pos_new, desc_new, map_store.valid | take,
        torch.where(take, one, map_store.visible),
        torch.where(take, one, map_store.found),
        torch.where(take, kf_id.to(torch.int32), map_store.first_kf),
        torch.where(take, one, map_store.num_obs),
    )
    slot_of_rank = torch.full((K,), -1, dtype=torch.int64, device=dev)
    slot_ids = torch.arange(M, device=dev)
    slot_of_rank = slot_of_rank.scatter_reduce(
        0, torch.where(take, src, K - 1), torch.where(take, slot_ids, -1),
        reduce="amax", include_self=True,
    )
    rank_of_orig = torch.cumsum(new_valid.long(), 0) - 1
    slot_of_new = torch.where(
        new_valid & (rank_of_orig < torch.sum(take)),
        slot_of_rank[torch.clamp(rank_of_orig, 0, K - 1)],
        -1,
    )
    return new_map, slot_of_new.to(torch.int32)


def _match_to_keyframe(state: TrackState, frame: FrameFeatures, config: SlamConfig, key):
    """Descriptor match against the active keyframe."""
    m = matching.knn2_ratio_match(
        state.kf_desc, frame.desc, state.kf_valid, frame.valid,
        ratio=config.frontend.l2_ratio_threshold,
        mutual=config.frontend.mutual_check,
        max_dist=config.frontend.l2_max_distance or None,
    )
    uv_cur = frame.xy[m.idx.long()]
    return m, state.kf_xy, uv_cur, m.valid, torch.sum(m.valid)


def _fundamental_gate(uv_kf, uv_cur, gated, config, key):
    """Main-path fundamental RANSAC gate + mean symmetric epipolar error
    before/after. Returns (gated', epi_before, epi_after)."""
    mc = config.motion
    F, fres = rs.ransac_fundamental(
        key, uv_kf, uv_cur, gated,
        num_hypotheses=mc.fm_ransac_iters, threshold_px=mc.fm_ransac_threshold_px,
    )
    gated_new = torch.where(fres.ok, gated & fres.inlier_mask, gated)
    d = epi_ops.epipolar_distance(F, uv_kf, uv_cur)

    def masked_mean(mask):
        return torch.sum(d * mask) / torch.clamp(torch.sum(mask), min=1)

    epi_before = torch.where(fres.ok, masked_mean(gated), 0.0)
    epi_after = torch.where(fres.ok, masked_mean(gated_new), 0.0)
    return gated_new, epi_before, epi_after


def _rigid_motion(u, depth_kf, depth, idx, uv_kf, uv_cur, gated, frame_id, kf_frame_id, intr,
                  depth_min, depth_max, inlier_thresh, max_translation, max_translation_per_frame,
                  min_translation, min_inliers):
    """The 3D-3D half of `step.motion` as a device function of flat tensors
    (`ops.graphs`), `u` the RANSAC's host draw, `intr` the intrinsics:
    the current keypoints' depths, both sets backprojected, the
    translation cap of the keyframe gap, the Kabsch RANSAC.
    Returns (R3, t3, inliers, count, ok, p_kf, p_cur, d_ok)."""
    fx, fy, cx, cy = intr
    depth_cur = depth[idx.long()]
    d_ok = ((depth_kf > depth_min) & (depth_kf < depth_max)
            & (depth_cur > depth_min) & (depth_cur < depth_max))
    valid3d = gated & d_ok
    p_kf = cam.backproject(uv_kf, depth_kf, fx, fy, cx, cy)
    p_cur = cam.backproject(uv_cur, depth_cur, fx, fy, cx, cy)
    max_t = max_translation
    if max_translation_per_frame > 0:
        gap = (frame_id - kf_frame_id).to(p_kf.dtype)
        max_t = torch.clamp(gap * max_translation_per_frame, min=max_t)
    R3, t3, inl, n_inl, ok = rs._kabsch_3d3d(u, p_kf, p_cur, valid3d, max_t, inlier_thresh,
                                             min_translation, min_inliers)
    return R3, t3, inl, n_inl, ok, p_kf, p_cur, d_ok


def _motion_3d3d(state, frame, config, m, uv_kf, uv_cur, gated, key):
    """3D-3D RANSAC part of motion estimation: the host draw, then on CUDA
    inputs a replay of `_rigid_motion`'s graph.
    Returns (R3, t3, res3, p_kf, p_cur, d_ok)."""
    mc = config.motion
    cc = config.camera
    u = rs.draw_minimal_sets(key, gated.shape[-1], mc.r3d_iters, 3)
    R3, t3, inl, n_inl, ok, p_kf, p_cur, d_ok = graphs.call(
        _rigid_motion,
        (_intr(config), cc.depth_min, cc.depth_max, mc.r3d_inlier_thresh,
         mc.r3d_max_translation, mc.r3d_max_translation_per_frame, mc.r3d_min_translation,
         config.frontend.min_inliers),
        (u, state.kf_depth, frame.depth, m.idx, uv_kf, uv_cur, gated, frame.frame_id,
         state.kf_frame_id))
    return R3, t3, rs.RansacResult(inl, n_inl, ok), p_kf, p_cur, d_ok


def _scale_with_ekf_prior(scale, state, frame, mc):
    """EKF scale prior for the essential fallback."""
    dt = torch.clamp(frame.timestamp - state.last_time, min=0.0)
    x = state.ekf.x
    s_pred = se3.norm(x[:3] + x[3:] * dt - state.kf_t)
    pred_ok = (s_pred > 1e-4) & state.tracking_ok
    agree = torch.abs(scale - s_pred) <= mc.mono_scale_gate * s_pred
    s_gated = torch.where(agree, 0.5 * (scale + s_pred), s_pred)
    return torch.where(pred_ok, s_gated, scale)


def _motion_essential(state, frame, config, uv_kf, uv_cur, gated, p_kf, p_cur, d_ok, key):
    """Essential fallback + depth-derived scale (runs only when 3D-3D
    fails). Returns (Re, te_scaled, ok, n_inliers, new_scale)."""
    fx, fy, cx, cy = _intr(config)
    mc = config.motion
    cc = config.camera
    depth_kf = state.kf_depth
    kf1, kf2 = prng.split(key, 2)
    if mc.fgate_main_path:
        gated_f = gated
    else:
        _, fres = rs.ransac_fundamental(
            kf1, uv_kf, uv_cur, gated,
            num_hypotheses=mc.fm_ransac_iters, threshold_px=mc.fm_ransac_threshold_px,
        )
        gated_f = torch.where(fres.ok, gated & fres.inlier_mask, gated)
    Re, te, _, rese = rs.ransac_essential(
        kf2, uv_kf, uv_cur, gated_f, fx, fy, cx, cy,
        num_hypotheses=mc.em_ransac_iters, threshold_px=mc.em_ransac_threshold_px,
        min_inliers=config.frontend.min_inliers,
    )
    xn_cur = cam.normalize_pixels(uv_cur, fx, fy, cx, cy)
    kf_d_ok = (depth_kf > cc.depth_min) & (depth_kf < cc.depth_max)
    s2v, ok2v = scale_ops.two_view_scale(
        Re, te, p_kf, p_cur, gated & d_ok & rese.inlier_mask, min_matches=10
    )
    s1v, _ = _single_view_scale(Re, te, p_kf, xn_cur, gated & kf_d_ok & rese.inlier_mask)
    s_med = torch.where(ok2v, s2v, s1v)
    scale = torch.where(s_med > 0, s_med, state.last_scale)
    if mc.mono_scale_ekf_prior:
        scale = _scale_with_ekf_prior(scale, state, frame, mc)
    new_scale = torch.where(scale > 0, scale, state.last_scale)
    return Re, te * scale, rese.ok, rese.num_inliers, new_scale


def _essential_skipped(state, R3, t3, res3):
    """What the essential branch yields where 3D-3D was used: the 3D-3D
    estimate itself (so that the selects below keep it)."""
    return R3, t3, res3.ok, res3.num_inliers, state.last_scale


def _compose_motion(state, use_3d3d, R3, t3, res3, ess, gated, d_ok):
    """World pose from the 3D-3D or the essential estimate `ess` =
    (Re, te_scaled, ok, n_inliers, new_scale).
    Returns (R_new, t_new, motion_ok, n_inliers, new_scale, n_depth_ok)."""
    Re, te_s, e_ok, e_ninl, new_scale_e = ess
    R_rel = torch.where(use_3d3d, R3, Re)
    t_rel = torch.where(use_3d3d, t3, te_s)
    R_new = state.kf_R @ R_rel.T
    t_new = state.kf_t - R_new @ t_rel
    motion_ok = use_3d3d | e_ok
    n_inl = torch.where(use_3d3d, res3.num_inliers, e_ninl)
    new_scale = torch.where(use_3d3d, state.last_scale, new_scale_e)
    n_dok = torch.sum(gated & d_ok).to(torch.int32)
    return R_new, t_new, motion_ok, n_inl, new_scale, n_dok


def _fuse_ekf(state: TrackState, frame, config, t_meas, used_3d3d, motion_ok):
    """EKF predict + gated visual update + height + clamp.
    Returns (ekf_state, fused_pos, snapshot)."""
    return _ekf_fusion(state.ekf, state.t, state.last_time, state.frame_idx, state.gravity,
                       state.initial_height, state.has_height, frame.timestamp, t_meas,
                       used_3d3d, motion_ok, config.ekf)


def _ekf_fusion(ekf, t, last_time, frame_idx, gravity, initial_height, has_height, timestamp,
                t_meas, used_3d3d, motion_ok, ec):
    """`_fuse_ekf` on the state's leaves, `ec` the EKF constants."""
    st = _tree_where(ekf.initialized, ekf, ekf_ops.initialize(t, timestamp))
    dt = timestamp - last_time
    dt = torch.where(frame_idx == 0, 0.0, dt)
    st = ekf_ops.predict(st, dt, sigma_a=ec.process_accel, decay=ec.vel_decay)
    x_pred, P_pred = st.x, st.P
    sigma = torch.where(used_3d3d, ec.sigma_vis_3d3d, ec.sigma_vis_emat)
    st = ekf_ops.update_visual_gated(st, t_meas, sigma, gate=ec.innovation_gate,
                                     enabled=motion_ok)
    st = ekf_ops.update_height(st, gravity, initial_height, ec.sigma_height,
                               enabled=has_height)
    P_filt = st.P
    st, fused = ekf_ops.clamp_step(st, t, dt, max_step=ec.max_step)
    return st, fused, (x_pred, P_pred, st.x, P_filt, dt)


def _project_map(map_store: MapStore, config, R_new, t_new):
    """Map points into the camera at (R_new, t_new).
    Returns (uv (M, 2), visible mask (M,): valid, in front, in the image)."""
    fx, fy, cx, cy = _intr(config)
    Rcw, tcw = se3.inverse(R_new, t_new)
    p_c = se3.transform_points(Rcw, tcw, map_store.pos)
    uv_mp, front = cam.project(p_c, fx, fy, cx, cy)
    in_img = front & cam.in_image(uv_mp, config.camera.width, config.camera.height)
    return uv_mp, map_store.valid & in_img


def _count_found(map_store: MapStore, config, visible_mask, min_pix_d2):
    """The visible/found counters after a local-map match."""
    r2 = config.map.track_visibility_radius_px ** 2
    found_inc = visible_mask & (min_pix_d2 < r2)
    return map_store._replace(
        visible=map_store.visible + visible_mask.to(torch.int32),
        found=map_store.found + found_inc.to(torch.int32),
    )


def _track_local_maps(sts, frs, config, R_new, t_new):
    """Local-map tracking for a list of members: project each member's map
    at its pose, radius-match (one member: `radius_descriptor_match_fused`;
    several: `radius_descriptor_match_fused_batched`, one kernel launch on
    the card, handed each member's own tensors), update the visible/found
    counters. Returns (mp_idx, kp_ok, map'), each a list over the members."""
    proj = [_project_map(s.map, config, R, t) for s, R, t in zip(sts, R_new, t_new)]
    args = ([f.desc for f in frs], [f.xy for f in frs], [f.valid for f in frs],
            [s.map.desc for s in sts], [p[0] for p in proj], [p[1] for p in proj])
    kw = dict(radius_px=config.map.track_search_radius_px,
              desc_thresh=config.map.track_desc_threshold)
    if len(sts) == 1:
        mp_idx, kp_ok, _, min_pix_d2 = (
            [y] for y in matching.radius_descriptor_match_fused(*(a[0] for a in args), **kw))
    else:
        mp_idx, kp_ok, _, min_pix_d2 = matching.radius_descriptor_match_fused_batched(*args,
                                                                                      **kw)
    maps = [_count_found(s.map, config, p[1], d2) for s, p, d2 in zip(sts, proj, min_pix_d2)]
    return list(mp_idx), list(kp_ok), maps


def _track_local_map(state: TrackState, frame, config, R_new, t_new):
    """`_track_local_maps` for one member. Returns (mp_idx, kp_ok, map')."""
    return tuple(y[0] for y in _track_local_maps([state], [frame], config, [R_new], [t_new]))


def _refine_pnp(state, frame, config, R_new, t_new, mp_idx, kp_ok, key):
    """Local PnP refinement (Huber GN from the current pose) with adaptive
    0.3..0.5 blending and a jump gate. `key` is unused."""
    return _pnp_blend(state.map.pos, frame.xy, R_new, t_new, mp_idx, kp_ok, _intr(config),
                      config.pnp)


def _pnp_blend(pos, xy, R_new, t_new, mp_idx, kp_ok, intr, pc):
    """`_refine_pnp` on the map's positions and the frame's keypoints,
    `intr` the intrinsics, `pc` the PnP constants."""
    fx, fy, cx, cy = intr
    X = pos[torch.clamp(mp_idx.long(), 0, pos.shape[0] - 1)]
    n_corr = torch.sum(kp_ok)
    R_cw0 = R_new.T
    t_cw0 = -R_cw0 @ t_new
    R_cw, t_cw = pnp_ops.gn_refine_pose(
        R_cw0, t_cw0, X, xy, kp_ok.to(X.dtype), fx, fy, cx, cy,
        iters=pc.refine_gn_iters, huber_px=pc.ransac_threshold_px * 0.5,
    )
    R_pnp, t_pnp = se3.inverse(R_cw, t_cw)
    uv_f, front_f = cam.project(se3.transform_points(R_cw, t_cw, X), fx, fy, cx, cy)
    inl = (se3.norm(uv_f - xy) < pc.ransac_threshold_px) & front_f & kp_ok
    n_inl = torch.sum(inl)
    ok = n_inl >= pc.min_points
    blend = 0.3 + 0.2 * torch.clamp(n_inl / torch.clamp(n_corr, min=1), 0.0, 1.0)
    jump = se3.norm(t_pnp - t_new)
    apply = ok & (n_corr >= pc.min_points) & (jump < pc.refine_max_jump)
    t_ref = t_new + blend * (t_pnp - t_new)
    w = se3.log_so3(R_pnp @ R_new.T)
    R_ref = se3.exp_so3(w * blend) @ R_new
    R_out = torch.where(apply, R_ref, R_new)
    t_out = torch.where(apply, t_ref, t_new)
    R_full = torch.where(apply, R_pnp, R_new)
    t_full = torch.where(apply, t_pnp, t_new)
    return R_out, t_out, torch.where(apply, n_inl, 0), R_full, t_full


def _reproject_cull(map_store: MapStore, frame, config, R_new, t_new, mp_idx, kp_ok):
    """Invalidate this keyframe's observed map points that land behind the
    camera or reproject more than cull_reproj_px from their keypoint."""
    fx, fy, cx, cy = _intr(config)
    M = map_store.valid.shape[0]
    X = map_store.pos[torch.clamp(mp_idx.long(), 0, M - 1)]
    Rcw, tcw = se3.inverse(R_new, t_new)
    p_c = se3.transform_points(Rcw, tcw, X)
    uv, _ = cam.project(p_c, fx, fy, cx, cy)
    err2 = torch.sum((uv - frame.xy) ** 2, dim=-1)
    bad = kp_ok & ((p_c[:, 2] < config.camera.depth_min)
                   | (err2 > config.map.cull_reproj_px ** 2))
    return map_store._replace(valid=_scatter_set(map_store.valid, mp_idx, bad, False))


def _periodic_pnp(st: TrackState, frame, config, R_new, t_new, mp_idx, kp_ok, key):
    """Fresh RANSAC-PnP over this frame's observed map points every Nth
    keyframe, jump gate + blend. Returns (R, t)."""
    fx, fy, cx, cy = _intr(config)
    pc = config.pnp
    M = st.map.pos.shape[0]
    ci = torch.clamp(mp_idx.long(), 0, M - 1)
    X = st.map.pos[ci]
    ok = kp_ok & st.map.valid[ci]
    res = pnp_ops.ransac_pnp(
        key, X, frame.xy, ok, fx, fy, cx, cy, num_hypotheses=pc.ransac_iters,
        threshold_px=pc.ransac_threshold_px, min_inliers=pc.min_points,
        gn_iters=pc.gn_iters,
    )
    jump = se3.norm(res.t - t_new)
    apply = res.ok & (jump < pc.periodic_max_jump)
    b = pc.periodic_blend
    t_b = t_new + b * (res.t - t_new)
    R_b = se3.exp_so3(se3.log_so3(res.R @ R_new.T) * b) @ R_new
    return torch.where(apply, R_b, R_new), torch.where(apply, t_b, t_new)


def _make_keyframe(state: TrackState, frame, config, R_new, t_new, m, gated, protect=None):
    """Keyframe creation: triangulate gated matches (sensor depth
    overrides), back-project unmatched keypoints with depth, insert as map
    points, push to the ring (in place), cull every cull_interval_kfs."""
    fx, fy, cx, cy = _intr(config)
    mc = config.map
    cc = config.camera
    K = frame.xy.shape[0]
    idx = m.idx.long()
    uv_kf = state.kf_xy
    uv_cur = frame.xy[idx]
    X_tri, tri_ok = tri.triangulate_two_view(
        state.kf_R, state.kf_t, R_new, t_new, uv_kf, uv_cur, fx, fy, cx, cy,
        min_depth=mc.triang_min_depth, max_depth=mc.triang_max_depth,
        max_reproj_px=mc.triang_max_reproj_px, max_cam_dist=mc.triang_max_cam_dist,
    )
    tri_ok = tri_ok & gated
    d_cur = frame.depth[idx]
    d_ok = (d_cur > cc.depth_min) & (d_cur < cc.depth_max)
    X_bp = se3.transform_points(R_new, t_new, cam.backproject(uv_cur, d_cur, fx, fy, cx, cy))
    X_new = torch.where((d_ok & gated)[:, None], X_bp, X_tri)
    pt_ok = (d_ok & gated) | tri_ok
    desc_new = frame.desc[idx]
    matched_kp = _scatter_set(torch.zeros(K, dtype=torch.bool, device=gated.device),
                              m.idx, gated, True)
    d_all = frame.depth
    bp_ok = frame.valid & ~matched_kp & (d_all > cc.depth_min) & (d_all < cc.depth_max)
    X_bp2 = se3.transform_points(R_new, t_new,
                                 cam.backproject(frame.xy, d_all, fx, fy, cx, cy))
    map2, _ = _masked_free_slot_insert(
        state.map, torch.cat([X_new, X_bp2]), torch.cat([desc_new, frame.desc]),
        torch.cat([pt_ok, bp_ok]), state.kf_count, protect=protect,
    )

    # Push to the keyframe ring, in place.
    kfs = state.keyframes
    slot = torch.remainder(state.kf_count, kfs.valid.shape[0])
    for ring, value in ((kfs.xy, frame.xy), (kfs.desc, frame.desc), (kfs.depth, frame.depth),
                        (kfs.kp_valid, frame.valid), (kfs.R, R_new), (kfs.t, t_new),
                        (kfs.R_anchor, R_new), (kfs.t_anchor, t_new),
                        (kfs.frame_id, frame.frame_id), (kfs.valid, True)):
        device.put_(ring, slot, value)

    do_cull = torch.remainder(state.kf_count + 1, mc.cull_interval_kfs) == 0
    age = state.kf_count - map2.first_kf
    ratio = map2.found / torch.clamp(map2.visible, min=1)
    cull = map2.valid & (
        ((age >= 3) & (map2.visible > 0) & (ratio < mc.cull_found_ratio_young))
        | ((age >= 5) & (map2.num_obs <= 2) & (ratio < mc.cull_found_ratio_old))
    )
    map3 = map2._replace(valid=torch.where(do_cull, map2.valid & ~cull, map2.valid))
    return state._replace(
        map=map3, keyframes=kfs, kf_xy=frame.xy, kf_desc=frame.desc,
        kf_depth=frame.depth, kf_valid=frame.valid, kf_R=R_new, kf_t=t_new,
        kf_frame_id=frame.frame_id, kf_count=state.kf_count + 1,
    )


def _try_pnp_recovery(st: TrackState, frame: FrameFeatures, config: SlamConfig, key):
    """Tracking-loss recovery against the whole map: top-2 ratio match vs
    every map point (the CUDA top-2 kernel on the card), RANSAC-PnP,
    distance-dependent blend, 1.5 m jump gate. Returns (R, t, ok)."""
    fx, fy, cx, cy = _intr(config)
    pc = config.pnp
    mres = matching.knn2_ratio_match_streaming(
        frame.desc, st.map.desc, frame.valid, st.map.valid,
        ratio=config.frontend.flann_ratio_threshold ** 0.5,
    )
    X = st.map.pos[torch.clamp(mres.idx.long(), 0, st.map.pos.shape[0] - 1)]
    result = pnp_ops.ransac_pnp(
        key, X, frame.xy, mres.valid, fx, fy, cx, cy, num_hypotheses=pc.ransac_iters,
        threshold_px=pc.ransac_threshold_px, min_inliers=pc.min_points,
        gn_iters=pc.gn_iters,
    )
    jump = se3.norm(result.t - st.t)
    ok = result.ok & (jump < pc.recovery_max_jump)
    blend = torch.where(jump < 0.5, pc.recovery_blend_close, pc.recovery_blend_far)
    t_rec = st.t + blend * (result.t - st.t)
    R_rec = se3.exp_so3(se3.log_so3(result.R @ st.R.T) * blend) @ st.R
    return R_rec, t_rec, ok


def _handle_loop_closure(st: TrackState, frame: FrameFeatures, config: SlamConfig,
                         R_new, t_new, key):
    """Loop detection + constraint accumulation: match the frame against
    every kf_stride-th stored keyframe at once (bf16 dots), ratio test,
    best candidate, Essential-RANSAC verify + PnP against the anchor's
    depth-backprojected keypoints + tight GN polish; on acceptance append
    a LoopConstraint."""
    fx, fy, cx, cy = _intr(config)
    lc = config.loop
    kfs = st.keyframes
    KFC = kfs.desc.shape[0]
    dev = frame.desc.device
    stride = int(lc.kf_stride)
    desc_s = kfs.desc[::stride]
    cand = kfs.valid[::stride] & (frame.frame_id - kfs.frame_id[::stride] >= lc.min_frame_gap)
    dots = torch.einsum("kd,oid->oki", frame.desc.to(desc_s.dtype), desc_s)
    d2 = device.sqrt(torch.clamp(2.0 - 2.0 * dots, min=0.0))
    d2 = torch.where(frame.valid[None, :, None], d2, 1e9)
    d2 = torch.where(kfs.kp_valid[::stride][:, None, :], d2, 1e9)
    dd1 = torch.amin(d2, dim=-1)
    best_idx = torch.argmin(d2, dim=-1)
    cols = torch.arange(d2.shape[-1], device=dev)
    dd2 = torch.amin(torch.where(cols[None, None, :] == best_idx[..., None], 1e9, d2), dim=-1)
    match_ok = ((dd1 < config.frontend.l2_ratio_threshold * dd2) & (dd1 < 1e8)
                & frame.valid[None, :])
    counts = torch.sum(match_ok, dim=-1) * cand
    best_s = torch.argmax(counts)
    best_kf = best_s * stride
    best_count = device.take(counts, best_s)
    mok = device.take(match_ok, best_s)
    bi = device.take(best_idx, best_s)
    cand_frame_id = device.take(kfs.frame_id, best_kf)

    if _cond(best_count >= config.frontend.min_matches):
        kf_xy = device.take(kfs.xy, best_kf)
        kf_R, kf_t = device.take(kfs.R, best_kf), device.take(kfs.t, best_kf)
        uv_old = kf_xy[bi]
        k1, k2 = prng.split(key, 2)
        _, _, _, eres = rs.ransac_essential(
            k1, uv_old, frame.xy, mok, fx, fy, cx, cy,
            num_hypotheses=config.motion.em_ransac_iters,
            threshold_px=config.motion.em_ransac_threshold_px, min_inliers=lc.min_inliers,
        )
        d_old = device.take(kfs.depth, best_kf)
        d_ok_old = (d_old > config.camera.depth_min) & (d_old < config.camera.depth_max)
        X_w = se3.transform_points(
            kf_R, kf_t, cam.backproject(kf_xy, d_old, fx, fy, cx, cy),
        )
        X = X_w[bi]
        corr_ok = mok & d_ok_old[bi]
        pnp_res = pnp_ops.ransac_pnp(
            k2, X, frame.xy, corr_ok, fx, fy, cx, cy,
            num_hypotheses=config.pnp.ransac_iters,
            threshold_px=config.pnp.ransac_threshold_px, min_inliers=config.pnp.min_points,
        )
        R_cw, t_cw = se3.inverse(pnp_res.R, pnp_res.t)
        if lc.refine_threshold_px > 0.0:
            uv_hat, front = cam.project(se3.transform_points(R_cw, t_cw, X), fx, fy, cx, cy)
            tight = (se3.norm(uv_hat - frame.xy) < lc.refine_threshold_px) & front & corr_ok
            R_cw2, t_cw2 = pnp_ops.gn_refine_pose(
                R_cw, t_cw, X, frame.xy, tight.to(X.dtype), fx, fy, cx, cy,
                iters=lc.refine_gn_iters, huber_px=lc.refine_huber_px,
            )
            use_tight = torch.sum(tight) >= config.pnp.min_points
            R_cw = torch.where(use_tight, R_cw2, R_cw)
            t_cw = torch.where(use_tight, t_cw2, t_cw)
        R_pnp, t_pnp = se3.inverse(R_cw, t_cw)
        jump = se3.norm(t_pnp - t_new)
        last_to = torch.amax(torch.where(st.loops.valid, st.loops.to_id, -1))
        spaced = frame.frame_id - last_to >= lc.min_frames_between_accepts
        accept = (eres.ok & pnp_res.ok & (jump > lc.min_jump) & (jump < lc.max_jump)
                  & (best_count > 0) & spaced)
        R_rel, t_rel = se3.relative(kf_R, kf_t, R_pnp, t_pnp)
    else:
        accept = torch.zeros((), dtype=torch.bool, device=dev)
        R_rel = torch.eye(3, dtype=kfs.R.dtype, device=dev)
        t_rel = torch.zeros(3, dtype=kfs.t.dtype, device=dev)

    loops = st.loops
    cursor = torch.sum(loops.valid)
    L = loops.valid.shape[0]
    cur_slot = torch.remainder(st.kf_count - 1, KFC)
    write = accept & (cursor < L)
    idx = torch.where(write, cursor, L - 1)

    def put(arr, val):
        if isinstance(val, torch.Tensor):
            val = val.to(arr.dtype)
        else:
            val = torch.full((), val, dtype=arr.dtype, device=arr.device)
        return device.put_(arr.clone(), idx, torch.where(write, val, device.take(arr, idx)))

    loops = loops._replace(
        kf_from=put(loops.kf_from, best_kf), kf_to=put(loops.kf_to, cur_slot),
        from_id=put(loops.from_id, cand_frame_id), to_id=put(loops.to_id, frame.frame_id),
        R_rel=put(loops.R_rel, R_rel), t_rel=put(loops.t_rel, t_rel),
        valid=put(loops.valid, True),
    )
    return st._replace(loops=loops)


def _no_match(K, device):
    return matching.MatchResult(
        torch.arange(K, dtype=torch.int32, device=device),
        torch.zeros(K, dtype=torch.bool, device=device),
        torch.zeros(K, device=device),
    )


def _bridge(s: TrackState, frame: FrameFeatures, config: SlamConfig, key):
    """Bridge-keyframe promotion: promote the previous frame to keyframe
    (depth-backprojected points only) and re-match against it."""
    dev = s.prev_xy.device
    prev = FrameFeatures(
        xy=s.prev_xy, desc=s.prev_desc, depth=s.prev_depth, valid=s.prev_valid,
        timestamp=s.last_time, stationary=torch.zeros((), dtype=torch.bool, device=dev),
        frame_id=s.prev_frame_id,
    )
    K = s.prev_xy.shape[0]
    s2 = _make_keyframe(s, prev, config, s.prev_R, s.prev_t, _no_match(K, dev),
                        torch.zeros(K, dtype=torch.bool, device=dev))
    m2, uv_kf2, uv_cur2, gated2, n_raw2 = _match_to_keyframe(s2, frame, config, key)
    return s2, m2, uv_kf2, uv_cur2, gated2, n_raw2


def _bootstrap(st: TrackState, frame: FrameFeatures, config: SlamConfig):
    """First frame: become the first keyframe at the initial pose."""
    K = frame.xy.shape[0]
    dev = frame.xy.device
    st2 = _make_keyframe(st, frame, config, st.R, st.t, _no_match(K, dev),
                         torch.zeros(K, dtype=torch.bool, device=dev))
    ekf0 = ekf_ops.initialize(st.t, frame.timestamp)
    i0 = torch.zeros((), dtype=torch.int32, device=dev)
    f0 = torch.zeros((), dtype=torch.float32, device=dev)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    out = StepOutputs(
        R=st.R, t=st.t, timestamp=frame.timestamp,
        x_pred=ekf0.x, P_pred=torch.eye(6, dtype=st.t.dtype, device=dev),
        x_filt=ekf0.x, P_filt=ekf0.P, dt=f0,
        num_matches=i0, num_inliers=i0, num_tracked=i0,
        is_keyframe=~false, used_3d3d=false, tracking_ok=~false,
        epi_before=f0, epi_after=f0, bridged=false, recovered=false, num_depth_ok=i0,
    )
    return (
        st2._replace(
            ekf=ekf0, frame_idx=st.frame_idx + 1, last_time=frame.timestamp,
            prev_xy=frame.xy, prev_desc=frame.desc, prev_depth=frame.depth,
            prev_valid=frame.valid, prev_R=st.R, prev_t=st.t, prev_frame_id=frame.frame_id,
        ),
        out,
    )


def _bridge_due(st: TrackState, n_raw, config):
    return ((n_raw < config.frontend.min_matches) & (st.prev_frame_id >= 0)
            & (st.prev_frame_id != st.kf_frame_id))


def _gate(uv_kf, uv_cur, gated, config, key):
    """The main-path F-gate where it is on. Returns (gated', epi_before, epi_after)."""
    if config.motion.fgate_main_path:
        return _fundamental_gate(uv_kf, uv_cur, gated, config, key)
    zero = torch.zeros((), dtype=torch.float32, device=gated.device)
    return gated, zero, zero


def _recover_due(st: TrackState, enough, config):
    return ((~enough) & (st.recovery_cooldown <= 0)
            & (torch.sum(st.map.valid) >= config.pnp.min_points))


def _no_recovery(st: TrackState):
    return st.R, st.t, torch.zeros((), dtype=torch.bool, device=st.t.device)


def _pose_fusion(R, t, ekf_x, ekf_P, ekf_initialized, ekf_time, last_time, frame_idx, gravity,
                 initial_height, has_height, stat, timestamp, R_mot, t_mot, used_3d3d, motion_ok,
                 recovered, R_rec, t_rec, ec):
    """The first half of `step.pose` as a device function of flat tensors
    (`ops.graphs`), `ec` the EKF constants: EKF fusion of the motion
    estimate, then the recovery override. Returns (R_new, t_new, the EKF
    state's leaves, the snapshot's)."""
    ekf = ekf_ops.EKFState(ekf_x, ekf_P, ekf_initialized, ekf_time)
    R_new = torch.where(motion_ok, R_mot, R)
    t_meas = torch.where(motion_ok & ~stat, t_mot, t)
    ekf_st, t_fused, snap = _ekf_fusion(ekf, t, last_time, frame_idx, gravity, initial_height,
                                        has_height, timestamp, t_meas, used_3d3d,
                                        motion_ok & ~stat, ec)
    R_new = se3.renormalize_rotation(R_new)
    t_new = torch.where(stat, t, t_fused)
    R_new = torch.where(recovered, R_rec, R_new)
    t_new = torch.where(recovered, t_rec, t_new)
    ekf_st = _tree_where(recovered, ekf_ops.initialize(t_rec, timestamp), ekf_st)
    return (R_new, t_new, *ekf_st, *snap)


def _fuse_pose(st: TrackState, frame, config, R_mot, t_mot, used_3d3d, motion_ok, recovered,
               R_rec, t_rec):
    """EKF fusion of the motion estimate, then the recovery override: on
    CUDA inputs a replay of `_pose_fusion`'s graph.
    Returns (R_new, t_new, ekf_state, snapshot)."""
    out = graphs.call(_pose_fusion, (config.ekf,), (
        st.R, st.t, *st.ekf, st.last_time, st.frame_idx, st.gravity, st.initial_height,
        st.has_height, frame.stationary, frame.timestamp, R_mot, t_mot, used_3d3d, motion_ok,
        recovered, R_rec, t_rec))
    return out[0], out[1], ekf_ops.EKFState(*out[2:6]), out[6:]


def _keyframe_due(frame_id, stat, kf_frame_id, kf_R, was_stationary, n_matches, motion_ok,
                  recovered, R_fin, mc, ec):
    gap = frame_id - kf_frame_id
    is_kf_normal = (
        ((gap >= mc.kf_min_frame_gap) & (n_matches >= mc.kf_min_matches))
        | ((gap >= mc.kf_proactive_min_gap) & (n_matches < mc.kf_proactive_max_matches))
    ) & motion_ok & ~stat & ~recovered
    rot_drift = se3.norm(se3.log_so3(R_fin @ kf_R.T))
    is_kf_rot = stat & (rot_drift > ec.stationary_kf_rot_drift) & motion_ok
    is_kf_post = was_stationary & ~stat & motion_ok
    return is_kf_normal | is_kf_rot | is_kf_post


def _pose_refinement(pos, xy, frame_id, stat, mp_idx, kp_ok, R_new, t_new, t, kf_R, kf_frame_id,
                     was_stationary, n_matches, motion_ok, recovered, intr, pc, mc, ec):
    """The second half of `step.pose` as a device function of flat tensors
    (`ops.graphs`), `intr` the intrinsics, `pc`, `mc`, `ec` the PnP, map and
    EKF constants: PnP refinement, then the keyframe policy.
    Returns (R_fin, t_fin, R_kfp, t_kfp, is_kf)."""
    R_ref, t_ref, _, R_full, t_full = _pnp_blend(pos, xy, R_new, t_new, mp_idx, kp_ok, intr, pc)
    R_fin = R_ref
    t_fin = torch.where(stat, t, t_ref)
    if pc.kf_refine_full:
        R_kfp, t_kfp = R_full, torch.where(stat, t, t_full)
    else:
        R_kfp, t_kfp = R_fin, t_fin
    is_kf = _keyframe_due(frame_id, stat, kf_frame_id, kf_R, was_stationary, n_matches,
                          motion_ok, recovered, R_fin, mc, ec)
    return R_fin, t_fin, R_kfp, t_kfp, is_kf


def _refine_and_decide(st: TrackState, frame, config, R_new, t_new, mp_idx, kp_ok, n_matches,
                       motion_ok, recovered):
    """PnP refinement and the keyframe policy: on CUDA inputs a replay of
    `_pose_refinement`'s graph. Returns (R_fin, t_fin, R_kfp, t_kfp, is_kf):
    the frame's pose, the pose a keyframe made now is registered at, and
    whether one is."""
    return graphs.call(
        _pose_refinement, (_intr(config), config.pnp, config.map, config.ekf),
        (st.map.pos, frame.xy, frame.frame_id, frame.stationary, mp_idx, kp_ok, R_new, t_new,
         st.t, st.kf_R, st.kf_frame_id, st.was_stationary, n_matches, motion_ok, recovered))


def _insert_keyframe(st: TrackState, frame, config, R_kfp, t_kfp, m, gated, mp_idx, kp_ok):
    """Keyframe creation (the slots this frame observed are protected from
    eviction) + reprojection cull. Pushes to the ring in place."""
    M = st.map.valid.shape[0]
    protect = _scatter_set(torch.zeros(M, dtype=torch.bool, device=gated.device),
                           mp_idx, kp_ok, True)
    s2 = _make_keyframe(st, frame, config, R_kfp, t_kfp, m, gated, protect=protect)
    return s2._replace(map=_reproject_cull(s2.map, frame, config, R_kfp, t_kfp, mp_idx, kp_ok))


def _periodic_due(s2: TrackState, config):
    return torch.remainder(s2.kf_count, config.pnp.interval) == 0


def _loop_due(s2: TrackState, config):
    return torch.remainder(s2.kf_count, config.loop.check_interval_kfs) == 0


def _repose_keyframe(s2: TrackState, R_kf, t_kf):
    """Write the new keyframe's final pose into the active keyframe and its
    ring slot (in place)."""
    slot = torch.remainder(s2.kf_count - 1, s2.keyframes.valid.shape[0])
    kfs = s2.keyframes
    for ring, value in ((kfs.R, R_kf), (kfs.t, t_kf), (kfs.R_anchor, R_kf),
                        (kfs.t_anchor, t_kf)):
        device.put_(ring, slot, value)
    return s2._replace(kf_R=R_kf, kf_t=t_kf)


def _finish(st0: TrackState, st_kf: TrackState, frame, config, R_fin, t_fin, ekf_st, snap,
            new_scale, motion_ok, recovered, *, n_matches, n_inl, n_tracked, is_kf,
            used_3d3d, epi_before, epi_after, bridged, n_depth_ok):
    """The state carried to the next frame and this frame's outputs."""
    dev = t_fin.device
    stat = frame.stationary
    x_new = torch.cat([t_fin, ekf_st.x[3:]])
    x_new = torch.where(stat, torch.cat([t_fin, torch.zeros_like(t_fin)]), x_new)
    ekf_st = ekf_st._replace(x=x_new)
    cooldown = torch.where(
        recovered,
        torch.full((), config.pnp.recovery_cooldown_frames, dtype=torch.int32, device=dev),
        torch.clamp(st0.recovery_cooldown - 1, min=0),
    )
    st_out = st_kf._replace(
        R=R_fin, t=t_fin, ekf=ekf_st, frame_idx=st0.frame_idx + 1,
        last_time=frame.timestamp, last_scale=new_scale, tracking_ok=motion_ok | recovered,
        was_stationary=stat, prev_xy=frame.xy, prev_desc=frame.desc,
        prev_depth=frame.depth, prev_valid=frame.valid, prev_R=R_fin, prev_t=t_fin,
        prev_frame_id=frame.frame_id, recovery_cooldown=cooldown,
    )
    out = StepOutputs(
        R=R_fin, t=t_fin, timestamp=frame.timestamp,
        x_pred=snap[0], P_pred=snap[1], x_filt=snap[2], P_filt=snap[3], dt=snap[4],
        num_matches=n_matches.to(torch.int32), num_inliers=n_inl.to(torch.int32),
        num_tracked=n_tracked.to(torch.int32), is_keyframe=is_kf, used_3d3d=used_3d3d,
        tracking_ok=motion_ok, epi_before=epi_before, epi_after=epi_after,
        bridged=bridged, recovered=recovered, num_depth_ok=n_depth_ok,
    )
    return st_out, out


def _track(r, config: SlamConfig, contiguous: bool):
    """One frame for each member of `r`, records holding a state `st`, its
    frame `f` and a host key `k`: bootstrap, or the 12 blocks of the track
    body, each block once for the list (its span's `frames` the
    member-frames it covers) and each hoisted block only for the members
    whose predicate is set. Sets `st` and `out` on each record, `st` with
    contiguous leaves where `contiguous`. Returns how many members tracked."""
    for x in r:
        x.boot = x.st.kf_frame_id < 0
    boot = _hoisted("bootstrap", r, "boot")
    if any(boot):
        with profiling.span("step.bootstrap", frames=sum(boot)):
            for x in compress(r, boot):
                x.st, x.out = _bootstrap(x.st, x.f, config)
                x.st = contiguous_tree(x.st) if contiguous else x.st
    r = [x for x, b in zip(r, boot) if not b]
    n = len(r)
    if not n:
        return 0
    STATS["track_frames"] += n
    for x in r:  # k: match, motion, pnp, recover, loop, periodic, fgate
        x.st0, x.k = x.st, prng.split(x.k, 7)

    with profiling.span("step.match", frames=n):
        for x in r:  # 1. keyframe match
            x.m, x.uv_kf, x.uv_cur, x.gated, x.n_raw = _match_to_keyframe(x.st, x.f, config,
                                                                          x.k[0])
            x.can_bridge = _bridge_due(x.st, x.n_raw, config)
        for x in compress(r, _hoisted("bridge", r, "can_bridge")):  # 2. bridge keyframe
            x.st, x.m, x.uv_kf, x.uv_cur, x.gated, x.n_raw = _bridge(x.st, x.f, config, x.k[0])
        for x in r:  # 2b. F-gate
            x.gated, x.epi_before, x.epi_after = _gate(x.uv_kf, x.uv_cur, x.gated, config,
                                                       x.k[6])
            x.n_matches = torch.sum(x.gated)

    with profiling.span("step.motion", frames=n):
        for x in r:  # 3. 3D-3D motion
            x.k_3d3d, x.k_ess = prng.split(x.k[1], 2)
            x.R3, x.t3, x.res3, x.p_kf, x.p_cur, x.d_ok = _motion_3d3d(
                x.st, x.f, config, x.m, x.uv_kf, x.uv_cur, x.gated, x.k_3d3d)
            x.use_3d3d = x.res3.ok & bool(config.rgbd)
        # 4. essential fallback, for the members whose 3D-3D estimate is not used
        for x, run in zip(r, _hoisted("essential", r, "use_3d3d", runs_if=False)):
            x.ess = (_motion_essential(x.st, x.f, config, x.uv_kf, x.uv_cur, x.gated, x.p_kf,
                                       x.p_cur, x.d_ok, x.k_ess)
                     if run else _essential_skipped(x.st, x.R3, x.t3, x.res3))
        for x in r:
            (x.R_mot, x.t_mot, x.motion_ok, x.n_inl, x.new_scale,
             x.n_depth_ok) = _compose_motion(x.st, x.use_3d3d, x.R3, x.t3, x.res3, x.ess,
                                             x.gated, x.d_ok)
            enough = x.n_matches >= config.frontend.min_matches
            x.motion_ok = x.motion_ok & enough
            x.can_recover = _recover_due(x.st, enough, config)
        for x, run in zip(r, _hoisted("recover", r, "can_recover")):  # 5. PnP recovery
            x.R_rec, x.t_rec, x.rec_ok = (_try_pnp_recovery(x.st, x.f, config, x.k[3]) if run
                                          else _no_recovery(x.st))
            x.recovered = x.can_recover & x.rec_ok

    with profiling.span("step.pose", frames=n):
        for x in r:  # 6. EKF fusion, recovery override
            x.R_new, x.t_new, x.ekf, x.snap = _fuse_pose(
                x.st, x.f, config, x.R_mot, x.t_mot, x.use_3d3d, x.motion_ok, x.recovered,
                x.R_rec, x.t_rec)

    with profiling.span("step.map", frames=n):  # 7. local map
        for x, mp_idx, kp_ok, map2 in zip(r, *_track_local_maps(
                [x.st for x in r], [x.f for x in r], config, [x.R_new for x in r],
                [x.t_new for x in r])):
            x.mp_idx, x.kp_ok, x.st = mp_idx, kp_ok, x.st._replace(map=map2)
            x.n_tracked = torch.sum(kp_ok)

    with profiling.span("step.pose", frames=n):  # 8. PnP refine; keyframe policy
        for x in r:
            x.R_fin, x.t_fin, x.R_kfp, x.t_kfp, x.is_kf = _refine_and_decide(
                x.st, x.f, config, x.R_new, x.t_new, x.mp_idx, x.kp_ok, x.n_matches,
                x.motion_ok, x.recovered)
            x.st_kf = x.st
        kfs = list(compress(r, _hoisted("keyframe", r, "is_kf")))

    if kfs:
        with profiling.span("step.keyframe", frames=len(kfs)):
            for x in kfs:  # 9. keyframe creation + cull
                x.st_kf = _insert_keyframe(x.st, x.f, config, x.R_kfp, x.t_kfp, x.m, x.gated,
                                           x.mp_idx, x.kp_ok)
                x.periodic = _periodic_due(x.st_kf, config)
                x.R_kf, x.t_kf = x.R_kfp, x.t_kfp
            for x in compress(kfs, _hoisted("periodic_pnp", kfs, "periodic")):  # 10.
                x.R_kf, x.t_kf = _periodic_pnp(x.st_kf, x.f, config, x.R_kfp, x.t_kfp,
                                               x.mp_idx, x.kp_ok, x.k[5])
            for x in kfs:
                x.st_kf = _repose_keyframe(x.st_kf, x.R_kf, x.t_kf)
                x.R_fin, x.t_fin = x.R_kf, x.t_kf
                x.loop = _loop_due(x.st_kf, config)
            for x in compress(kfs, _hoisted("loop", kfs, "loop")):  # 11. loop closure
                x.st_kf = _handle_loop_closure(x.st_kf, x.f, config, x.R_kf, x.t_kf, x.k[4])

    with profiling.span("step.finish", frames=n):
        for x in r:  # 12. finalize
            x.st, x.out = _finish(
                x.st0, x.st_kf, x.f, config, x.R_fin, x.t_fin, x.ekf, x.snap, x.new_scale,
                x.motion_ok, x.recovered, n_matches=x.n_matches, n_inl=x.n_inl,
                n_tracked=x.n_tracked, is_kf=x.is_kf, used_3d3d=x.use_3d3d,
                epi_before=x.epi_before, epi_after=x.epi_after, bridged=x.can_bridge,
                n_depth_ok=x.n_depth_ok)
            x.st = contiguous_tree(x.st) if contiguous else x.st
    return n


def tracking_step(state: TrackState, frame: FrameFeatures, config: SlamConfig,
                  key) -> Tuple[TrackState, StepOutputs]:
    """One frame through the full tracking state machine, in full f32.
    `key` is a host threefry key (`ops.prng`). Updates the keyframe ring
    of `state` in place (see the module docstring); every leaf of the
    state it returns is contiguous."""
    with profiling.span("step"), f32_matmuls():
        x = SimpleNamespace(st=state, f=frame._replace(desc=frame.desc.to(state.kf_desc.dtype)),
                            k=key)
        _track([x], config, contiguous=True)
        return x.st, x.out


def frame_key(seed: int, frame_id: int):
    """Per-frame host key `fold_in(PRNGKey(seed), frame_id)` (the JAX
    package's `make_scan_step` keying)."""
    return prng.fold_in(prng.prng_key(seed), int(frame_id))


def make_scan_step(config: SlamConfig, seed: int = 42):
    """The step closure of the JAX package's `make_scan_step`: `step(state,
    frame, frame_id=None)` runs `tracking_step` with the key
    `fold_in(PRNGKey(seed), frame_id)`. `frame_id` is the frame's id on the
    host; without it the step reads `frame.frame_id` back from the device
    (one host sync)."""

    def scan_fn(state: TrackState, frame: FrameFeatures, frame_id=None):
        fid = int(frame.frame_id) if frame_id is None else frame_id
        return tracking_step(state, frame, config, frame_key(seed, fid))

    return scan_fn


def run_frames(state: TrackState, frames: FrameFeatures, frame_ids, config: SlamConfig,
               seed: int = 42):
    """The JAX package's `lax.scan(make_scan_step(config, seed), state,
    frames)` as a Python loop. `frame_ids` are the frames' ids on the
    host. Returns (state, stacked StepOutputs)."""
    step = make_scan_step(config, seed)
    outs = []
    for i, fid in enumerate(frame_ids):
        state, out = step(state, frame_at(frames, i), fid)
        outs.append(out)
    return state, StepOutputs(*(torch.stack(f) for f in zip(*outs)))
