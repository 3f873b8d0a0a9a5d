"""The per-frame tracking step.

Port of `vslam_tpu/core/tracking.py:40-1167`: descriptor matching ->
fundamental gate -> 3D-3D RANSAC (or Essential + depth scale) -> EKF
fusion -> recovery -> local-map tracking -> PnP refinement -> keyframe
creation with triangulation + depth back-projection -> reprojection cull
-> periodic PnP -> loop-closure match and verify.

Every `lax.cond` of the JAX step becomes a Python `if` on a scalar read
back from the device (`_cond`, counted in `STATS["branch_reads"]` and,
while the span recorder of `utils.profiling` is on, charged to the
innermost open span); where both branches are cheap the port selects
with `torch.where` instead and reads nothing back. Those reads are meant
to be the step's only waits on the card: indexing by a device scalar,
small constants and the RANSAC draws go through `ops.device`. The step runs in full f32
(`linalg.f32_matmuls`).

Spans (`utils.profiling.span`, no-ops while the recorder is off): `step`
around each `tracking_step`, and inside it one per block: `step.bootstrap`
(the first frame), `step.match` (keyframe match, bridge, F-gate),
`step.motion` (motion estimate, PnP recovery when due), `step.pose` (EKF
fusion; later PnP refinement and the keyframe decision, a second span),
`step.map` (local-map tracking with the radius kernel), `step.keyframe`
(keyframe frames only: insert, periodic PnP, re-pose, loop closure) and
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

from typing import Tuple

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
# branch (not bootstrap) and branch predicates read back from the device.
STATS = {"track_frames": 0, "branch_reads": 0}


def reset_stats():
    for k in STATS:
        STATS[k] = 0


def _cond(pred: torch.Tensor) -> bool:
    """Read a branch predicate back from the device (one host sync),
    counted in `STATS` and charged to the innermost open span."""
    STATS["branch_reads"] += 1
    profiling.count_read()
    return bool(pred)


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


def _motion_3d3d(state, frame, config, m, uv_kf, uv_cur, gated, key):
    """3D-3D RANSAC part of motion estimation.
    Returns (R3, t3, res3, p_kf, p_cur, d_ok)."""
    fx, fy, cx, cy = _intr(config)
    mc = config.motion
    cc = config.camera
    depth_kf = state.kf_depth
    depth_cur = frame.depth[m.idx.long()]
    d_ok = ((depth_kf > cc.depth_min) & (depth_kf < cc.depth_max)
            & (depth_cur > cc.depth_min) & (depth_cur < cc.depth_max))
    valid3d = gated & d_ok
    p_kf = cam.backproject(uv_kf, depth_kf, fx, fy, cx, cy)
    p_cur = cam.backproject(uv_cur, depth_cur, fx, fy, cx, cy)
    max_t = mc.r3d_max_translation
    if mc.r3d_max_translation_per_frame > 0:
        gap = (frame.frame_id - state.kf_frame_id).to(p_kf.dtype)
        max_t = torch.clamp(gap * mc.r3d_max_translation_per_frame, min=max_t)
    R3, t3, res3 = rs.ransac_kabsch_3d3d(
        key, p_kf, p_cur, valid3d,
        num_hypotheses=mc.r3d_iters, inlier_thresh=mc.r3d_inlier_thresh,
        max_translation=max_t, min_translation=mc.r3d_min_translation,
        min_inliers=config.frontend.min_inliers,
    )
    return R3, t3, res3, p_kf, p_cur, d_ok


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


def _estimate_motion(state, frame, config, m, uv_kf, uv_cur, gated, key):
    """3D-3D preferred, Essential+scale fallback.
    Returns (R_new, t_new, used_3d3d, motion_ok, n_inliers, new_scale, n_depth_ok)."""
    k1, k2 = prng.split(key, 2)
    R3, t3, res3, p_kf, p_cur, d_ok = _motion_3d3d(
        state, frame, config, m, uv_kf, uv_cur, gated, k1
    )
    use_3d3d = res3.ok & bool(config.rgbd)
    if _cond(use_3d3d):
        ess = _essential_skipped(state, R3, t3, res3)
    else:
        ess = _motion_essential(state, frame, config, uv_kf, uv_cur, gated, p_kf, p_cur, d_ok, k2)
    R_new, t_new, motion_ok, n_inl, new_scale, n_dok = _compose_motion(
        state, use_3d3d, R3, t3, res3, ess, gated, d_ok)
    return R_new, t_new, use_3d3d, motion_ok, n_inl, new_scale, n_dok


def _fuse_ekf(state: TrackState, frame, config, t_meas, used_3d3d, motion_ok):
    """EKF predict + gated visual update + height + clamp.
    Returns (ekf_state, fused_pos, snapshot)."""
    ec = config.ekf
    st = _tree_where(state.ekf.initialized, state.ekf,
                     ekf_ops.initialize(state.t, frame.timestamp))
    dt = frame.timestamp - state.last_time
    dt = torch.where(state.frame_idx == 0, 0.0, dt)
    st = ekf_ops.predict(st, dt, sigma_a=ec.process_accel, decay=ec.vel_decay)
    x_pred, P_pred = st.x, st.P
    sigma = torch.where(used_3d3d, ec.sigma_vis_3d3d, ec.sigma_vis_emat)
    st = ekf_ops.update_visual_gated(st, t_meas, sigma, gate=ec.innovation_gate,
                                     enabled=motion_ok)
    st = ekf_ops.update_height(st, state.gravity, state.initial_height, ec.sigma_height,
                               enabled=state.has_height)
    P_filt = st.P
    st, fused = ekf_ops.clamp_step(st, state.t, dt, max_step=ec.max_step)
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


def _track_local_map(state: TrackState, frame, config, R_new, t_new):
    """Project map points and radius-match descriptors (the CUDA radius
    kernel on the card). Returns (mp_idx per kp, tracked mask, map')."""
    uv_mp, visible_mask = _project_map(state.map, config, R_new, t_new)
    mp_idx, kp_ok, _, min_pix_d2 = matching.radius_descriptor_match_fused(
        frame.desc, frame.xy, frame.valid, state.map.desc, uv_mp, visible_mask,
        radius_px=config.map.track_search_radius_px,
        desc_thresh=config.map.track_desc_threshold,
    )
    return mp_idx, kp_ok, _count_found(state.map, config, visible_mask, min_pix_d2)


def _refine_pnp(state, frame, config, R_new, t_new, mp_idx, kp_ok, key):
    """Local PnP refinement (Huber GN from the current pose) with adaptive
    0.3..0.5 blending and a jump gate."""
    fx, fy, cx, cy = _intr(config)
    pc = config.pnp
    X = state.map.pos[torch.clamp(mp_idx.long(), 0, state.map.pos.shape[0] - 1)]
    n_corr = torch.sum(kp_ok)
    R_cw0 = R_new.T
    t_cw0 = -R_cw0 @ t_new
    R_cw, t_cw = pnp_ops.gn_refine_pose(
        R_cw0, t_cw0, X, frame.xy, kp_ok.to(X.dtype), fx, fy, cx, cy,
        iters=pc.refine_gn_iters, huber_px=pc.ransac_threshold_px * 0.5,
    )
    R_pnp, t_pnp = se3.inverse(R_cw, t_cw)
    uv_f, front_f = cam.project(se3.transform_points(R_cw, t_cw, X), fx, fy, cx, cy)
    inl = (se3.norm(uv_f - frame.xy) < pc.ransac_threshold_px) & front_f & kp_ok
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


def _fuse_pose(st: TrackState, frame, config, R_mot, t_mot, used_3d3d, motion_ok, recovered,
               R_rec, t_rec):
    """EKF fusion of the motion estimate, then the recovery override.
    Returns (R_new, t_new, ekf_state, snapshot)."""
    stat = frame.stationary
    R_new = torch.where(motion_ok, R_mot, st.R)
    t_meas = torch.where(motion_ok & ~stat, t_mot, st.t)
    ekf_st, t_fused, snap = _fuse_ekf(st, frame, config, t_meas, used_3d3d, motion_ok & ~stat)
    R_new = se3.renormalize_rotation(R_new)
    t_new = torch.where(stat, st.t, t_fused)
    R_new = torch.where(recovered, R_rec, R_new)
    t_new = torch.where(recovered, t_rec, t_new)
    ekf_st = _tree_where(recovered, ekf_ops.initialize(t_rec, frame.timestamp), ekf_st)
    return R_new, t_new, ekf_st, snap


def _refined_poses(st: TrackState, frame, config, R_new, t_new, mp_idx, kp_ok, key):
    """PnP refinement. Returns (R_fin, t_fin, R_kfp, t_kfp): the frame's
    pose and the pose a keyframe made now is registered at."""
    R_ref, t_ref, _, R_full, t_full = _refine_pnp(
        st, frame, config, R_new, t_new, mp_idx, kp_ok, key
    )
    stat = frame.stationary
    R_fin = R_ref
    t_fin = torch.where(stat, st.t, t_ref)
    if config.pnp.kf_refine_full:
        return R_fin, t_fin, R_full, torch.where(stat, st.t, t_full)
    return R_fin, t_fin, R_fin, t_fin


def _keyframe_due(st: TrackState, frame, config, n_matches, motion_ok, recovered, R_fin):
    mc = config.map
    stat = frame.stationary
    gap = frame.frame_id - st.kf_frame_id
    is_kf_normal = (
        ((gap >= mc.kf_min_frame_gap) & (n_matches >= mc.kf_min_matches))
        | ((gap >= mc.kf_proactive_min_gap) & (n_matches < mc.kf_proactive_max_matches))
    ) & motion_ok & ~stat & ~recovered
    rot_drift = se3.norm(se3.log_so3(R_fin @ st.kf_R.T))
    is_kf_rot = stat & (rot_drift > config.ekf.stationary_kf_rot_drift) & motion_ok
    is_kf_post = st.was_stationary & ~stat & motion_ok
    return is_kf_normal | is_kf_rot | is_kf_post


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


def _track(st: TrackState, frame: FrameFeatures, config: SlamConfig, keys):
    (k_match, k_motion, k_pnp, k_recover, k_loop, k_periodic, k_fgate) = keys
    st0 = st
    with profiling.span("step.match"):
        m, uv_kf, uv_cur, gated, n_raw = _match_to_keyframe(st, frame, config, k_match)
        can_bridge = _bridge_due(st, n_raw, config)
        if _cond(can_bridge):
            st, m, uv_kf, uv_cur, gated, n_raw = _bridge(st, frame, config, k_match)
        gated, epi_before, epi_after = _gate(uv_kf, uv_cur, gated, config, k_fgate)
        n_matches = torch.sum(gated)

    with profiling.span("step.motion"):
        (R_mot, t_mot, used_3d3d, motion_ok, n_inl, new_scale,
         n_depth_ok) = _estimate_motion(st, frame, config, m, uv_kf, uv_cur, gated, k_motion)
        enough = n_matches >= config.frontend.min_matches
        motion_ok = motion_ok & enough

        can_recover = _recover_due(st, enough, config)
        if _cond(can_recover):
            R_rec, t_rec, rec_ok = _try_pnp_recovery(st, frame, config, k_recover)
        else:
            R_rec, t_rec, rec_ok = _no_recovery(st)
        recovered = can_recover & rec_ok
    with profiling.span("step.pose"):
        R_new, t_new, ekf_st, snap = _fuse_pose(st, frame, config, R_mot, t_mot, used_3d3d,
                                                motion_ok, recovered, R_rec, t_rec)

    with profiling.span("step.map"):
        mp_idx, kp_ok, map2 = _track_local_map(st, frame, config, R_new, t_new)
        st = st._replace(map=map2)
        n_tracked = torch.sum(kp_ok)
    with profiling.span("step.pose"):
        R_fin, t_fin, R_kfp, t_kfp = _refined_poses(st, frame, config, R_new, t_new, mp_idx,
                                                    kp_ok, k_pnp)
        is_kf = _keyframe_due(st, frame, config, n_matches, motion_ok, recovered, R_fin)
        kf_due = _cond(is_kf)

    st_kf = st
    if kf_due:
        with profiling.span("step.keyframe"):
            s2 = _insert_keyframe(st, frame, config, R_kfp, t_kfp, m, gated, mp_idx, kp_ok)
            if _cond(_periodic_due(s2, config)):
                R_kf, t_kf = _periodic_pnp(s2, frame, config, R_kfp, t_kfp, mp_idx, kp_ok,
                                           k_periodic)
            else:
                R_kf, t_kf = R_kfp, t_kfp
            s2 = _repose_keyframe(s2, R_kf, t_kf)
            if _cond(_loop_due(s2, config)):
                s2 = _handle_loop_closure(s2, frame, config, R_kf, t_kf, k_loop)
            st_kf, R_fin, t_fin = s2, R_kf, t_kf

    with profiling.span("step.finish"):
        st_out, out = _finish(st0, st_kf, frame, config, R_fin, t_fin, ekf_st, snap, new_scale,
                              motion_ok, recovered, n_matches=n_matches, n_inl=n_inl,
                              n_tracked=n_tracked, is_kf=is_kf, used_3d3d=used_3d3d,
                              epi_before=epi_before, epi_after=epi_after, bridged=can_bridge,
                              n_depth_ok=n_depth_ok)
        return contiguous_tree(st_out), out


def tracking_step(state: TrackState, frame: FrameFeatures, config: SlamConfig,
                  key) -> Tuple[TrackState, StepOutputs]:
    """One frame through the full tracking state machine, in full f32.
    `key` is a host threefry key (`ops.prng`). Updates the keyframe ring
    of `state` in place (see the module docstring); every leaf of the
    state it returns is contiguous."""
    with profiling.span("step"), f32_matmuls():
        keys = tuple(prng.split(key, 7))
        frame = frame._replace(desc=frame.desc.to(state.kf_desc.dtype))
        if _cond(state.kf_frame_id < 0):
            with profiling.span("step.bootstrap"):
                st, out = _bootstrap(state, frame, config)
                return contiguous_tree(st), out
        STATS["track_frames"] += 1
        return _track(state, frame, config, keys)


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
