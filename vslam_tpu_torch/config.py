"""Runtime configuration for the SLAM pipeline.

The PyTorch port keeps its own copy of `vslam_tpu/config.py` (same
classes, fields and defaults) so that it imports nothing of the JAX
package; a config built by either package compares field by field.

Mirrors the reference's compile-time constant namespace
(`include/Config.h:7-148`) as frozen (hashable, immutable) dataclasses.
Static-shape capacities (`max_keypoints`, `map_capacity`, ...) are new — the
reference uses dynamically-sized OpenCV containers; here every array is
fixed-shape with validity masks.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics. Defaults: TUM freiburg2 (Config.h:10-17)."""

    width: int = 640
    height: int = 480
    fx: float = 525.0
    fy: float = 525.0
    cx: float = 319.5
    cy: float = 239.5

    # Depth sensor (Config.h:28-30)
    depth_scale: float = 5000.0  # 16-bit PNG value -> meters divisor
    depth_min: float = 0.1
    depth_max: float = 10.0

    def K(self):
        import numpy as np

        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """SuperPoint detection + matching (Config.h:40-58)."""

    # SuperPoint decode (Config.h:40-42)
    sp_confidence_threshold: float = 0.005
    sp_nms_radius: int = 4
    max_keypoints: int = 400  # static keypoint capacity per frame
    descriptor_dim: int = 256

    # MiDaS (Config.h:45)
    midas_input_size: int = 256

    # ORB fallback (Config.h:48-50) + Hamming matching gates (:54, :56).
    orb_max_keypoints: int = 3000
    orb_scale_factor: float = 1.2
    orb_num_levels: int = 8
    orb_fast_threshold: float = 0.08
    orb_distance_threshold: float = 30.0  # Hamming bits (DISTANCE_THRESHOLD)
    orb_ratio_threshold: float = 0.8  # HAMMING_RATIO_THRESHOLD

    # Matching (Config.h:53-58)
    l2_ratio_threshold: float = 0.75
    flann_ratio_threshold: float = 0.7
    # Absolute L2 distance gate on the best match (0 = off). The reference
    # applies it only on the ORB/Hamming path (DISTANCE_THRESHOLD=30 bits,
    # Config.h:54); orb_parity_config sets the L2 equivalent.
    l2_max_distance: float = 0.0
    min_matches: int = 30
    min_inliers: int = 15
    mutual_check: bool = True


@dataclasses.dataclass(frozen=True)
class MotionConfig:
    """Two-view motion estimation (Config.h:61-73, 129)."""

    # Essential-matrix RANSAC (Config.h:61-62)
    em_ransac_iters: int = 128  # batched hypotheses (reference: prob-adaptive)
    em_ransac_threshold_px: float = 1.0

    # Fundamental gate (Slam.cpp:885 uses FM_RANSAC 3.0 px)
    fm_ransac_iters: int = 128
    fm_ransac_threshold_px: float = 3.0
    # Reference-parity F-gate on the MAIN path: the reference gates EVERY
    # frame's matches through findFundamentalMat and records mean
    # symmetric epipolar error before/after (`src/Slam.cpp:879-910`).
    # When False, the gate runs only inside the Essential fallback (the
    # 3D-3D RANSAC is itself robust; skipping the gate there saves
    # ~0.2 ms/frame at equal ATE on synthetic oracles — see BENCH_NOTES).
    fgate_main_path: bool = True

    # 3D-3D RANSAC (Config.h:65-67)
    r3d_iters: int = 128  # reference: 200 sequential; batched refinement
    # recovers precision, so 128 keeps miss-probability negligible
    r3d_inlier_thresh: float = 0.05
    r3d_max_translation: float = 0.2
    r3d_min_translation: float = 1e-4
    # Gap-aware relaxation of the 0.2 m translation gate — the gate is
    # applied to the KEYFRAME-relative translation (`src/Slam.cpp:360-371`
    # matches against the last keyframe too), so at keyframe gaps >= 9
    # any sequence moving ~24 mm/frame exceeds it with a perfectly good
    # 3D-3D estimate and falls to the far-worse essential fallback
    # (measured on the coupled bench: 171/895 essential frames at 0.26
    # deg/frame rotation error vs 0.007 on 3D-3D, with ~175 depth-valid
    # matches available — the gate, not point starvation, was the
    # trigger). Effective cap = max(r3d_max_translation,
    # gap * r3d_max_translation_per_frame); 0 disables (reference
    # parity). 0.05 m/frame mirrors the EKF's own per-frame step clamp
    # headroom (Config.h EKF_MAX_STEP 0.10).
    r3d_max_translation_per_frame: float = 0.05

    # Monocular scale fallback (Config.h:129)
    motion_scale: float = 0.05

    # EKF scale prior for the essential fallback — NEW vs the reference
    # (`src/Slam.cpp:975-980` trusts the fresh depth-scale solve, then
    # last_scale). At small keyframe baselines the per-match scale solves
    # are low-SNR and biased (probe: single-view +10..15% at gap-1
    # baselines, two-view -16% at 0.7 px noise; the coupled run measured
    # a +23% essential-branch step-scale bias that dominates translation
    # drift). The EKF's predicted distance-from-keyframe
    # ||x + v dt - kf_t|| is a far better prior there: fresh estimates
    # deviating more than `mono_scale_gate` from it are replaced by it,
    # and accepted ones are averaged with it. False restores the
    # reference chain exactly.
    mono_scale_ekf_prior: bool = True
    mono_scale_gate: float = 0.3


@dataclasses.dataclass(frozen=True)
class PnPConfig:
    """PnP refinement/recovery/periodic policy (Config.h:76-84)."""

    interval: int = 5
    min_points: int = 10
    ransac_threshold_px: float = 8.0
    ransac_iters: int = 128  # reference solvePnPRansac uses 100-300
    gn_iters: int = 8  # Huber-GN converges in <6 on pre-gated corrs
    # Per-frame local refine starts from the CURRENT pose on pre-gated
    # (12 px / 0.5 desc) correspondences — 4 iterations suffice there,
    # and this runs every frame (RANSAC paths keep gn_iters).
    refine_gn_iters: int = 4
    recovery_max_jump: float = 1.5
    recovery_blend_close: float = 0.8
    recovery_blend_far: float = 0.3
    refine_max_jump: float = 1.0
    periodic_max_jump: float = 1.5
    periodic_blend: float = 0.5
    recovery_cooldown_frames: int = 10  # Slam.cpp:559 cooldown
    # Register KEYFRAMES at the fully-applied GN-refined pose instead of
    # the reference's 0.3-0.5 blended one (`src/Slam.cpp:1373-1473`
    # blends every frame; the keyframe then inherits 50-70% of the
    # pre-refine pose error, and each anchor switch bakes that error
    # into the chain — the coupled run's largest remaining ATE term is exactly
    # this per-switch rotation random walk). The per-frame OUTPUT
    # trajectory keeps the reference's blend; only the stored keyframe
    # (and the map points back-projected from it) use the full refine.
    # Same jump/min-point gates as the blended path.
    kf_refine_full: bool = True


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Map store capacities + keyframe / triangulation / culling policy.

    Policy constants: Config.h:70-73 (triangulation), 87-88 (keyframe),
    108-115 (tracking + culling); capacities are TPU static shapes.
    """

    map_capacity: int = 16384  # max live map points
    # Keyframe ring size. 256 retains EVERY keyframe at the reference's
    # true sequence scale (a 2,544-frame run makes ~250 keyframes), which
    # is what the reference's unbounded store gives loop closure
    # (`src/Map.cpp:20-30`): at 128, the ring had already overwritten the
    # oldest ~70 keyframes — the revisit anchors — by the time the first
    # loop check could fire, so production-cadence closure structurally
    # could not see its anchors (round-4 measured `loop_constraints: 0`
    # on every long run). The PGO pose block at (256*6)^2 is still
    # trivial on the MXU.
    keyframe_capacity: int = 256

    # Triangulation gates (Config.h:70-73)
    triang_max_reproj_px: float = 3.0
    triang_min_depth: float = 0.05
    triang_max_depth: float = 50.0
    triang_max_cam_dist: float = 5.0

    # Keyframe policy (Config.h:87-88; Slam.cpp:1062-1070)
    kf_min_frame_gap: int = 10
    kf_min_matches: int = 50
    kf_proactive_max_matches: int = 60
    kf_proactive_min_gap: int = 5

    # Local-map tracking (Config.h:108-111)
    track_search_radius_px: float = 12.0
    track_desc_threshold: float = 0.5
    track_visibility_radius_px: float = 8.0

    # Culling (Config.h:114-115; Slam.cpp:1111-1126, 473-500)
    cull_found_ratio_young: float = 0.15
    cull_found_ratio_old: float = 0.30
    cull_reproj_px: float = 20.0
    cull_interval_kfs: int = 3


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    """Loop closure (Config.h:91-96)."""

    min_frame_gap: int = 200
    min_inliers: int = 30
    # Check cadence — DELTA from the reference's every-200th-keyframe
    # check (`Config.h:93`, `src/Slam.cpp:1084`). At 200, a 2,544-frame
    # run fires exactly ONE check; if that single attempt fails its
    # gates (texture dropout, excess drift) the run closes zero loops —
    # measured on the round-4 long bench. Checking every 8th keyframe
    # (~every 80 frames) keeps every other gate at reference strength
    # (the 200-frame age gate still ensures genuine revisits) while
    # giving each revisit region several attempts; the batched all-KF
    # matcher makes a check ~0.3 ms, so the amortized cost is noise.
    # 200 restores exact reference cadence.
    check_interval_kfs: int = 8
    # Min frames between ACCEPTED constraints: with the denser cadence a
    # single revisit stretch would otherwise fill the constraint buffer
    # with near-duplicate edges; spacing keeps slots for distinct
    # revisits (the reference spaces implicitly via its 200-KF cadence).
    min_frames_between_accepts: int = 40
    max_jump: float = 0.5
    min_jump: float = 0.01
    # (The reference's ±30-frame nearby-map-point gather for the PnP
    # verification, `src/Slam.cpp:744-775`, is redesigned away: PnP runs
    # against the anchor keyframe's own depth-backprojected keypoints —
    # see `tracking._handle_loop_closure` — so no nearby_frame_range.)
    kf_stride: int = 5  # LoopCloser.cpp:43-48: every 5th candidate KF
    # Two-stage constraint polish (delta from `src/Slam.cpp:778-797`,
    # which takes solvePnPRansac's 8 px-gated pose as the constraint
    # directly): re-select correspondences at a tight pixel threshold
    # against the RANSAC pose, then Huber-GN with a small delta. The
    # constraint feeds PGO at sigma_t=0.03 m (Config.h:134); at VGA-scale
    # focals the 8 px gate admits map points with tens-of-cm lateral
    # slack, which dominates that budget. refine_threshold_px=0 disables.
    refine_threshold_px: float = 2.0
    refine_huber_px: float = 1.0
    refine_gn_iters: int = 8


@dataclasses.dataclass(frozen=True)
class EKFConfig:
    """6-state constant-velocity EKF + gravity/height prior (Config.h:140-146)."""

    sigma_vis_3d3d: float = 0.04
    sigma_vis_emat: float = 0.10
    sigma_height: float = 0.01
    process_accel: float = 1.0
    vel_decay: float = 0.95
    innovation_gate: float = 0.3
    max_step: float = 0.10
    stationary_accel_std: float = 0.15  # Slam.cpp:1621-1651
    stationary_window_s: float = 0.1
    stationary_kf_rot_drift: float = 0.25  # Slam.cpp:618-694
    # RTS + refine delta — NEW vs the reference smoother
    # (`src/Slam.cpp:1761-1810`): the EKF snapshots the smoother consumes
    # are taken BEFORE local-map PnP refinement (reference order too,
    # `Slam.cpp:1039-1046` vs `:1058-1059`), so plain RTS silently
    # DISCARDS the refinement when it overwrites positions. Keeping the
    # per-frame refine delta on top (t_rts + (t_raw - x_filt)) was >= the
    # plain smoother on every measured run (healthy 128f: 0.0169 ->
    # 0.0125; drifted 896f: 0.2104 -> 0.2103; healthy 896f: 0.0299 ->
    # 0.0281). False restores the reference smoother output.
    smooth_keep_refine: bool = True
    # Parallel-in-time RTS: associative-scan composition of the backward
    # affine recursion (log-depth batched 6x6 MXU matmuls) instead of the
    # N-step sequential scan. Numerically equivalent (float round-off);
    # False = sequential backward scan, bit-parity with `Slam.cpp:1761-1810`.
    rts_parallel: bool = True


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """LM pose optimizer / local BA / PGO (Config.h:98-105, 132-137)."""

    # The reference ships local BA implemented-but-disabled (Config.h:99)
    # because an un-gated BA can regress a well-tracked trajectory. Ours
    # accepts a window only when its Huber reprojection chi^2 strictly
    # improves (ops.ba.window_cost gain gate), so it is safe to enable.
    enable_local_ba: bool = True
    ba_max_jump: float = 0.5
    ba_window_kfs: int = 10
    ba_max_points: int = 2048
    # Post-hoc BA in the fused backend solves the WHOLE keyframe ring as
    # one masked Schur problem (the reference's disabled local BA ran per
    # new keyframe and so covered the chain incrementally,
    # `src/Slam.cpp:709-722`; a single end-window cannot correct
    # accumulated drift, and a joint solve converges further than a
    # window sweep). The pose block is only (keyframe_capacity*6)^2 —
    # trivial on the MXU.
    ba_global_max_points: int = 4096
    ba_global_iterations: int = 20
    # Metric point prior (map points are Kinect-depth back-projections;
    # sigma_z ~ 2-3 cm -> 1/sigma^2 ~ 1e3 m^-2, comparable to the
    # reprojection information): points resist being dragged to chase
    # drifted poses — the overfit mode that made the reference ship
    # local BA disabled (Config.h:98-99). With it, BA can safely fire
    # below the old 4 px^2 significance threshold. Significance MAY
    # still open on a healthy run (the 848-frame oracle measures
    # ~1 px^2/obs through the tight 4 px re-association); identity is
    # then enforced by the improvement conditions of the accept gate,
    # and `ba_converge_rtol` keeps the price of that probe at ~2 LM
    # iterations instead of the full budget.
    ba_point_prior_weight: float = 1000.0
    ba_chain_min_cost_per_obs: float = 0.25
    # Convergence early-exit for the backend LM loops: stop after two
    # consecutive iterations improving the cost by < rtol relative.
    # 0.0 = fixed iteration count (exact round-2 behavior).
    ba_converge_rtol: float = 1e-4
    # BA re-associates observations by projecting map points into each
    # keyframe and radius-matching descriptors. The tracker's loose
    # 12 px search radius is right for FINDING points under pose error,
    # but wrong for OPTIMIZING against: with real (noisy) descriptors a
    # 12 px radius admits mismatches that reprojection cost happily
    # "improves" while dragging poses away from truth (measured: a
    # healthy 128-frame coupled run regressed 0.019 -> 0.047 m ATE).
    # Tracked poses put TRUE re-observations within ~1-2 px, so a tight
    # association radius + a tight initial-residual outlier gate keep
    # the BA problem honest.
    ba_obs_radius_px: float = 4.0
    ba_obs_desc_threshold: float = 0.4
    ba_gate_px: float = 4.0
    # Odometry (relative-pose) edges between consecutive keyframes inside
    # the BA normal equations: reprojection alone leaves long-wavelength
    # bending modes of the chain nearly unconstrained, so pixel noise
    # moves whole pose runs coherently by centimeters (measured on a
    # healthy coupled run). The tracker's relative poses pin those modes;
    # genuine corrections with real reprojection evidence still flow
    # (the sigmas state the odometry's honest accuracy).
    # Sigma calibration (128-frame healthy coupled probe, input ATE
    # 0.0194 m): (0.05, 0.02) -> 0.0301 (hurts), (0.02, 0.01) -> 0.0205,
    # (0.01, 0.005) -> 0.0182 (improves); drifted-chain correction
    # capacity at (0.01, 0.005) is still 2.4x (0.148 -> 0.061 m probe).
    # Association radius 4 px beats 8/12 px on the same probe (wider
    # radii re-admit the mismatch drag the odometry edges suppress).
    ba_odom_trans_sigma: float = 0.01
    ba_odom_rot_sigma: float = 0.005
    # Holdout validation gate (round-5, VERDICT r4 #2): a deterministic
    # fraction of BA observations is withheld from the solve, and the
    # solution is accepted only if it ALSO improves the Huber
    # reprojection cost on the withheld set. The internal-cost gates can
    # accept steps that fit measurement noise (round-4: stress ATE
    # 0.059 -> 0.0643 post-backend); held-out generalization is the
    # honest accept test. 0 disables (round-4 behavior).
    ba_holdout_frac: float = 0.1
    ba_huber_px: float = 5.0
    max_iterations: int = 10
    convergence: float = 1e-6
    lm_lambda: float = 1e-3

    # Backend gain gates (new vs the reference, whose PGO/BA are dead or
    # disabled): a pass RUNS only when its constraint residuals are
    # significantly above their sigmas (below that, "optimizing" merely
    # transfers measurement noise into the trajectory — the regression
    # mode that made the reference ship BA off, Config.h:98-99), and its
    # output is ACCEPTED only when the metric strictly improves.
    pgo_min_chi2_per_dof: float = 2.0  # ~1.4 sigma mean residual to fire

    pgo_odom_trans_sigma: float = 0.05
    pgo_odom_rot_sigma: float = 0.02
    pgo_lc_trans_sigma: float = 0.03
    pgo_lc_rot_sigma: float = 0.01
    pgo_height_sigma: float = 0.005
    pgo_iterations: int = 20
    max_loop_constraints: int = 32
    # Accept a PGO solve that USES loop edges only when it moves some
    # keyframe by at least this much: loop edges carry
    # ~pgo_lc_trans_sigma of measurement noise, so sub-floor
    # "corrections" inject noise instead of removing drift (stress-world
    # round-4/5 bench: 0.059 -> 0.0711 post-backend from ONE noisy
    # edge). Genuine drift at loop-closure scale moves keyframes by
    # decimeters. Height-only passes (no loop edges) are unaffected.
    pgo_loop_min_correction_m: float = 0.08
    # A SINGLE loop edge has no redundancy: the consensus-DCS weights
    # below need >= 2 edges to cross-check, so a lone edge's ~sigma_t of
    # measurement noise passes straight into the solve. Accept a
    # one-edge solve only when the implied correction dwarfs that noise
    # (~8 sigma). Measured: the stress-world bench accepts its single
    # noisy edge at the 0.08 floor and degrades ATE 0.059 -> 0.0657;
    # genuine one-edge corrections (the 0.5 m drifted-gap test) clear
    # 0.25 easily.
    pgo_single_loop_min_correction_m: float = 0.25
    # DCS (Dynamic Covariance Scaling) on loop-closure edges: a loop edge
    # whose chi^2 exceeds phi is down-weighted by s = 2*phi/(phi+chi2),
    # so one wrong closure that slipped the detection gates cannot drag
    # the whole graph (round-5; the reference trusts its gates outright,
    # `Optimizer.cpp:723-755`). A consistent edge at the sigmas has
    # chi^2 ~ 6 (dof); phi=16 leaves <=1.6-sigma edges at full weight.
    pgo_loop_dcs_phi: float = 16.0

    # IN-RUN loop correction (the streaming form of the reference's
    # loop-closure -> PGO design point, `src/Slam.cpp:730-798` +
    # `Optimizer.cpp:654-863`): when a coupled chunk accepts a new loop
    # constraint, a gain-gated PGO runs INSIDE the coupled program and
    # its correction feeds back into the live tracking state (ring, map,
    # current pose, EKF) — see `pipeline.inrun_pgo_correct`. Without it,
    # drift keeps accumulating after the first closure until later
    # constraints fail the 0.5 m jump gate. Zero cost on loop-free runs
    # (the lax.cond never takes the branch).
    inrun_pgo: bool = True
    inrun_pgo_iterations: int = 10
    # Fold an in-run correction back into the live state only when the
    # newest keyframe moves by at least this much. A fresh loop edge's
    # pose carries up to ~0.08 m of measurement noise (rehearsal:
    # accepted constraints with t_err 0.007-0.077): sub-noise folds
    # inject that noise into the live state, and each fold STEERS the
    # rest of the run (later tracking, loop candidates and folds all
    # shift), so the floor is the most sensitive constant in the
    # backend. Measured on the 2,560-frame image-level long bench
    # (scripts/diag_long_variants.py, raw ATE): floor 0.0 -> 1.36 (noise
    # folds cascade), 0.08 -> 0.15, 0.12 -> 1.33 (a needed fold skipped,
    # the run bends, later folds fire in inconsistent frames), 0.20 ->
    # 0.27, no in-run -> 0.40. The noise band's upper edge (~0.08,
    # = 2.7x pgo_lc_trans_sigma) is the principled choice: every fold
    # it admits moves the state by more than the edge noise.
    inrun_min_correction_m: float = 0.08


@dataclasses.dataclass(frozen=True)
class DenseConfig:
    """Dense RGB-D fusion (Config.h:118-120)."""

    pixel_step: int = 8
    max_depth: float = 5.0
    voxel_size: float = 0.02
    hash_capacity: int = 1 << 21  # device-side voxel hash table slots
    cloud_capacity: int = 1 << 20  # max accumulated dense points
    # Frames folded into one voxel-hash insert pass (exact-equivalent to
    # sequential insertion at any value — test_dense_fusion_frame_
    # batching_exact). ~16 is the measured optimum on the v5e; larger
    # batches showed no further gain (BENCH_NOTES round-2 sweep).
    fuse_frames_per_insert: int = 16


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Orchestration (Config.h:123; main.cpp:1036-1478)."""

    frame_step: int = 3  # process every Nth frame
    chunk_size: int = 64  # frames per scanned device chunk
    inference_batch: int = 16  # SuperPoint batch size in the frontend
    dtype_compute: str = "bfloat16"  # conv compute dtype
    dtype_geometry: str = "float32"


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    motion: MotionConfig = dataclasses.field(default_factory=MotionConfig)
    pnp: PnPConfig = dataclasses.field(default_factory=PnPConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    loop: LoopClosureConfig = dataclasses.field(default_factory=LoopClosureConfig)
    ekf: EKFConfig = dataclasses.field(default_factory=EKFConfig)
    opt: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    dense: DenseConfig = dataclasses.field(default_factory=DenseConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)

    rgbd: bool = True  # RGB-D (3D-3D path) vs monocular (E-matrix path)

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)


def tiny_test_config() -> SlamConfig:
    """Small-capacity config for fast CPU tests and multi-chip dry runs."""
    return SlamConfig(
        camera=CameraConfig(width=160, height=120, fx=120.0, fy=120.0, cx=79.5, cy=59.5),
        frontend=FrontendConfig(max_keypoints=64, descriptor_dim=64),
        motion=MotionConfig(em_ransac_iters=32, fm_ransac_iters=32, r3d_iters=32),
        pnp=PnPConfig(ransac_iters=32),
        map=MapConfig(map_capacity=512, keyframe_capacity=16),
        opt=OptimizerConfig(
            ba_max_points=128, ba_global_max_points=256,
            max_loop_constraints=8,
        ),
        dense=DenseConfig(hash_capacity=1 << 12, cloud_capacity=1 << 12),
        runtime=RuntimeConfig(chunk_size=8, inference_batch=4),
    )
