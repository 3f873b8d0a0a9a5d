"""Per-component latency and device activities of the tracking step.

The port of `scripts/bench_step_components.py`. The real tracking loop
(`core.tracking.run_frames`, the port's `make_scan_step` loop) first runs
64 frames of the seed-0 synthetic world of 6,000 landmarks, so that the
map is populated as in mid-sequence tracking; then it times, on the last
frame of that world, each row the JAX script prints:

  * the full `tracking_step`, on a fixed state, and with the state
    threaded from iteration to iteration;
  * the real loop over N fresh frames (seed 3) from a fresh state, per
    frame;
  * `_match_to_keyframe` (400x400), the 3D-3D RANSAC (128 hypotheses),
    `svd3x3` at batch 128, `orthonormalize`;
  * `_track_local_map` through the radius kernel (`fused`) and through
    its plain version, `radius_descriptor_match_fused_plain` (`XLA
    blocks`, the JAX script's forced XLA path);
  * `_refine_pnp`, `_fuse_ekf`, `_make_keyframe`, `ransac_pnp` and
    `_motion_essential` (the essential branch body).

As in the JAX script, each iteration's inputs depend on the previous
iteration: a carry scalar, kept on the device, jitters the keypoints and
descriptors, and the RANSAC keys are `prng.fold_in` of the iteration.
`tracking_step` and `_make_keyframe` write the keyframe ring of the state
they are given in place, so those rows work on a copy of the state made
outside the timed region; each iteration then writes the same ring slot
(the input's keyframe count does not change) and does the first one's
work.

A time is the median of 3 runs of `--n` iterations, divided by `--n`
(`utils.profiling.seconds_per_iter`: CUDA events on the card, the host
clock on the CPU). Beside each row stand its device activities per
iteration (`utils.profiling.device_activities`: kernels, copies and fills
from `torch.profiler`, CUDA activity only; null on the CPU), and the
harness's own share (the jitter and the carry update) as
`harness_activities`. The fused local-map row's radius-kernel launches
per call are read from `ops.cuda_matching.LAUNCHES`.

Usage: python -m vslam_tpu_torch.apps.bench_step_components [--cpu]
       [--n 256] [--only pat]
"""

from __future__ import annotations

import argparse
import itertools
import json

import numpy as np
import torch

from vslam_tpu_torch.utils.profiling import bench_device, device_activities, seconds_per_iter


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--n", type=int, default=256, help="iterations per timed run")
    ap.add_argument("--only", type=str, default="", help="substring filter")
    return ap.parse_args(argv)


def main(argv=None):
    from vslam_tpu_torch.config import SlamConfig

    out = run(parse_args(argv), SlamConfig())
    print(json.dumps(out))
    return out


def _world(cfg, n_frames, seed):
    from vslam_tpu_torch.data import synthetic

    c = cfg.camera
    return synthetic.make_sequence(
        num_frames=n_frames, max_keypoints=cfg.frontend.max_keypoints,
        desc_dim=cfg.frontend.descriptor_dim, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
        width=c.width, height=c.height, seed=seed, num_landmarks=6000)


def run(args, cfg):
    """The bench on parsed `args` with config `cfg`. Returns {"device",
    "N", "map_points", "us_per_iter": {row: us}, "activities_per_iter":
    {row: count or None}, "harness_activities", "radius_launches_per_call":
    {"fused", "plain"} (None on the CPU), "local_map_matches": {"fused",
    "plain"} (the keypoints each local-map path matches on the last frame
    unjittered)}."""
    from vslam_tpu_torch.core import pipeline, tracking as T
    from vslam_tpu_torch.core.state import clone_tree, init_state
    from vslam_tpu_torch.ops import cuda_matching, linalg, matching, prng, se3
    from vslam_tpu_torch.ops import pnp as pnp_ops
    from vslam_tpu_torch.ops.linalg import f32_matmuls

    dev = bench_device(args, "bench_step_components")
    c = cfg.camera
    fx, fy, cx, cy = c.fx, c.fy, c.cx, c.cy
    N = args.n

    seq = _world(cfg, 64, seed=0)
    frames = pipeline.features_from_synthetic(seq, device=dev)
    gravity, h0 = pipeline.compute_gravity_direction(seq.accel, np.eye(3, dtype=np.float32))

    def fresh_state():
        return init_state(cfg, gravity=gravity, initial_height=h0, device=dev)

    state, _ = T.run_frames(fresh_state(), frames, list(range(64)), cfg, seed=42)
    frame = T.frame_at(frames, 63)
    frame = frame._replace(desc=frame.desc.to(state.kf_desc.dtype))
    n_map = int(state.map.valid.sum())
    print(f"device={dev}  map points={n_map}  N={N}")

    key0 = prng.prng_key(7)
    carry = {"cr": torch.zeros((), dtype=torch.float32, device=dev)}
    rows = {}

    def row(name, tag=None):
        def add(fn):
            pats = [p for p in args.only.split(",") if p]
            if not pats or any(p in name or p == tag for p in pats):
                rows[name] = fn
            return fn
        return add

    def jitter_xy():
        return frame.xy + carry["cr"] * 1e-6

    def jitter_frame():
        cr = carry["cr"] * 1e-6
        return frame._replace(xy=frame.xy + cr, desc=frame.desc + cr.to(frame.desc.dtype))

    def fold(value):
        """The next carry: depends on this iteration's result."""
        carry["cr"] = torch.sum(value) * 1e-9 + carry["cr"] * 0.5

    def keyed(fn):
        """fn(key) with the key `fold_in(key0, i)` of iteration i."""
        it = itertools.count()
        return lambda: fn(prng.fold_in(key0, next(it)))

    full_st = clone_tree(state)  # its keyframe ring is written in place

    @row("full tracking_step")
    @keyed
    def full_step(key):
        _, out = T.tracking_step(full_st, jitter_frame(), cfg, key)
        fold(out.t)

    threaded = {"st": clone_tree(state), "i": itertools.count(int(state.frame_idx))}

    @row("full step (state threaded)", "threaded")
    def full_threaded():
        st = threaded["st"]
        d = st.t[0] * 1e-12
        f2 = frame._replace(xy=frame.xy + d, desc=frame.desc + d.to(frame.desc.dtype))
        threaded["st"], _ = T.tracking_step(st, f2, cfg, prng.fold_in(key0, next(threaded["i"])))

    framesN = pipeline.features_from_synthetic(_world(cfg, N, seed=3), device=dev)
    # The warm call, 3 runs, and up to 3 profiled sessions (`device_activities`).
    fresh = [fresh_state() for _ in range(7)]

    @row("real scan (fresh state, N frames)", "realscan")
    def real_scan():
        T.run_frames(fresh.pop(), framesN, list(range(N)), cfg, seed=42)

    @row("match_to_keyframe (400x400)")
    def kf_match():
        m, *_ = T._match_to_keyframe(state, jitter_frame(), cfg, key0)
        fold(m.dist)

    m0, uv_kf0, uv_cur0, gated0, _ = T._match_to_keyframe(state, frame, cfg, key0)

    @row("3d3d RANSAC (128 hyp)")
    @keyed
    def r3d(key):
        R3, t3, *_ = T._motion_3d3d(state, frame, cfg, m0, uv_kf0, uv_cur0 + carry["cr"] * 1e-6,
                                    gated0, key)
        fold(t3)

    g = torch.Generator().manual_seed(1)
    A128 = torch.randn((128, 3, 3), generator=g).to(dev)

    @row("svd3x3 batch-128")
    def svd_b():
        _, S, _ = linalg.svd3x3(A128 + carry["cr"] * 1e-6)
        fold(S)

    @row("orthonormalize (single)")
    def ortho1():
        fold(se3.orthonormalize(state.R + carry["cr"] * 1e-6))

    @row("track_local_map (fused)")
    def local_map():
        _, kp_ok, _ = T._track_local_map(state, jitter_frame(), cfg, state.R, state.t)
        fold(kp_ok.float())

    @row("track_local_map (XLA blocks)")
    def local_map_plain():
        f2 = jitter_frame()
        uv_mp, visible = T._project_map(state.map, cfg, state.R, state.t)
        _, kp_ok, _, min_pix_d2 = matching.radius_descriptor_match_fused_plain(
            f2.desc, f2.xy, f2.valid, state.map.desc, uv_mp, visible,
            radius_px=cfg.map.track_search_radius_px, desc_thresh=cfg.map.track_desc_threshold)
        fold(kp_ok.float() + torch.sum(min_pix_d2))

    mp_idx0, kp_ok0, _ = T._track_local_map(state, frame, cfg, state.R, state.t)
    uv_mp0, visible0 = T._project_map(state.map, cfg, state.R, state.t)
    _, kp_ok_plain, _, _ = matching.radius_descriptor_match_fused_plain(
        frame.desc, frame.xy, frame.valid, state.map.desc, uv_mp0, visible0,
        radius_px=cfg.map.track_search_radius_px, desc_thresh=cfg.map.track_desc_threshold)
    local_map_matches = {"fused": int(kp_ok0.sum()), "plain": int(kp_ok_plain.sum())}

    @row("refine_pnp (GN + full)")
    def gn():
        _, t_o, _, _, t_f = T._refine_pnp(state, frame._replace(xy=jitter_xy()), cfg, state.R,
                                         state.t, mp_idx0, kp_ok0, key0)
        fold(t_o + t_f)

    true = torch.ones((), dtype=torch.bool, device=dev)

    @row("fuse_ekf")
    def ekf_c():
        _, fused, _ = T._fuse_ekf(state, frame, cfg, state.t + carry["cr"] * 1e-6, true, true)
        fold(fused)

    kf_st = clone_tree(state)  # its keyframe ring is written in place

    @row("make_keyframe (KF branch)")
    def mkkf():
        st2 = T._make_keyframe(kf_st, frame._replace(xy=jitter_xy()), cfg, state.R, state.t,
                               m0, gated0)
        fold(st2.kf_t)

    X0 = state.map.pos[torch.clamp(mp_idx0.long(), 0, state.map.pos.shape[0] - 1)]
    pc = cfg.pnp

    @row("ransac_pnp (cond branches)")
    @keyed
    def rpnp(key):
        res = pnp_ops.ransac_pnp(key, X0, jitter_xy(), kp_ok0, fx, fy, cx, cy,
                                 num_hypotheses=pc.ransac_iters, threshold_px=pc.ransac_threshold_px,
                                 min_inliers=pc.min_points, gn_iters=pc.gn_iters)
        fold(res.t)

    K = frame.xy.shape[0]
    p_zero = torch.zeros((K, 3), dtype=torch.float32, device=dev)
    d_zero = torch.zeros(K, dtype=torch.bool, device=dev)

    @row("essential branch body")
    @keyed
    def ess(key):
        out = T._motion_essential(state, frame, cfg, uv_kf0, uv_cur0 + carry["cr"] * 1e-6, gated0,
                                  p_zero, p_zero, d_zero, key)
        fold(out[1])

    def harness():
        jitter_frame()
        fold(frame.xy)

    us, acts = {}, {}
    with f32_matmuls():
        for name, fn in rows.items():
            n = 1 if name.startswith("real scan") else N
            per = N if name.startswith("real scan") else 1
            us[name] = seconds_per_iter(fn, n, dev) / per * 1e6
            print(f"{name:36s} {us[name]:10.1f} us/iter", flush=True)
        radius = {}
        for name, fn in rows.items():  # after every timing: a profiler session slows launches
            a = device_activities(fn, dev)
            acts[name] = None if a is None else (a / N if name.startswith("real scan") else a)
        harness_acts = device_activities(harness, dev)
        if dev.type == "cuda":
            for name, fn in (("fused", local_map), ("plain", local_map_plain)):
                cuda_matching.reset_launch_counts()
                fn()
                torch.cuda.synchronize()
                radius[name] = cuda_matching.LAUNCHES["radius_match"]
    print("activities per iteration: " + json.dumps(acts))
    return {"device": str(dev), "N": N, "map_points": n_map, "us_per_iter": us,
            "activities_per_iter": acts, "harness_activities": harness_acts,
            "radius_launches_per_call": radius or None, "local_map_matches": local_map_matches}


if __name__ == "__main__":
    main()
