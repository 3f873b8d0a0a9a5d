"""Full SLAM application on a TUM RGB-D directory: the `main()` equivalent.

Port of `examples/run_tum.py` (the reference binary's end-to-end flow,
`src/main.cpp:1483-1561`, and its SLAM thread `:1036-1478`):

  load TUM sequence -> gravity and stationarity from the accelerometer ->
  SuperPoint (or ORB) features, or a cache replay -> the tracking step
  over every FRAME_STEP-th frame with RTS smoothing -> post-hoc PGO (or
  PGO + BA with --ba) -> dense fusion -> ATE/RPE against ground truth ->
  trajectory and PLY exports -> viewer.html -> one `[summary]` JSON line.

Usage:
  python -m vslam_tpu_torch.apps.run_tum <dataset_dir> [--out out_torch/] [--mono]
      [--midas] [--live [--restart-at N]] [--frame-step 3] [--cache sp.npz]
      [--poisson] [--max-frames N] [--orb] [--ba] [--cpu]

It runs on the CUDA card; `--cpu` runs it on the CPU instead, and without
`--cpu` it raises when there is no card. `--render` draws the JAX app's
viewer frames with cv2 (`viz.viewer`: the card has no matplotlib).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time

import numpy as np
import torch

# MiDaS checkpoints are looked for here (relative to the working directory).
MIDAS_SEARCH_DIRS = ("models", "weights")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="vslam_tpu_torch on a TUM RGB-D directory")
    ap.add_argument("dataset", help="TUM sequence directory")
    ap.add_argument("--out", default="out_torch")
    ap.add_argument("--mono", action="store_true", help="monocular mode (ignore depth)")
    ap.add_argument("--midas", action="store_true",
                    help="in mono mode, fill depth from the depth estimator for the scale "
                    "chain: MiDaS weights when a checkpoint exists, else the trained "
                    "synthetic DepthNet")
    ap.add_argument("--live", action="store_true",
                    help="streaming mode: process the sequence in chunks, rewriting the "
                    "viewer after every chunk")
    ap.add_argument("--restart-at", type=int, default=0,
                    help="in --live mode, restart the pipeline (fresh state) at this "
                    "processed-frame index; each segment exports its own trajectory")
    ap.add_argument("--frame-step", type=int, default=3)
    ap.add_argument("--cache", default=None, help="feature cache path (.npz or SPCF .bin)")
    ap.add_argument("--poisson", action="store_true",
                    help="Poisson mesh the dense cloud (external PoissonRecon when present, "
                    "else the native ops/poisson solver)")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--render", action="store_true",
                    help="render viewer frames (PNG scene and HUD frames under OUT/viz)")
    ap.add_argument("--orb", action="store_true", help="use the ORB fallback frontend")
    ap.add_argument("--ba", action="store_true",
                    help="apply bundle adjustment after PGO (the reference ships with "
                    "ENABLE_LOCAL_BA=false)")
    return ap.parse_args(argv)


def main(argv=None):
    """Parse `argv` (the command line when None) and run the app at the
    default configuration; returns what `run` returns."""
    args = parse_args(argv)
    from vslam_tpu_torch.config import SlamConfig

    return run(args, SlamConfig(rgbd=not args.mono))


def _device(args) -> torch.device:
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run_tum runs on the card (pass --cpu for the CPU)")
    return torch.device("cuda")


def _stack_outputs(outs_list):
    from vslam_tpu_torch.core.state import StepOutputs

    return StepOutputs(*(torch.cat(f) for f in zip(*outs_list)))


def _dense_host(dstate):
    """(xyz, rgb) of the fused cloud on the host, or None when empty."""
    n = int(dstate.cloud_count)
    if not n:
        return None
    return dstate.cloud_xyz[:n].cpu().numpy(), dstate.cloud_rgb[:n].cpu().numpy()


def run(args, cfg):
    """The app on parsed `args` with config `cfg` (what `main` builds:
    `SlamConfig(rgbd=not args.mono)`). Returns (summary, [RunResult] of
    each segment): the printed `[summary]` dict, to which the returned one
    adds what the JAX app does not print (`poisson`: what the mesher ran;
    `inrun_pgo`: the in-run corrections of a live run)."""
    dev = _device(args)
    from vslam_tpu_torch.core import frontend as fe, pipeline
    from vslam_tpu_torch.data import loader as loader_mod, tum
    from vslam_tpu_torch.eval import ate as ate_mod
    from vslam_tpu_torch.io import ply, trajectory
    from vslam_tpu_torch.ops import gridhash, pointcloud as pc
    from vslam_tpu_torch.viz import web as webviz

    os.makedirs(args.out, exist_ok=True)
    cam = cfg.camera

    # ---- L1: dataset ----
    ld = loader_mod.open_sequence(args.dataset, width=cam.width, height=cam.height,
                                  depth_scale=cam.depth_scale)
    seq_meta = tum.load_sequence(args.dataset)
    n_total = len(ld)
    step = args.frame_step
    idxs = list(range(0, n_total, step))
    if args.max_frames:
        idxs = idxs[: args.max_frames]
    print(f"[data] {n_total} frames, processing every {step}rd -> {len(idxs)}")

    t0 = time.perf_counter()
    ld.prefetch(0, step, len(idxs))
    grays, depths, stamps, rgbs = [], [], [], []
    for i in idxs:
        rgb, depth, ts = ld.get(i)
        grays.append(np.mean(rgb, axis=-1).astype(np.float32) / 255.0)
        depths.append(depth if not args.mono else np.zeros_like(depth))
        rgbs.append(rgb)
        stamps.append(ts)
    grays = np.stack(grays)
    depths = np.stack(depths)
    stamps = np.asarray(stamps)
    print(f"[data] decoded in {time.perf_counter() - t0:.1f}s (python loader)")

    # ---- IMU priors ----
    gravity, h0, stationary = None, 0.0, None
    if seq_meta.accel is not None:
        gravity, h0 = pipeline.compute_gravity_direction(seq_meta.accel, np.eye(3))
        stationary = pipeline.detect_stationary(seq_meta.accel, stamps)
        print(f"[imu] gravity {gravity}, stationary frames: {int(stationary.sum())}")

    # ---- Mono depth estimation: MiDaS weights when present, else the
    # trained DepthNet ----
    if args.mono and args.midas:
        depths = _mono_depth(cfg, grays, dev)

    if args.live:
        return _run_live(args, cfg, dev, grays, depths, stamps, rgbs, gravity, h0, stationary,
                         seq_meta, idxs)

    # ---- L2: frontend ----
    t0 = time.perf_counter()
    front = fe.make_frontend(cfg, kind="orb" if args.orb else "auto", device=dev)
    print(f"[frontend] weights: {front.weight_source}")
    frames = fe.extract_sequence(
        front, grays, depths, stamps, stationary=stationary,
        cache_path=args.cache, frame_indices=np.asarray(idxs),
    )
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"[frontend] features in {time.perf_counter() - t0:.1f}s")

    # ---- L4: tracking + RTS ----
    t0 = time.perf_counter()
    result = pipeline.run_tracking(frames, cfg, gravity=gravity, initial_height=h0,
                                   smooth=True, device=dev)
    dt = time.perf_counter() - t0
    print(f"[track] {len(idxs)} frames in {dt:.2f}s ({len(idxs) / dt:.1f} fps)")

    # ---- post-hoc PGO (+ optional BA), one pass ----
    if args.ba or cfg.opt.enable_local_ba:
        result = pipeline.run_backend(result, cfg, gravity=gravity, initial_height=h0)
    else:
        result = pipeline.run_posthoc_pgo(result, cfg, gravity=gravity, initial_height=h0)

    # ---- dense cloud ----
    t0 = time.perf_counter()
    dstate = gridhash.init_dense_map(cfg.dense.hash_capacity, cfg.dense.cloud_capacity,
                                     device=dev)
    dstate = gridhash.fuse_sequence(
        dstate, torch.from_numpy(depths).to(dev), torch.from_numpy(np.stack(rgbs)).to(dev),
        torch.from_numpy(result.R).to(dev), torch.from_numpy(result.t_smoothed).to(dev),
        cam.fx, cam.fy, cam.cx, cam.cy,
        pixel_step=cfg.dense.pixel_step, max_depth=cfg.dense.max_depth,
        voxel_size=cfg.dense.voxel_size, chunk=cfg.runtime.chunk_size,
    )
    dense = _dense_host(dstate)
    n_dense = 0 if dense is None else len(dense[0])
    print(f"[dense] {n_dense} voxel-deduped points in {time.perf_counter() - t0:.2f}s")

    # ---- evaluation ----
    if seq_meta.gt is not None:
        gt = seq_meta.gt
        res_ate = ate_mod.compute_ate(stamps, result.t_smoothed, gt[:, 0], gt[:, 1:4])
        res_rpe = ate_mod.compute_rpe(stamps, result.t_smoothed, gt[:, 0], gt[:, 1:4])
        print(f"[eval] ATE RMSE: {res_ate.rmse:.4f} m (mean {res_ate.mean:.4f}, "
              f"pairs {res_ate.num_pairs})")
        print(f"[eval] RPE RMSE: {res_rpe.rmse:.4f} m/step")

    # ---- exports (main.cpp:1340-1477) ----
    trajectory.save_trajectory(os.path.join(args.out, "estimated_trajectory.txt"),
                               stamps, result.t_smoothed)
    trajectory.save_trajectory_full(os.path.join(args.out, "estimated_trajectory_full.txt"),
                                    stamps, result.R, result.t_smoothed)
    st = result.final_state
    map_valid = st.map.valid
    sparse = st.map.pos[map_valid]
    n_sparse = int(sparse.shape[0])
    if n_sparse:
        # Beautification chain (main.cpp:1340-1404): bbox -> SOR ->
        # surface-aware filter -> densify -> normals -> PLY with normals.
        pts, normals = pc.beautify_cloud(
            sparse, torch.ones(n_sparse, dtype=torch.bool, device=dev), traj=result.t_smoothed)
        ply.save_ply(os.path.join(args.out, "estimated_map.ply"), pts, normals=normals)
        print(f"[map] beautified sparse cloud: {n_sparse} -> {len(pts)} "
              f"points (densified, with normals)")
    if n_dense:
        ply.save_ply(os.path.join(args.out, "dense_map.ply"), dense[0], colors=dense[1])

    # ---- interactive viewer: one self-contained HTML ----
    webviz.export_run(
        result, os.path.join(args.out, "viewer.html"), dense=dense,
        gt_trajectory=None if seq_meta.gt is None else seq_meta.gt[:, 1:4],
        title=f"vslam_tpu_torch — {os.path.basename(os.path.normpath(args.dataset))}",
    )
    print(f"[viewer] interactive viewer: {os.path.join(args.out, 'viewer.html')}")

    poisson = None
    if args.poisson:
        poisson = run_poisson(os.path.join(args.out, "dense_map.ply"), args.out, device=dev)

    if args.render:
        render_frames(args, cfg, result, frames, grays, dense)

    summary = {
        "frames": len(idxs),
        "track_fps": round(len(idxs) / dt, 2),
        "keyframes": int(result.final_state.keyframes.valid.sum()),
        "map_points": int(result.final_state.map.valid.sum()),
        "dense_points": n_dense,
    }
    if seq_meta.gt is not None:
        summary["ate_rmse_m"] = round(res_ate.rmse, 4)
        summary["rpe_rmse_m"] = round(res_rpe.rmse, 4)
    print("[summary] " + json.dumps(summary))
    print(f"[done] outputs in {args.out}/")
    if poisson is not None:
        summary["poisson"] = poisson
    return summary, [result]


def _mono_depth(cfg, grays, dev):
    """Per-frame depth for a monocular run (the reference's latent
    DepthEstimator): MiDaS when a checkpoint exists (relative inverse depth
    mapped to pseudo-metric depth for the scale chain), else the trained
    DepthNet (metric log depth, nearest-cell upsampled to full
    resolution); without either, the zeros of a pure monocular run."""
    from vslam_tpu_torch.models import depthnet as dn_mod, midas as midas_mod
    from vslam_tpu_torch.models import weights as weights_mod

    t0 = time.perf_counter()
    midas_ckpt = weights_mod.find_checkpoint(MIDAS_SEARCH_DIRS, weights_mod.MIDAS_NAMES)
    if midas_ckpt is not None:
        model, src = weights_mod.load_or_init_midas(MIDAS_SEARCH_DIRS, device=dev)
        print(f"[midas] weights: {src}")
        rel = []
        for k in range(0, len(grays), 8):
            batch = np.stack([np.stack([g] * 3, -1) for g in grays[k:k + 8]]).astype(np.float32)
            rel.append(midas_mod.estimate_depth(
                model, torch.from_numpy(batch).to(dev),
                size=cfg.frontend.midas_input_size).cpu().numpy())
        rel = np.concatenate(rel)
        depths = 3.0 / np.maximum(rel, 0.2)
    elif not os.path.exists(weights_mod.TRAINED_DN_NPZ):
        print("[depth] no MiDaS checkpoint and no trained DepthNet: random depth would "
              "poison the scale chain; staying pure-mono")
        return np.zeros(grays.shape, np.float32)
    else:
        print(f"[depth] DepthNet weights: {weights_mod.TRAINED_DN_NPZ}")
        model = weights_mod.load_depthnet(device=dev)
        dep = []
        for k in range(0, len(grays), 16):
            g_u8 = torch.from_numpy((grays[k:k + 16] * 255.0).astype(np.uint8)).to(dev)
            d = np.exp(dn_mod.predict_log_depth(model, g_u8).cpu().numpy())
            d = d.repeat(dn_mod.OUT_STRIDE, 1).repeat(dn_mod.OUT_STRIDE, 2)[
                :, : grays.shape[1], : grays.shape[2]]
            dep.append(d.astype(np.float32))
        depths = np.concatenate(dep)
    print(f"[depth] estimated depth for {len(grays)} frames in "
          f"{time.perf_counter() - t0:.1f}s")
    return depths


def _run_live(args, cfg, dev, grays, depths, stamps, rgbs, gravity, h0, stationary, seq_meta,
              idxs):
    """Streaming mode (`examples/run_tum.py:_run_live`): per chunk, the
    frontend, the tracking step continuing from the carried state, the
    in-run PGO when the chunk accepted a loop constraint, dense fusion and
    a viewer rewrite of the segment so far; `--restart-at N` starts a
    fresh state at processed frame N (the reference's UI-triggered
    restart), each segment exporting its own trajectory."""
    from vslam_tpu_torch.core import frontend as fe, pipeline
    from vslam_tpu_torch.core.state import init_state
    from vslam_tpu_torch.eval import ate as ate_mod
    from vslam_tpu_torch.io import trajectory
    from vslam_tpu_torch.ops import gridhash
    from vslam_tpu_torch.viz import web as webviz

    cam = cfg.camera
    chunk = cfg.runtime.chunk_size
    n = len(idxs)
    viewer_path = os.path.join(args.out, "viewer.html")
    front = fe.make_frontend(cfg, kind="orb" if args.orb else "auto", device=dev)
    print(f"[live] frontend weights: {front.weight_source}; "
          f"chunk={chunk}; restart_at={args.restart_at or 'off'}")

    def fresh():
        return (init_state(cfg, gravity=gravity, initial_height=h0, device=dev),
                gridhash.init_dense_map(cfg.dense.hash_capacity, cfg.dense.cloud_capacity,
                                        device=dev),
                [])

    def smoothed(state, outs_list):
        return pipeline.result_from_outputs(state, _stack_outputs(outs_list), smooth=True,
                                            keep_refine=cfg.ekf.smooth_keep_refine,
                                            rts_parallel=cfg.ekf.rts_parallel)

    def finalize(state, outs_list, seg_id):
        result = smoothed(state, outs_list)
        suffix = f"_seg{seg_id}" if args.restart_at else ""
        trajectory.save_trajectory(os.path.join(args.out, f"estimated_trajectory{suffix}.txt"),
                                   result.timestamps, result.t_smoothed)
        if seq_meta.gt is not None:
            gt = seq_meta.gt
            a = ate_mod.compute_ate(result.timestamps, result.t_smoothed, gt[:, 0], gt[:, 1:4])
            print(f"[live] segment {seg_id}: ATE RMSE {a.rmse:.4f} m ({a.num_pairs} pairs)")
        return result

    state, dstate, outs_list = fresh()
    seg_id = 0
    results = []
    inrun = 0
    t_start = time.perf_counter()
    restart_at = args.restart_at
    k0 = 0
    while k0 < n:
        k1 = min(k0 + chunk, n)
        if restart_at and k0 < restart_at < k1:
            k1 = restart_at  # cut the chunk at the restart boundary
        feats = fe.extract_sequence(
            front, grays[k0:k1], depths[k0:k1], stamps[k0:k1],
            stationary=None if stationary is None else stationary[k0:k1],
            frame_indices=np.asarray(idxs[k0:k1]),
        )
        n_loops0 = int(state.loops.valid.sum())
        res_c = pipeline.run_tracking(feats, cfg, state=state, smooth=False, device=dev)
        state = res_c.final_state
        if cfg.opt.inrun_pgo and int(state.loops.valid.sum()) > n_loops0:
            state = pipeline.inrun_pgo_correct(state, cfg)
            inrun += 1
            print("[live]   in-run PGO correction applied")
        outs_list.append(res_c.outputs)
        dstate = gridhash.fuse_sequence(
            dstate, torch.from_numpy(depths[k0:k1]).to(dev),
            torch.from_numpy(np.stack(rgbs[k0:k1])).to(dev),
            torch.from_numpy(res_c.R).to(dev), torch.from_numpy(res_c.t).to(dev),
            cam.fx, cam.fy, cam.cx, cam.cy,
            pixel_step=cfg.dense.pixel_step, max_depth=cfg.dense.max_depth,
            voxel_size=cfg.dense.voxel_size, chunk=min(chunk, k1 - k0),
        )
        # Live viewer rewrite: the whole segment so far, smoothed.
        webviz.export_run(
            smoothed(state, outs_list), viewer_path, dense=_dense_host(dstate),
            gt_trajectory=None if seq_meta.gt is None else seq_meta.gt[:, 1:4],
            title=f"vslam_tpu_torch LIVE — segment {seg_id}, frame {k1}/{n}",
        )
        elapsed = time.perf_counter() - t_start
        print(f"[live] frames {k0}-{k1 - 1}: kf={int(state.kf_count)} "
              f"loops={int(state.loops.valid.sum())} "
              f"dense={int(dstate.cloud_count)} ({k1 / elapsed:.1f} fps cum) -> viewer updated")
        if restart_at and k1 == restart_at:
            results.append(finalize(state, outs_list, seg_id))
            print(f"[live] RESTART at processed frame {k1}: fresh state "
                  f"(src/main.cpp:1512-1556 semantics)")
            state, dstate, outs_list = fresh()
            seg_id += 1
        k0 = k1

    results.append(finalize(state, outs_list, seg_id))
    summary = {
        "mode": "live",
        "frames": n,
        "segments": seg_id + 1,
        "keyframes": int(state.keyframes.valid.sum()),
        "dense_points": int(dstate.cloud_count),
        "viewer": viewer_path,
    }
    print("[summary] " + json.dumps(summary))
    print(f"[done] outputs in {args.out}/")
    summary["inrun_pgo"] = inrun
    return summary, results


def render_frames(args, cfg, result, frames, grays, dense):
    """`--render` (`examples/run_tum.py:276-317`): scene frames of the run
    every len/20 frames (`viz.viewer.render_run`), then per rendered frame
    the HUD of raw ratio-test matches (yellow) against the
    fundamental-gated ones (green) with the frame before, and the frame
    annotated with its keypoints (`annot_*.png`: the JAX app writes it over
    the scene frame of the same index). Returns (scene paths, HUD frame
    count)."""
    import cv2

    from vslam_tpu_torch.ops import matching as match_ops, prng, ransac as rs_ops
    from vslam_tpu_torch.viz import hud, viewer

    n = len(grays)
    every = max(n // 20, 1)
    viz_dir = os.path.join(args.out, "viz")
    paths = viewer.render_run(result, viz_dir, every=every, dense=dense)
    xy, dv, ds = frames.xy.cpu(), frames.valid.cpu(), frames.desc.float().cpu()
    n_hud = 0
    for i in range(every, n, every):
        m = match_ops.knn2_ratio_match(ds[i - 1], ds[i], dv[i - 1], dv[i],
                                       ratio=cfg.frontend.l2_ratio_threshold)
        uv2 = xy[i][m.idx.long()]
        _, fres = rs_ops.ransac_fundamental(
            prng.prng_key(i), xy[i - 1], uv2, m.valid,
            num_hypotheses=cfg.motion.fm_ransac_iters,
            threshold_px=cfg.motion.fm_ransac_threshold_px)
        gated = (m.valid & fres.inlier_mask).numpy()
        img = hud.before_after(grays[i - 1], grays[i], xy[i - 1].numpy(), xy[i].numpy(),
                               m.idx.numpy(), m.valid.numpy(), gated)
        cv2.imwrite(os.path.join(viz_dir, f"hud_{i:05d}.png"), img[..., ::-1])
        ann = hud.annotate_frame(grays[i], xy[i].numpy(), dv[i].numpy())
        cv2.imwrite(os.path.join(viz_dir, f"annot_{i:05d}.png"), ann[..., ::-1])
        n_hud += 1
    print(f"[viz] {len(paths)} scene frames + {n_hud} HUD frames -> {viz_dir}")
    return paths, n_hud


def run_poisson(ply_path, out_dir, device="cuda"):
    """Poisson meshing of a dense PLY (`src/main.cpp:1406-1458` shells out
    to PoissonRecon + SurfaceTrimmer). With the external binaries on PATH
    they are used; otherwise the native solver (`ops.poisson`: FFT Poisson
    solve, marching tetrahedra, density trim) on `device` writes the same
    two files (poisson_mesh.ply, poisson_trimmed.ply). Returns what ran:
    {"branch": "external" | "native" | "skipped", counts, seconds}."""
    from vslam_tpu_torch.io import ply
    from vslam_tpu_torch.ops import pointcloud as pc
    from vslam_tpu_torch.ops import poisson as native_poisson

    exe = shutil.which("PoissonRecon")
    mesh = os.path.join(out_dir, "poisson_mesh.ply")
    if exe is not None:
        subprocess.run([exe, "--in", ply_path, "--out", mesh, "--depth", "9"], check=False)
        trim = shutil.which("SurfaceTrimmer")
        if trim and os.path.exists(mesh):
            subprocess.run([trim, "--in", mesh, "--out",
                            os.path.join(out_dir, "poisson_trimmed.ply"), "--trim", "7"],
                           check=False)
        return {"branch": "external"}

    print("[poisson] PoissonRecon binary not found; using native solver")
    t0 = time.perf_counter()
    pts = ply.load_ply(ply_path)["points"]
    if len(pts) < 32:
        print("[poisson] too few points; skipping")
        return {"branch": "skipped"}
    if len(pts) > 200_000:  # brute-force kNN normals: cap the input cloud
        sel = np.random.default_rng(0).choice(len(pts), 200_000, replace=False)
        pts = pts[sel]
    dev = torch.device(device)
    pt = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(dev)
    normals = pc.estimate_normals(
        pt, torch.ones(len(pts), dtype=torch.bool, device=dev), k=min(16, len(pts) - 1),
        viewpoint=torch.from_numpy(pts.mean(0).astype(np.float32)).to(dev)).cpu().numpy()
    verts_u, faces_u = native_poisson.poisson_mesh(pts, normals, resolution=128, trim_frac=0.0,
                                                   device=dev)
    ply.save_ply(mesh, verts_u, faces=faces_u)
    verts_t, faces_t = native_poisson.poisson_mesh(pts, normals, resolution=128,
                                                   trim_frac=0.08, device=dev)
    ply.save_ply(os.path.join(out_dir, "poisson_trimmed.ply"), verts_t, faces=faces_t)
    seconds = time.perf_counter() - t0
    print(f"[poisson] native mesh: {len(verts_u)} verts / {len(faces_u)} faces; "
          f"trimmed: {len(verts_t)} verts / {len(faces_t)} faces")
    return {"branch": "native", "points": int(len(pts)), "verts": int(len(verts_u)),
            "faces": int(len(faces_u)), "trimmed_verts": int(len(verts_t)),
            "trimmed_faces": int(len(faces_t)), "seconds": seconds}


if __name__ == "__main__":
    main()
