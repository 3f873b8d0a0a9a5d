#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`vslam_tpu_torch`) on one GPU.

    python3 chip_smoke.py              # all phases (what a checkout is held to)
    python3 chip_smoke.py --profile    # + where the main path's time goes
    python3 chip_smoke.py --long       # + the loop path on the long stress world

Phases, each failing the run on any error:
  1. build   — compile `vslam_tpu_torch/csrc/matching.cu` with nvcc
               (sm_90a) into `vslam_tpu_torch/_build/`.
  2. kernels — hold each CUDA kernel against its plain PyTorch version on
               the card at the shapes its path gives it (K=400 keypoints,
               M=16384 map rows, D=256 bf16; B=4 members for the batched
               radius match), plus ties, all-invalid, M=16383 and dense
               cases (every pair inside the pixel radius; `dense_tail`:
               the best pairs in the partial last keypoint chunk and row
               tile, K=400 and K=96); the batched
               radius match also against B launches of the single one and
               against its per-member-pointer form; top-2 also with one
               valid row, valid rows only in the lowest 5,000 slots or the
               partial last tile, M=17, an empty map, Kq=1 and Kq=96; time
               kernel, plain version and the bf16 matmul alone as a
               yardstick. Each kernel's bound is the input's own floor
               (`radius_work`, `top2_work`: gated pairs, valid rows).
  3. main    — render 128 frames of the seed-0 synthetic room with the
               port's own renderer, run `run_coupled` with the default
               `SlamConfig`, the committed SuperPoint checkpoint and the
               default dense map (warm-up; a run under PyTorch's CUDA sync
               debug mode that counts every operation that makes the host
               wait for the card; then the timed run), check pose
               finiteness, raw ATE, tracked fraction, keyframe count and
               radius-kernel launches, and hold the fused dense map against
               the port's fusion replayed on the CPU from the same poses;
               then the radius kernel on the path's own input (the final
               map at the final pose, the last frame's keypoints): held
               against its plain version and timed (`path_ms`).
  4. multi   — `run_coupled_batched` at B=4 over the worlds of seeds 0-3
               (128 frames each, chunks of 32 per member, one dense map
               each): one chunk under the sync debug mode, then the timed
               run; per-member ATE, tracked fraction, keyframes and cloud
               size; the batched radius kernel once per tracked frame and
               the single one never; member 0 against the main phase;
               then the batched radius kernel on the four final members'
               own input, as the main phase does for the single one.
  5. recovery — call the tracking-loss recovery on the main phase's final
               state; the top-2 kernel must launch once and agree with its
               plain version; then the top-2 kernel on the recovery's own
               input (the final map against the last frame): held against
               its plain version and timed (`path_ms`), with the map's
               valid rows and live 64-row tiles.
  6. outputs — on the main phase's result: RPE; `beautify_cloud` of the
               final sparse map on the card against the CPU (masks,
               count, points, normals), timed; `fuse_sequence` at the
               smoothed poses against a chunk-by-chunk CPU replay; a PLY
               and a TUM trajectory written and read back; a checkpoint
               after chunk 2, loaded and tracked through chunks 3-4,
               equal to the main run to the last digit.
  7. side    — the JAX bench's side worlds (`SIDE_WORLDS`), each through
               `run_coupled` once at the default SlamConfig, 128 frames in
               chunks of 32, the launch counts set to 0 just before and
               read just after: mono (the seed-0 world with all-zero
               depth: the essential-matrix chain), mono_depth (the same
               with `rgbd=False` and the committed DepthNet filling
               keypoint depth; before it, DepthNet on one chunk of 32
               frames on the card against the CPU, and timed), noise
               (`apply_sensor_noise` on the seed-0 world) and holdout (the
               held-out v2 worlds of seeds 40 and 41). Each: ATE (sim(3)
               for the mono worlds) within twice JAX's CPU run (at least
               0.02 m with depth), tracked fraction, the radius kernel
               once per tracked frame, top-2 once per recovery attempt.
  8. loop    — the coupled path through a loop closure: the JAX bench's
               stress world s101_l1 (896 frames, 6000 landmarks, a
               stationary pause, a texture dropout, one revolution),
               rendered by the port, stationarity and gravity from its
               accelerometer, `run_coupled` once in chunks of 128 (no
               warm-up, host syncs counted), RTS and `run_backend`; checks
               the loop constraints (>= 1), raw / smoothed / after-backend
               ATE against limits from JAX's CPU run, tracked fraction,
               keyframes, radius launches = tracked frames and top-2
               launches = the recovery attempts the outputs show. The fold
               check: the final ring drifted and folded by
               `inrun_pgo_correct` on the card and on the CPU, with equal
               decisions and rings within FOLD_ATOL. Then the radius and
               top-2 kernels on this path's own final input. With --long,
               the same on s202_l2.5 (2,560 frames; its ATE is recorded,
               not held: JAX's CPU figures for it are not taken).
  9. app     — the TUM application (`vslam_tpu_torch.apps.run_tum.main`)
               on the seed-0 room world (96 frames, 640x480) written as a
               TUM directory with its synthetic feature cache
               (`write_tum_sequence`, in a temporary directory), each run
               with the launch counts set to 0 just before and read just
               after: SuperPoint RGB-D writing `sp.npz`, with `--poisson`;
               that run replayed from `sp.npz`, from the same features as
               SPCF `.bin` (trajectories equal to the last digit) and at
               `--frame-step 2` (cache rows selected by frame id); the
               synthetic cache with `--ba`; `--orb` (after `OrbFrontend`
               on the card against the CPU over 8 frames); `--mono --midas`
               (DepthNet: no MiDaS checkpoint); `--live --restart-at 48`
               (two segments). Each: ATE (raw and sim(3); sim(3) for mono
               and per live segment) within twice the JAX app's CPU run
               (`APP_JAX`, at least 0.02 m with depth), tracked fraction,
               the radius kernel once per tracked frame, top-2 once per
               recovery attempt, every file written and read back. Then
               the Poisson mesh of the first run's dense cloud on the card
               against the CPU's (`mesh_failures`) and MiDaS (random-init,
               f32) on 8 frames on the card against the CPU, each timed.
               A replay of the first run with `--render` writes its PNG
               frames, read back: ceil(N / every) scene frames, each lit
               and showing the sparse map (`render_failures`).
 10. train   — the training path (`models.train_superpoint`,
               `models.train_depthnet`): one SuperPoint step (batch 4 at
               120x160, random init, a fixed key) on the card against the
               CPU (`step_failures`: losses and the share of parameters
               updated apart); `train_textured` from random init at the
               recipe's widths (`TRAIN_SP`: 200 steps, batch 16, 128
               images, a quarter synthetic shapes), its render time apart
               from its training time, steps per second and model TFLOP/s
               (a step = 3 x forward x 2 views x batch) against the bf16
               peak, the loss falling from the first scan to the last;
               `evaluate_detector` on the committed checkpoint (8 pairs)
               within `EVAL_SP_ATOL` of JAX's CPU figures; the committed
               npz written by `save_superpoint_npz` and read back equal, as
               is the network just trained, then `run_coupled` over the
               main world's first 32 frames with the round-tripped file:
               its trajectory equal to the committed file's run to the last
               digit, radius launches = tracked frames; DepthNet: one step
               card against CPU (batch 2 at 240x320), `train` (`TRAIN_DN`:
               100 steps, batch 8, 32 images) with its loss falling and its
               rate, `evaluate` on the committed checkpoint within
               `EVAL_DN_ATOL` of JAX's CPU figures.
 11. mesh    — multi-sequence runs across devices (`parallel.mesh`; one
               worker process per card, NCCL): `make_mesh(1)` (more cards
               than there are raises); `sharded_tracking_scan` over the
               main world's first 64 frames of features equal to the
               parent's `run_frames` to the last digit, and
               `sharded_coupled_run` over those frames (chunks of 32) equal
               to the parent's `run_coupled` (state, dense map, outputs),
               each worker's radius launches = its tracked frames;
               `batched_diagnostics` through the all-reduce equal to the
               host's; `vmapped_tracking_scan` and `batched_tracking_scan`
               at B = 2 over 32 frames equal to each member's solo run
               (single radius kernel once per tracked frame, batched once
               per tracked step); `apps.run_batch` on the app phase's room
               directory (`RUN_BATCH_ARGS`: ATE within twice JAX's CPU
               figure `RUN_BATCH_JAX`, at least 0.02 m) and with no dataset
               (the synthetic fill), frames/s; the prefetching
               `NativeSequenceLoader` against the cv2 reader over the 96
               frames (equal arrays, each one's frames/s);
               `apps.bench_batched_step` (`BENCH_ARGS`): microseconds and
               device activities per iteration of each component; and
               `ops.device.fma` / `fms` bitwise against their f64
               emulation, and `ops.libm` and the minimal solves
               (`svd3x3`, Kabsch, eight-point, DLT, Cholesky) bitwise
               against the CPU's.

Prints the card's name and power limit, one JSON line of per-kernel
results, one JSON line each of main-path, multi-path, side-phase,
outputs, loop-path, app, train and mesh results (and the batched-step
split), each phase's seconds, and as the last line {"ok": true, "device": {...}}. Exits non-zero (printing no
result line) without a CUDA device or outside a checkout of the
repository.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import subprocess
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
N_FRAMES, CHUNK = 128, 32  # the main path: 128 frames in chunks of 32
# The multi path: B sequences, chunks of C frames per member, as the JAX
# bench lays out its multi-sequence run (C = max(128 // B, 8)).
MULTI_B = 4
MULTI_CHUNK = max(128 // MULTI_B, 8)
# Raw ATE limit of each multi-path member (by world seed): 0.02 m, the
# main path's, or twice the JAX package's own CPU run of that world where
# that is above 0.01 m. The JAX runs (tests/test_torch_coupled.py::
# test_coupled_batched_full_size_vs_jax prints them): seed 0 0.010213 m,
# 1 0.006190 m, 2 0.017999 m, 3 0.006378 m.
MULTI_ATE_LIMIT = {0: 0.02, 1: 0.02, 2: 0.036, 3: 0.02}
# The loop path: the JAX bench's stress worlds (`bench.py:314-318`), in
# chunks of 128 frames as the bench runs them. `s101_l1` (896 frames, one
# loop) runs by default, `s202_l2.5` (2,560 frames) with --long.
STRESS = {
    "s101_l1": dict(frames=896, kw=dict(seed=101, loops=1.0)),
    "s202_l2.5": dict(frames=2560, kw=dict(seed=202, loops=2.5, pause=(0.3, 0.02),
                                           dropout=(0.6, 0.01))),
}
STRESS_CHUNK = 128
# The JAX package's own CPU run of s101_l1 (frontend in batches of 8
# frames, then the tracking scan in chunks of 128 with the in-run
# correction, RTS and `run_backend`; tests/test_torch_coupled.py::
# test_coupled_stress_loop_vs_jax prints these). Each ATE's limit is twice
# JAX's value or 0.02 m, whichever is larger (`stress_ate_limits`).
JAX_STRESS = dict(ate_raw_m=0.046093, ate_smoothed_m=0.048324, ate_backend_m=0.044567,
                  keyframes=84, loop_constraints=1, backend_rejected=False)
# Keyframes within 15% of JAX's count, and at least 0.95 of the frames
# after the first tracked (JAX: 0.9877).
STRESS_KF_REL, STRESS_MIN_TRACKED = 0.15, 0.95
# The fold check: the card's and the CPU's folds of one drifted state
# take the same decisions, and their rings agree within this (m, rad).
FOLD_ATOL = 1e-3

# The side worlds (the JAX bench's mono, mono_depth, noise and holdout
# stages, `bench.py:679-862`), 128 frames each in chunks of 32 at the
# default SlamConfig: world seed, renderer family, sensor noise
# (`apply_sensor_noise(seed=0)`), all-zero depth, the committed DepthNet
# filling keypoint depth (with `rgbd=False`, as the bench runs it), and
# sim(3) ATE (monocular trajectories are defined up to scale).
SIDE_WORLDS = {
    "mono": dict(seed=0, family="v1", noise=False, zero_depth=True, depthnet=False, sim3=True),
    "mono_depth": dict(seed=0, family="v1", noise=False, zero_depth=True, depthnet=True,
                       sim3=True),
    "noise": dict(seed=0, family="v1", noise=True, zero_depth=False, depthnet=False, sim3=False),
    "holdout_s40": dict(seed=40, family="v2", noise=False, zero_depth=False, depthnet=False,
                        sim3=False),
    "holdout_s41": dict(seed=41, family="v2", noise=False, zero_depth=False, depthnet=False,
                        sim3=False),
}
# The JAX package's own CPU run of each side world (ATE of the raw
# trajectory, sim(3) for the mono worlds; tests/test_torch_coupled.py::
# test_side_worlds_full_size_vs_jax prints these). Limits: `side_ate_limit`
# and `side_tracked_floor`.
SIDE_JAX = {
    "mono": dict(ate_m=0.104643, tracked_frac=0.9606),
    "mono_depth": dict(ate_m=0.023577, tracked_frac=0.9606),
    "noise": dict(ate_m=0.011518, tracked_frac=1.0),
    "holdout_s40": dict(ate_m=0.01286, tracked_frac=1.0),
    "holdout_s41": dict(ate_m=0.018947, tracked_frac=1.0),
}
# DepthNet's log depth on the card against the CPU, and the depth it
# fills in (relative). In f32 (TF32 off) the two differ only by the
# convolutions' order of accumulation: DN_F32_ATOL. In bf16, as the path
# runs it, an order difference can also flip an activation's rounding by
# one bf16 step, which carries to the output (the CPU test against JAX's
# Flax module reads up to 1.7e-3 on two frames, the card against the CPU
# 3.3e-3 on 32): DN_LOG_ATOL.
DN_F32_ATOL = 1e-4
DN_LOG_ATOL = 1e-2
# beautify_cloud on the card against the CPU: points and normals. The
# neighbours are the same bits on both (`ops.pointcloud`); the covariance
# product and the eigensolver's acos/cos round otherwise, and a
# near-degenerate neighbourhood amplifies that in its eigenvector
# (normals 7.9e-5 apart on the main run's final map on an H100).
OUT_ATOL = 1e-4
# fuse_sequence's chunk in the outputs phase: 128 frames = 48 + 48 + 32,
# so the last chunk is padded with 16 zero-depth frames.
FUSE_CHUNK = 48

H100_BF16_FLOPS = 989e12  # dense tensor-core bf16, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
# No single PyTorch call computes either matcher, so `library_ms` is null;
# the bf16 distance product alone is timed beside each kernel as a
# yardstick (`matmul_ms`). The port never calls it.
MATMUL_CALL = "torch.matmul bf16 (M,D)x(D,K) alone"
BMM_CALL = "torch.bmm bf16 (B,M,D)x(B,D,K) alone"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(nbytes: int, flops: int):
    tb = nbytes / H100_BYTES_PER_S
    tf = flops / H100_BF16_FLOPS
    return max(tb, tf) * 1e3, ("operations" if tf >= tb else "bytes")


def time_ms(fn, reps: int = 25) -> float:
    """Median device time (ms) of one call over `reps`, after two warm-up
    calls: CUDA events around the call, with the card held busy
    (`torch.cuda._sleep`, four times the host time of a call) while the
    host enqueues it, so the events bracket the call's device work and not
    the host's launch cost."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    cycles = int(min(max(4 * (time.perf_counter() - t0), 2e-4), 0.5) * 2e9)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[reps // 2]


# --------------------------------------------------------------------------
# Kernel phase
# --------------------------------------------------------------------------


def _quantized_desc(rng, n, D):
    """Descriptors on a 1/256 grid (|entries| <= 66/256): bf16-exact, and
    every dot product of two of them is exact in f32 whatever the order of
    summation, so the kernel and the plain version see identical
    distances and must agree exactly, ties included."""
    import numpy as np

    return np.clip(np.round(rng.normal(0.0, 16.0, (n, D))), -64, 64) / 256.0


def _radius_inputs(rng, K, M, D, case):
    import numpy as np
    import torch

    q = _quantized_desc(rng, K, D)
    db = _quantized_desc(rng, M, D)
    uv_db = np.round(rng.uniform(0, 640, (M, 2)) * 2) / 2  # half-pixel grid
    uv_q = np.round(rng.uniform(0, 640, (K, 2)) * 2) / 2
    near = K // 2
    # Half the queries sit near map projections with near-copy descriptors:
    # random rows, or (dense_tail) the last rows, where the map's partial
    # 64-row tile lies.
    rows = M - 1 - np.arange(near) if case == "dense_tail" else rng.choice(M, near, replace=False)
    db[rows] =np.clip(q[:near] + rng.integers(-1, 2, (near, D)) / 256.0, -66 / 256, 66 / 256)
    uv_q[:near] = uv_db[rows] + np.round(rng.normal(0, 4, (near, 2)) * 2) / 2
    vq = rng.random(K) > 0.1
    vdb = rng.random(M) > 0.15
    if case == "ties":
        # Duplicate map rows (same descriptor and projection) claim the same
        # keypoint at the same distance: the lowest row must win. Duplicate
        # keypoints give equal row distances: the lowest keypoint must win.
        src = rows[: near // 4]
        dst = (src + 1) % M
        db[dst], uv_db[dst], vdb[dst], vdb[src] = db[src], uv_db[src], True, True
        q[near: near + 20] = q[:20]
        uv_q[near: near + 20] = uv_q[:20]
    if case == "all_invalid":
        vdb[:] = False
    if case == "all_valid":
        vq[:] = True
        vdb[:] = True
    if case in ("dense", "dense_tail"):
        # Every row and keypoint within 5.85 px of one centre (a disc of
        # 11.7 px across, half-pixel grid), all valid: every pair is inside
        # the 12 px radius — the most work the gate can let through.
        def disc(n):
            r, a = 5.5 * np.sqrt(rng.random(n)), rng.uniform(0, 2 * np.pi, n)
            return np.round(np.stack([320 + r * np.cos(a), 240 + r * np.sin(a)], -1) * 2) / 2
        uv_db, uv_q = disc(M), disc(K)
        vq[:] = True
        vdb[:] = True
    if case == "dense_tail":
        # The near-copy keypoints last: the best pairs lie in the last
        # (partial) 64-keypoint chunk and in the last rows.
        q, uv_q = q[::-1].copy(), uv_q[::-1].copy()
    dev = "cuda"
    return (
        torch.tensor(q, dtype=torch.bfloat16, device=dev),
        torch.tensor(uv_q, dtype=torch.float32, device=dev),
        torch.tensor(vq, device=dev),
        torch.tensor(db, dtype=torch.bfloat16, device=dev),
        torch.tensor(uv_db, dtype=torch.float32, device=dev),
        torch.tensor(vdb, device=dev),
    )


def _dense_radius_bytes(K, M, D):
    """Bytes a radius match that scores every (row, keypoint) pair moves:
    each input read once (bf16 descriptors, f32 pixels, bool masks), each
    output written once. The bound of a design that scores every pair."""
    return (K * D * 2 + K * 8 + K + M * D * 2 + M * 8 + M) + (K * 4 + K + K * 4 + M * 4)


def _host(x):
    """A numpy array of a tensor (copied from the card) or of an array."""
    import numpy as np

    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def radius_work(uv_q, valid_q, uv_db, valid_db, D, radius_px):
    """The least work of a radius match on these inputs (leading member
    dimension optional; numpy arrays or tensors). The outputs depend only
    on the (row, keypoint) pairs that pass the gates — row valid, keypoint
    valid, squared pixel distance <= radius^2, computed as the kernel does
    (f32 subtraction, each step rounded) — so the floor is:
      bytes: every row's and keypoint's pixels (8 B) and validity (1 B),
             the descriptors (2 D B) of the rows and of the keypoints that
             have a candidate pair, every output written once (mp_idx,
             kp_ok, dist per keypoint: 9 B; min_pix_d2 per row: 4 B);
      flops: 2 D per candidate pair (one dot product).
    Returns dict(nbytes, flops, rows_with_candidates,
    keypoints_with_candidates, pairs_in_radius), summed over members."""
    import numpy as np

    uq, vq, ud, vd = (_host(x) for x in (uv_q, valid_q, uv_db, valid_db))
    if uq.ndim == 2:
        uq, vq, ud, vd = uq[None], vq[None], ud[None], vd[None]
    r2 = np.float32(radius_px) * np.float32(radius_px)
    nbytes = flops = rows = kps = pairs = 0
    for b in range(uq.shape[0]):
        q, d = uq[b].astype(np.float32), ud[b].astype(np.float32)
        K, M = q.shape[0], d.shape[0]
        with np.errstate(invalid="ignore", over="ignore"):
            dx = d[:, None, 0] - q[None, :, 0]
            dy = d[:, None, 1] - q[None, :, 1]
            pd2 = dx * dx + dy * dy  # float32, rounded per operation
            cand = (pd2 <= r2) & vd[b].astype(bool)[:, None] & vq[b].astype(bool)[None, :]
        n_rows, n_kps = int(cand.any(1).sum()), int(cand.any(0).sum())
        rows, kps, pairs = rows + n_rows, kps + n_kps, pairs + int(cand.sum())
        nbytes += 9 * (M + K) + 2 * D * (n_rows + n_kps) + 9 * K + 4 * M
        flops += 2 * D * int(cand.sum())
    return dict(nbytes=nbytes, flops=flops, rows_with_candidates=rows,
                keypoints_with_candidates=kps, pairs_in_radius=pairs)


def _radius_mismatches(got, ref):
    """Kernel vs plain radius match (any leading dims): indices and flags
    equal, distances of matched keypoints within 1e-4 (one mismatch if
    not), min_pix_d2 within 0.5 px^2 (the plain |a|^2+|b|^2-2ab identity's
    rounding at |uv| ~ 640). Returns (mismatches, max distance error,
    matched keypoints)."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    g = [x.cpu().numpy() for x in got]
    r = [x.cpu().numpy() for x in ref]
    n_bad = int((g[0] != r[0]).sum() + (g[1] != r[1]).sum())
    ok = r[1]
    derr = float(np.abs(g[2][ok] - r[2][ok]).max()) if ok.any() else 0.0
    perr = np.abs(np.minimum(g[3], 1e9) - np.minimum(r[3], 1e9))
    n_bad += int((perr > 0.5 + 1e-4 * np.abs(r[3])).sum())
    if derr > 1e-4:
        n_bad += 1
    return n_bad, derr, int(ok.sum())


def live_tiles(valid_db, rows: int = 64) -> int:
    """Map tiles of `rows` rows (the last one partial) holding a valid row:
    the tiles the top-2 kernel loads and multiplies."""
    import numpy as np

    v = _host(valid_db).astype(bool)
    return int(np.add.reduceat(v, np.arange(0, v.size, rows)).astype(bool).sum()) if v.size else 0


def top2_work(valid_db, K, D):
    """The least work of a top-2 match on this map (numpy array or tensor):
    an invalid row never changes the result, so the floor reads every
    row's validity (1 B), the valid rows' and the queries' descriptors (2 D
    B each) and writes d1, d2, idx (12 B per query); it does 2 D
    operations per (valid row, query) pair. Returns (nbytes, flops)."""
    v = _host(valid_db).astype(bool)
    n = int(v.sum())
    return v.size + 2 * D * (n + K) + 12 * K, 2 * D * n * K


def _top2_mismatches(got, db, vdb, q, atol=0.0):
    """Kernel vs plain top-2 (`top2_match_plain`): d1 and d2 within `atol`
    and idx equal, idx -1 in place of the plain version's 0 where no row is
    valid (an empty map: 1e9, 1e9, -1). `atol` 0 on quantised inputs (every
    dot exact in f32 in any order); on real descriptors the two sum the
    bf16 products in other orders, so idx is compared only where the plain
    d2 - d1 exceeds 2 atol (no near-tie that the rounding may flip).
    Returns (mismatches, max distance error)."""
    import numpy as np

    from vslam_tpu_torch.ops import matching

    if db.shape[0]:
        ref = [x.cpu().numpy() for x in matching.top2_match_plain(db, vdb, q)]
    else:  # the plain version's reductions refuse an empty axis
        ref = [np.full(q.shape[0], 1e9, np.float32)] * 2 + [np.zeros(q.shape[0], np.int32)]
    g = [x.cpu().numpy() for x in got]
    ref[2] = np.where(ref[0] < 0.5e9, ref[2], -1)
    e1, e2 = np.abs(g[0] - ref[0]), np.abs(g[1] - ref[1])
    # idx on every query at atol 0 (ties go to the lowest row) and on every
    # query with no valid row (-1); else only where no near-tie can flip.
    clear = (ref[1] - ref[0] > 2 * atol) | (atol == 0) | (ref[0] >= 0.5e9)
    n_bad = int((e1 > atol).sum() + (e2 > atol).sum() + (g[2] != ref[2])[clear].sum())
    return n_bad, float(max(e1.max(), e2.max())) if e1.size else 0.0


def stress_ate_limits(jax_figures=JAX_STRESS):
    """Each ATE's limit on the loop path: twice the JAX package's CPU
    value, or 0.02 m (the main path's limit), whichever is larger."""
    return {k: max(2.0 * jax_figures[k], 0.02)
            for k in ("ate_raw_m", "ate_smoothed_m", "ate_backend_m")}


def side_ate_limit(jax_ate_m: float, rgbd: bool) -> float:
    """The ATE limit of a side phase: twice the JAX package's CPU run of
    the same world, and at least 0.02 m where the world has depth."""
    return max(2.0 * jax_ate_m, 0.02) if rgbd else 2.0 * jax_ate_m


def side_tracked_floor(jax_tracked_frac: float) -> float:
    """The tracked-fraction floor of a side phase: JAX's less 0.05."""
    return jax_tracked_frac - 0.05


def recovery_attempts(num_matches, recovered, min_matches: int, cooldown_frames: int) -> int:
    """The recovery attempts a run's outputs show: a tracked frame (every
    frame after the first) with fewer than `min_matches` matches whose
    cooldown has run out (`tracking._recover_due`; a recovery restarts the
    cooldown at `cooldown_frames`, else it counts down). Each attempt
    launches the top-2 kernel once. Assumes the map holds enough points
    for PnP, as it does past the first keyframes."""
    import numpy as np

    nm, rec = np.asarray(num_matches), np.asarray(recovered)
    cooldown, attempts = 0, 0
    for i in range(1, nm.shape[0]):
        attempts += int(nm[i] < min_matches and cooldown <= 0)
        cooldown = cooldown_frames if rec[i] else max(cooldown - 1, 0)
    return attempts


def loop_failures(res, jax_figures=JAX_STRESS):
    """The loop path's checks on its result dict; returns the failed ones
    (empty when the run passes). With `jax_figures` None (a world whose
    JAX CPU run is not taken) only the checks that need no reference run:
    a loop constraint and the launch equalities."""
    out = []
    if res["loop_constraints"] < 1:
        out.append(f"no loop constraint accepted ({res['loop_constraints']})")
    if res["radius_launches"] != res["track_frames"]:
        out.append(f"radius kernel launched {res['radius_launches']} times for "
                   f"{res['track_frames']} tracked frames")
    if res["top2_launches"] != res["recovery_attempts"]:
        out.append(f"top-2 kernel launched {res['top2_launches']} times for "
                   f"{res['recovery_attempts']} recovery attempts")
    if jax_figures is None:
        return out
    for k, lim in stress_ate_limits(jax_figures).items():
        if not res[k] <= lim:
            out.append(f"{k} {res[k]:.4f} m > {lim:.4f} m")
    if res["tracked_frac"] < STRESS_MIN_TRACKED:
        out.append(f"tracked fraction {res['tracked_frac']:.3f} < {STRESS_MIN_TRACKED}")
    lo = jax_figures["keyframes"] * (1 - STRESS_KF_REL)
    hi = jax_figures["keyframes"] * (1 + STRESS_KF_REL)
    if not lo <= res["keyframes"] <= hi:
        out.append(f"{res['keyframes']} keyframes, outside {lo:.1f}-{hi:.1f}")
    if jax_figures["backend_rejected"] and not res["backend_identity"]:
        out.append("the backend moved the trajectory where JAX's rejected its pass")
    return out


def drift_ring(st_np, n_frames: int):
    """The drifted ring of tests/test_pipeline.py::
    test_inrun_pgo_correct_floor_and_fold on a numpy state: keyframe
    positions pushed by up to 0.5 m along a fixed direction, growing with
    frame id, the live position moved with the newest keyframe, so that
    the loop edges are violated and the in-run fold fires."""
    import numpy as np

    kfs = st_np.keyframes
    ddir = np.asarray([0.6, -0.2, 0.3], np.float32)
    ddir /= np.linalg.norm(ddir)
    drift = (0.5 * np.clip(kfs.frame_id / (n_frames - 1), 0.0, 1.0)[:, None]
             * ddir[None, :]).astype(np.float32)
    newest = int(np.argmax(np.where(kfs.valid, kfs.frame_id, -1)))
    return st_np._replace(keyframes=kfs._replace(t=kfs.t + drift), t=st_np.t + drift[newest])


def compare_folds(before, card, cpu, solves_card: int, solves_cpu: int, atol=FOLD_ATOL):
    """The card's and the CPU's `inrun_pgo_correct` of one state (numpy
    trees): the significance decision (solves) and the fold decision
    (counter step) equal, each counter up by one at most, and the folded
    ring, map points and live pose within `atol`. Returns a dict with
    `fold_mismatches` (0 when they agree)."""
    import numpy as np

    step_card = int(card.inrun_corrections) - int(before.inrun_corrections)
    step_cpu = int(cpu.inrun_corrections) - int(before.inrun_corrections)
    errs = {name: float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
            for name, a, b in (("kf_t", card.keyframes.t, cpu.keyframes.t),
                               ("kf_R", card.keyframes.R, cpu.keyframes.R),
                               ("map_pos", card.map.pos, cpu.map.pos),
                               ("t", card.t, cpu.t), ("R", card.R, cpu.R))}
    bad = int(solves_card != solves_cpu) + int(step_card != step_cpu)
    bad += int(step_card not in (0, 1)) + sum(int(not e <= atol) for e in errs.values())
    moved = float(np.abs(np.asarray(card.keyframes.t) - np.asarray(before.keyframes.t)).max())
    return dict(fold_solves_card=solves_card, fold_solves_cpu=solves_cpu,
                fold_step_card=step_card, fold_step_cpu=step_cpu, fold_ring_moved_m=moved,
                fold_max_err=errs, fold_atol=atol, fold_mismatches=bad)


def check_kernels(config):
    """Holds every kernel against its plain version; returns the
    per-kernel result dicts (launch counts are filled in later)."""
    import numpy as np
    import torch

    from vslam_tpu_torch.ops import cuda_matching, matching
    from vslam_tpu_torch.ops.linalg import f32_matmuls

    K = config.frontend.max_keypoints
    D = config.frontend.descriptor_dim
    M = config.map.map_capacity
    radius = config.map.track_search_radius_px
    thresh = config.map.track_desc_threshold
    rng = np.random.default_rng(0)
    results = {}

    # ---- radius match ----
    def radius_fields(work):
        """The floor of one timed input (`radius_work`) as result fields."""
        b_ms, b_by = bound(work["nbytes"], work["flops"])
        return dict(bound_ms=b_ms, bound_by=b_by,
                    rows_with_candidates=work["rows_with_candidates"],
                    pairs_in_radius=work["pairs_in_radius"])

    mism, err = 0, 0.0
    timed = {}
    with f32_matmuls():
        # dense_tail puts the best pairs in the last, partial 64-keypoint
        # chunk (K % 64 of them) and, at M - 1, in the partial 64-row tile.
        for case, m, k in (("structured", M, K), ("ties", M, K), ("all_invalid", M, K),
                           ("odd_m", M - 1, K), ("dense", M, K), ("dense_tail", M, K),
                           ("dense_tail", M - 1, K), ("dense_tail", M - 1, 96)):
            args = _radius_inputs(rng, k, m, D, case)
            timed.setdefault(case, args)
            got = cuda_matching.radius_match(*args, radius_px=radius, desc_thresh=thresh)
            ref = matching.radius_descriptor_match_fused_plain(*args, radius, thresh)
            n_bad, derr, n_ok = _radius_mismatches(got, ref)
            n_tail = int(ref[1][k // 64 * 64:].sum())  # matched in the partial chunk
            mism += n_bad
            err = max(err, derr)
            print(f"radius_match[{case}]: M={m} K={k} matched={n_ok} (last chunk {n_tail}) "
                  f"mismatches={n_bad} max_dist_err={derr:.3g}", flush=True)
            if case in ("structured", "dense", "dense_tail") and n_ok < k // 4:
                fail(f"radius check input ({case}) produced too few matches")
            if case == "dense_tail" and not n_tail:
                fail("the dense_tail input matched no keypoint in the last chunk")
        q, uvq, vq, db, uvdb, vdb = timed["structured"]
        cuda_matching.reset_launch_counts()
        k_ms = time_ms(lambda: cuda_matching.radius_match(
            q, uvq, vq, db, uvdb, vdb, radius_px=radius, desc_thresh=thresh))
        p_ms = time_ms(lambda: matching.radius_descriptor_match_fused_plain(
            q, uvq, vq, db, uvdb, vdb, radius, thresh))
        mm_ms = time_ms(lambda: torch.matmul(db, q.T))
        dq, duvq, dvq, ddb, duvdb, dvdb = timed["dense"]
        dense_ms = time_ms(lambda: cuda_matching.radius_match(
            dq, duvq, dvq, ddb, duvdb, dvdb, radius_px=radius, desc_thresh=thresh))
    work = radius_work(uvq, vq, uvdb, vdb, D, radius)
    results["radius_match"] = dict(
        name="radius_match", route="cuda", source="vslam_tpu_torch/csrc/matching.cu",
        replaces="vslam_tpu/ops/pallas_matching.py:218", path="main",
        ok=mism == 0, mismatches=mism, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
        **radius_fields(work), dense_bound_ms=bound(_dense_radius_bytes(K, M, D),
                                                    2 * M * K * D)[0],
        library_ms=None, dense_ms=dense_ms, matmul_ms=mm_ms, matmul_call=MATMUL_CALL,
        shapes=f"K={K} M={M} D={D} bf16",
    )

    # ---- batched radius match (the multi path's local-map step) ----
    B = MULTI_B
    mism, err = 0, 0.0
    with f32_matmuls():
        for m, cases in ((M, ("structured", "ties", "all_invalid", "all_valid")),
                         (M - 1, ("structured", "ties", "all_invalid", "all_valid")),
                         (M, ("dense",) * B), (M - 1, ("dense_tail",) * B)):
            members = [_radius_inputs(rng, K, m, D, case) for case in cases]
            args = [torch.stack(f) for f in zip(*members)]
            if m == M:
                timed[cases[0]] = args
            got = cuda_matching.radius_match_batched(*args, radius_px=radius, desc_thresh=thresh)
            ref = matching.radius_descriptor_match_fused_batched_plain(*args, radius, thresh)
            single = [cuda_matching.radius_match(*a, radius_px=radius, desc_thresh=thresh)
                      for a in members]
            # Per-member tensors (each its own allocation), as the multi path passes them.
            lists = cuda_matching.radius_match_batched(
                *(list(f) for f in zip(*members)), radius_px=radius, desc_thresh=thresh)
            n_bad, derr, n_ok = _radius_mismatches(got, ref)
            # The same device code per member: every output equal, bit for bit.
            n_single = sum(int((g != torch.stack(x)).sum()) for g, x in zip(got, zip(*single)))
            n_lists = sum(int((g != x).sum()) for g, x in zip(got, lists))
            mism += n_bad + n_single + n_lists
            err = max(err, derr)
            print(f"radius_match_batched[{cases[0]}]: B={B} M={m} matched={n_ok} "
                  f"mismatches={n_bad} vs {B} single launches={n_single} "
                  f"vs member pointers={n_lists} max_dist_err={derr:.3g}", flush=True)
            if n_ok < K // 2:
                fail("batched radius check input produced too few matches")
        q, uvq, vq, db, uvdb, vdb = timed["structured"]
        k_ms = time_ms(lambda: cuda_matching.radius_match_batched(
            q, uvq, vq, db, uvdb, vdb, radius_px=radius, desc_thresh=thresh))
        p_ms = time_ms(lambda: matching.radius_descriptor_match_fused_batched_plain(
            q, uvq, vq, db, uvdb, vdb, radius, thresh))
        mm_ms = time_ms(lambda: torch.bmm(db, q.transpose(1, 2)))
        dq, duvq, dvq, ddb, duvdb, dvdb = timed["dense"]
        dense_ms = time_ms(lambda: cuda_matching.radius_match_batched(
            dq, duvq, dvq, ddb, duvdb, dvdb, radius_px=radius, desc_thresh=thresh))
    work = radius_work(uvq, vq, uvdb, vdb, D, radius)
    results["radius_match_batched"] = dict(
        name="radius_match_batched", route="cuda", source="vslam_tpu_torch/csrc/matching.cu",
        replaces="vslam_tpu/ops/pallas_matching.py:344", path="multi",
        ok=mism == 0, mismatches=mism, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
        **radius_fields(work), dense_bound_ms=bound(B * _dense_radius_bytes(K, M, D),
                                                    2 * B * M * K * D)[0],
        library_ms=None, dense_ms=dense_ms, matmul_ms=mm_ms, matmul_call=BMM_CALL,
        shapes=f"B={B} K={K} M={M} D={D} bf16",
    )

    # ---- top-2 match ----
    # Cases (M, Kq): the path's shapes; ties; no valid row; M - 1; one
    # valid row (d2 = 1e9); valid rows only in the 5,000 lowest slots (the
    # recovery map's layout: most tiles skipped) or only in the partial
    # last tile; a map below one tile; an empty map; one and 96 queries.
    mism, err = 0, 0.0
    with f32_matmuls():
        for case, m, k in (("structured", M, K), ("ties", M, K), ("all_invalid", M, K),
                           ("odd_m", M - 1, K), ("one_valid", M, K), ("low_slots", M, K),
                           ("last_tile", M - 1, K), ("structured", 17, K),
                           ("structured", 0, K), ("structured", M, 1), ("odd_m", M - 1, 96)):
            # (a map below K / 2 rows: the first m rows of a full one)
            q, _, _, db, _, vdb = _radius_inputs(rng, k, max(m, M - 1), D, case)
            db, vdb = db[:m], vdb[:m]
            if case == "one_valid":
                vdb[:] = False
                vdb[m // 2 + 7] = True
            if case == "low_slots":
                vdb[5000:] = False
            if case == "last_tile":
                vdb[: m // 64 * 64] = False
            if (case, m, k) == ("structured", M, K):
                timed_inputs = (db, vdb, q)
            got = cuda_matching.top2_match(db, vdb, q)
            n_bad, derr = _top2_mismatches(got, db, vdb, q)
            mism += n_bad
            err = max(err, derr)
            print(f"top2_match[{case}]: M={m} Kq={k} valid={int(vdb.sum())} "
                  f"live_tiles={live_tiles(vdb)} mismatches={n_bad} max_err={derr:.3g}",
                  flush=True)
        db, vdb, q = timed_inputs
        k_ms = time_ms(lambda: cuda_matching.top2_match(db, vdb, q))
        p_ms = time_ms(lambda: matching.top2_match_plain(db, vdb, q))
        mm_ms = time_ms(lambda: torch.matmul(db, q.T))
    b_ms, b_by = bound(*top2_work(vdb, K, D))
    results["top2_match"] = dict(
        name="top2_match", route="cuda", source="vslam_tpu_torch/csrc/matching.cu",
        replaces="vslam_tpu/ops/pallas_matching.py:93", path="recovery",
        ok=mism == 0, mismatches=mism, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by,
        dense_bound_ms=bound(M * D * 2 + M + K * D * 2 + 3 * K * 4, 2 * M * K * D)[0],
        library_ms=None, matmul_ms=mm_ms, matmul_call=MATMUL_CALL,
        shapes=f"Kq={K} M={M} D={D} bf16",
    )
    cuda_matching.reset_launch_counts()
    for r in results.values():
        if not r["ok"]:
            fail(f"kernel {r['name']} disagrees with its plain version ({r['mismatches']} mismatches)")
    return results


# --------------------------------------------------------------------------
# Main path + recovery
# --------------------------------------------------------------------------


def count_host_syncs(fn):
    """Runs fn() under PyTorch's CUDA sync debug mode, which warns at
    every operation that makes the host wait for the card (a read of a
    device value, a copy from pageable host memory). Returns the count by
    the innermost line of the port or this script that made it."""
    import torch

    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):
            return
        site = f"{os.path.relpath(filename, ROOT)}:{lineno}"
        for fr in reversed(traceback.extract_stack()[:-1]):
            if fr.filename.startswith(ROOT) and "warnings" not in fr.filename:
                site = f"{os.path.relpath(fr.filename, ROOT)}:{fr.lineno}"
                break
        sites[site] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites


def run_main_path(config, profile=False):
    import numpy as np
    import torch

    from vslam_tpu_torch.core import coupled, tracking
    from vslam_tpu_torch.core.state import init_state
    from vslam_tpu_torch.data import synthetic
    from vslam_tpu_torch.eval import ate as ate_mod
    from vslam_tpu_torch.models import weights as wmod
    from vslam_tpu_torch.ops import cuda_matching, gridhash

    n_frames, chunk = N_FRAMES, CHUNK
    c = config.camera
    t0 = time.perf_counter()
    d = synthetic.make_image_sequence(
        n_frames, width=c.width, height=c.height, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
        seed=0, num_landmarks=6000, radius=3.0, with_rgb=False,
    )
    render_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    S = n_frames // chunk
    H, W = c.height, c.width
    gray = torch.from_numpy(d["gray"].reshape(S, chunk, H, W)).to(dev)
    dep = torch.from_numpy(d["depth_u16"].astype(np.int32).reshape(S, chunk, H, W)).to(dev)
    ts = torch.from_numpy(d["timestamps"].astype(np.float32).reshape(S, chunk)).to(dev)
    fid = torch.arange(n_frames, dtype=torch.int32).reshape(S, chunk).to(dev)
    stat = torch.zeros((S, chunk), dtype=torch.bool, device=dev)
    model = wmod.load_superpoint(wmod.TRAINED_SP_NPZ, device=dev)
    st0 = init_state(config, device=dev)
    dense0 = gridhash.init_dense_map(config.dense.hash_capacity, config.dense.cloud_capacity,
                                     device=dev)

    def run():
        return coupled.run_coupled(model, st0, dense0, gray, dep, None, ts, fid, stat, config)

    t0 = time.perf_counter()
    run()  # warm-up: cuDNN autotuning, library load
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    tracking.reset_stats()
    sync_sites = count_host_syncs(run)
    branch_reads = tracking.STATS["branch_reads"]
    n_syncs = sum(sync_sites.values())

    cuda_matching.reset_launch_counts()
    tracking.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_f, dense_f, outs = run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(cuda_matching.LAUNCHES)
    stats = dict(tracking.STATS)
    dense_res = check_dense_replay(config, dense_f, d["depth_u16"], outs.R, outs.t, chunk)

    t_est = outs.t.cpu().numpy()
    R_est = outs.R.cpu().numpy()
    if not (np.isfinite(t_est).all() and np.isfinite(R_est).all()):
        fail("non-finite poses on the main path")
    ate = ate_mod.compute_ate(d["timestamps"], t_est, d["timestamps"], d["t"],
                              with_scale=False).rmse
    is_kf = outs.is_keyframe.cpu().numpy()
    used = outs.used_3d3d.cpu().numpy()
    tok = outs.tracking_ok.cpu().numpy()
    res = dict(
        frames=n_frames, chunk=chunk, render_s=render_s, warmup_s=warm_s, run_s=dt,
        fps=n_frames / dt, ate_raw_m=float(ate),
        keyframes=int(is_kf.sum()),
        bridged=int(outs.bridged.cpu().numpy().sum()),
        recovered=int(outs.recovered.cpu().numpy().sum()),
        essential_frames=int((~used & tok).sum()),
        tracked_frac=float(tok[1:].mean()),
        mean_matches=float(outs.num_matches.cpu().numpy()[1:].mean()),
        mean_tracks=float(outs.num_tracked.cpu().numpy()[1:].mean()),
        live_map_points=int(st_f.map.valid.sum()),
        loop_constraints=int(st_f.loops.valid.sum()),
        track_frames=stats["track_frames"], host_syncs=n_syncs,
        host_syncs_per_frame=n_syncs / n_frames, branch_reads=branch_reads,
        host_sync_sites=dict(sync_sites.most_common(12)),
        launches=launches, **dense_res,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    print("main path: " + json.dumps(res), flush=True)
    if not ate <= 0.02:
        fail(f"raw ATE {ate:.4f} m > 0.02 m")
    if res["tracked_frac"] < 0.95:
        fail(f"tracked fraction {res['tracked_frac']:.3f} < 0.95")
    if not 8 <= res["keyframes"] <= 20:
        fail(f"{res['keyframes']} keyframes, outside 8-20")
    if launches["radius_match"] != stats["track_frames"]:
        fail(f"radius kernel launched {launches['radius_match']} times for "
             f"{stats['track_frames']} tracked frames")
    if not 0 < dense_res["cloud_count"] <= dense_res["cloud_capacity"]:
        fail(f"dense cloud holds {dense_res['cloud_count']} points")
    if dense_res["dense_mismatches"]:
        fail(f"the card's dense map differs from its CPU replay: {dense_res}")
    # The trace runs after every timed run of the script: a finished
    # torch.profiler session leaves each later kernel launch slower.
    def trace():
        profile_main_path(config, model, st0, gray, dep, ts, fid, stat)

    return res, st_f, outs, d, model, trace if profile else None


def check_dense_replay(config, dense, depth_u16, R, t, chunk):
    """Holds the card's fused map against the same fusion
    (`core.coupled.fuse_chunk`) replayed on the CPU from the same depths
    and poses, chunk by chunk as `run_coupled` fuses. The back-projection
    rotates with elementwise products summed in a fixed order and divides
    by true division (`ops.gridhash`), so the card and the CPU round alike:
    the winners, counts and points must be equal (points within 1e-5 m),
    and no point may land in another voxel (bound 0)."""
    import numpy as np
    import torch

    from vslam_tpu_torch.core import coupled
    from vslam_tpu_torch.ops import gridhash

    dn = config.dense
    cpu = gridhash.init_dense_map(dn.hash_capacity, dn.cloud_capacity, device="cpu")
    R, t = R.cpu(), t.cpu()
    for k in range(0, depth_u16.shape[0], chunk):
        cpu = coupled.fuse_chunk(cpu, torch.from_numpy(depth_u16[k:k + chunk].astype(np.int32)),
                                 None, R[k:k + chunk], t[k:k + chunk], config, chunk)
    card = [x.cpu() for x in dense]
    n = int(card[3])
    slots = int((card[0] != cpu.table_winner).sum())
    xyz_err = float((card[1][:n] - cpu.cloud_xyz[:n]).abs().max()) if n else 0.0
    mism = slots + int(n != int(cpu.cloud_count)) + int(int(card[4]) != int(cpu.insert_epoch))
    mism += int(xyz_err > 1e-5)
    return dict(cloud_count=n, cloud_capacity=gridhash.dense_cloud_capacity(dense),
                dense_cpu_count=int(cpu.cloud_count), dense_slot_mismatches=slots,
                dense_xyz_max_err=xyz_err, dense_mismatches=mism)


def profile_main_path(config, model, st0, gray, dep, ts, fid, stat):
    """Where the main path's time goes (--profile): the host-clock split of
    one more run between the frontend and the tracking loop, then a
    torch.profiler trace of the second chunk."""
    from vslam_tpu_torch.core import frontend as fe
    from vslam_tpu_torch.core import tracking

    ids = fid.cpu().tolist()

    def frontend(s):
        return fe.frontend_features(model, gray[s], dep[s], ts[s], fid[s], stat[s], config)

    def track(st, frames, s):
        return tracking.run_frames(st, frames, ids[s], config)[0]

    profile_chunks("profile", st0, gray.shape[0], frontend, track, gray.shape[1])


def profile_chunks(label, st0, n_chunks, frontend, track, frames_per_chunk):
    """The host-clock split of a run of `n_chunks` chunks between the
    frontend (`frontend(s)` -> frames) and the tracking loop
    (`track(state, frames, s)` -> state), then a torch.profiler trace of
    the second chunk: device-busy share of the wall time, kernel launches
    per frame and the kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vslam_tpu_torch.core.state import clone_tree

    def chunk(st, s):
        frames = frontend(s)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st = track(st, frames, s)
        torch.cuda.synchronize()
        return st, t1

    st = clone_tree(st0)
    fe_s = tr_s = 0.0
    for s in range(n_chunks):
        if s == 1:
            st1 = clone_tree(st)  # the state the profiled chunk starts from
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, t1 = chunk(st, s)
        fe_s += t1 - t0
        tr_s += time.perf_counter() - t1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chunk(st1, 1)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # union of the kernels' intervals on the device
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in kernels:
        n = by_name.setdefault(e.name, [0, 0.0])
        n[0] += 1
        n[1] += e.time_range.end - e.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    res = dict(
        frontend_s=fe_s, tracking_s=tr_s, profiled_frames=frames_per_chunk,
        profiled_wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
        device_idle_share=1.0 - busy / wall_us,
        kernel_launches_per_frame=len(kernels) / frames_per_chunk,
        top_kernels=[dict(name=k[:80], launches=v[0], device_ms=v[1] / 1e3) for k, v in top],
    )
    print(f"{label}: " + json.dumps(res), flush=True)
    if not kernels:
        fail(f"the profiler recorded no device kernel ({label})")


def run_multi_path(config, model, main_data, main_outs, profile=False):
    """`run_coupled_batched` at B = MULTI_B over the worlds of seeds
    0..B-1 (seed 0 is the main phase's world), chunks of MULTI_CHUNK frames
    per member, a default dense map each. Returns (the result dict, the
    final batched state, the worlds, the --profile trace to run later or
    None)."""
    import numpy as np
    import torch

    from vslam_tpu_torch.core import coupled, tracking, tracking_batched
    from vslam_tpu_torch.core.state import stack_trees
    from vslam_tpu_torch.data import synthetic
    from vslam_tpu_torch.eval import ate as ate_mod
    from vslam_tpu_torch.ops import cuda_matching, gridhash
    from vslam_tpu_torch.parallel.mesh import replicate_state

    B, C, n_frames = MULTI_B, MULTI_CHUNK, N_FRAMES
    c = config.camera
    t0 = time.perf_counter()
    worlds = [main_data] + [synthetic.make_image_sequence(
        n_frames, width=c.width, height=c.height, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
        seed=seed, num_landmarks=6000, radius=3.0, with_rgb=False) for seed in range(1, B)]
    render_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    S, H, W = n_frames // C, c.height, c.width

    def stack(key, dtype):  # (N, ...) per world -> (S, C, B, ...)
        x = np.stack([w[key].astype(dtype) for w in worlds], axis=1)
        return torch.from_numpy(x.reshape((S, C) + x.shape[1:])).to(dev)

    gray, dep = stack("gray", np.uint8), stack("depth_u16", np.int32)
    ts = stack("timestamps", np.float32)
    fid = torch.arange(n_frames, dtype=torch.int32, device=dev)
    fid = fid.repeat_interleave(B).reshape(S, C, B)
    stat = torch.zeros((S, C, B), dtype=torch.bool, device=dev)
    st0 = replicate_state(config, B, device=dev)
    dense0 = stack_trees([gridhash.init_dense_map(
        config.dense.hash_capacity, config.dense.cloud_capacity, device=dev)] * B)

    def run(n_chunks=S):
        return coupled.run_coupled_batched(
            model, st0, dense0, gray[:n_chunks], dep[:n_chunks], ts[:n_chunks], fid[:n_chunks],
            stat[:n_chunks], config)

    # Warm-up: one chunk (cuDNN picks its algorithms for the C*B-frame
    # batch), under the sync debug mode.
    tracking.reset_stats()
    t0 = time.perf_counter()
    sync_sites = count_host_syncs(lambda: run(1))
    warm_s = time.perf_counter() - t0
    warm_reads = tracking.STATS["branch_reads"]

    cuda_matching.reset_launch_counts()
    tracking.reset_stats()
    tracking_batched.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_f, dense_f, outs = run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(cuda_matching.LAUNCHES)
    reads = tracking.STATS["branch_reads"]
    blocks = dict(tracking_batched.STATS)

    t_est, R_est = outs.t.cpu().numpy(), outs.R.cpu().numpy()
    if not (np.isfinite(t_est).all() and np.isfinite(R_est).all()):
        fail("non-finite poses on the multi path")
    tok = outs.tracking_ok.cpu().numpy()
    is_kf = outs.is_keyframe.cpu().numpy()
    members = []
    for b, w in enumerate(worlds):
        ate = ate_mod.compute_ate(w["timestamps"], t_est[:, b], w["timestamps"], w["t"],
                                  with_scale=False).rmse
        members.append(dict(
            seed=b, ate_raw_m=float(ate), ate_limit_m=MULTI_ATE_LIMIT[b],
            tracked_frac=float(tok[1:, b].mean()), keyframes=int(is_kf[:, b].sum()),
            cloud_count=int(dense_f.cloud_count[b]),
        ))

    # Member 0 saw the main phase's input.
    decisions = ("is_keyframe", "tracking_ok", "used_3d3d", "bridged", "recovered")
    m0_diff = {k: int((getattr(outs, k)[:, 0] != getattr(main_outs, k)).sum()) for k in decisions}
    m0_dt = float((outs.t[:, 0] - main_outs.t).abs().max())
    res = dict(
        B=B, frames_per_member=n_frames, chunk_per_member=C, render_s=render_s,
        warmup_chunk_s=warm_s, run_s=dt, fps_aggregate=B * n_frames / dt,
        fps_per_sequence=n_frames / dt, branch_reads=reads,
        branch_reads_per_frame=reads / n_frames, hoisted_block_member_runs=blocks,
        warmup_host_syncs=sum(sync_sites.values()), warmup_branch_reads=warm_reads,
        warmup_host_sync_sites=dict(sync_sites.most_common(12)), launches=launches,
        members=members, member0_decision_diffs=m0_diff, member0_max_abs_dt_m=m0_dt,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    print("multi path: " + json.dumps(res), flush=True)
    tracked = blocks["track_steps"]
    if launches["radius_match_batched"] != tracked or tracked != n_frames - 1:
        fail(f"batched radius kernel launched {launches['radius_match_batched']} times for "
             f"{blocks['track_steps']} tracked frames (expected {n_frames - 1})")
    if launches["radius_match"]:
        fail(f"the single radius kernel launched {launches['radius_match']} times "
             "on the multi path")
    for m in members:
        if not m["ate_raw_m"] <= m["ate_limit_m"]:
            fail(f"member {m['seed']}: raw ATE {m['ate_raw_m']:.4f} m > {m['ate_limit_m']} m")
        if m["tracked_frac"] < 0.95:
            fail(f"member {m['seed']}: tracked fraction {m['tracked_frac']:.3f} < 0.95")
        if not 8 <= m["keyframes"] <= 20:
            fail(f"member {m['seed']}: {m['keyframes']} keyframes, outside 8-20")
        if not 0 < m["cloud_count"] <= config.dense.cloud_capacity:
            fail(f"member {m['seed']}: dense cloud holds {m['cloud_count']} points")
    if any(m0_diff.values()) or not m0_dt <= 1e-3:
        fail(f"member 0 differs from the main phase: decisions {m0_diff}, max |dt| {m0_dt} m")
    def trace():
        from vslam_tpu_torch.core import frontend as fe
        from vslam_tpu_torch.core.state import FrameFeatures

        ids = fid.cpu().tolist()

        def frontend(s):
            flat = fe.frontend_features(
                model, gray[s].flatten(0, 1), dep[s].flatten(0, 1), ts[s].flatten(),
                fid[s].flatten(), stat[s].flatten(), config)
            return FrameFeatures(*(x.unflatten(0, (C, B)) for x in flat))

        def track(st, frames, s):
            return tracking_batched.run_frames_batched(st, frames, ids[s], config)[0]

        profile_chunks("profile multi", st0, S, frontend, track, C)

    return res, st_f, worlds, trace if profile else None


def frame_features(config, model, frame_gray, frame_dep):
    """One frame's features as the tracking step takes them (descriptors in
    bf16), from gray uint8 and integer depth, (H, W) numpy."""
    import numpy as np
    import torch

    from vslam_tpu_torch.core import frontend as fe
    from vslam_tpu_torch.core import tracking

    dev = torch.device("cuda")
    frames = fe.frontend_features(
        model, torch.from_numpy(frame_gray[None]).to(dev),
        torch.from_numpy(frame_dep[None].astype(np.int32)).to(dev),
        torch.zeros(1, device=dev), torch.zeros(1, dtype=torch.int32, device=dev),
        torch.zeros(1, dtype=torch.bool, device=dev), config,
    )
    frame = tracking.frame_at(frames, 0)
    return frame._replace(desc=frame.desc.to(torch.bfloat16))


def path_radius_inputs(config, st, frame):
    """The local-map match's inputs as the tracking step builds them: the
    state's map projected at the state's pose, and a frame's keypoints."""
    from vslam_tpu_torch.core import tracking
    from vslam_tpu_torch.ops.linalg import f32_matmuls

    with f32_matmuls():
        uv, visible = tracking._project_map(st.map, config, st.R, st.t)
    return frame.desc, frame.xy, frame.valid, st.map.desc, uv, visible


def check_path_radius(config, result, members, batched):
    """Holds a radius kernel against its plain version on the path's own
    input (`members`: one `path_radius_inputs` tuple per member) and times
    it there; adds the `path_*` fields to the kernel's `result`. The
    batched kernel gets each member's own tensors, as the multi path hands
    them over, and is also held against its stacked form."""
    import torch

    from vslam_tpu_torch.ops import cuda_matching, matching
    from vslam_tpu_torch.ops.linalg import f32_matmuls

    radius = config.map.track_search_radius_px
    thresh = config.map.track_desc_threshold
    lists = [list(f) for f in zip(*members)]
    stacked = [torch.stack(f) for f in lists]
    if batched:
        def call():
            return cuda_matching.radius_match_batched(*lists, radius_px=radius,
                                                      desc_thresh=thresh)
    else:
        def call():
            return cuda_matching.radius_match(*members[0], radius_px=radius,
                                              desc_thresh=thresh)
    with f32_matmuls():
        got = call()
        ref = matching.radius_descriptor_match_fused_batched_plain(*stacked, radius, thresh)
        if not batched:
            ref = tuple(x[0] for x in ref)
        n_bad, derr, n_ok = _radius_mismatches(got, ref)
        if batched:
            alt = cuda_matching.radius_match_batched(*stacked, radius_px=radius,
                                                     desc_thresh=thresh)
            n_bad += sum(int((g != x).sum()) for g, x in zip(got, alt))
        ms = time_ms(call)
    work = radius_work(stacked[1], stacked[2], stacked[4], stacked[5], stacked[0].shape[-1],
                       radius)
    b_ms, b_by = bound(work["nbytes"], work["flops"])
    result.update(
        path_ms=ms, path_bound_ms=b_ms, path_bound_by=b_by,
        path_rows_with_candidates=work["rows_with_candidates"],
        path_pairs_in_radius=work["pairs_in_radius"],
        path_visible_rows=int(stacked[5].sum()), path_matched=n_ok, path_mismatches=n_bad,
        max_abs_err=max(result["max_abs_err"], derr),
    )
    print(f"{result['name']}[path]: B={len(members)} visible={result['path_visible_rows']} "
          f"pairs={work['pairs_in_radius']} matched={n_ok} mismatches={n_bad} "
          f"max_dist_err={derr:.3g} ms={ms:.4f}", flush=True)
    if n_bad:
        fail(f"kernel {result['name']} disagrees with its plain version on the path's "
             f"own input ({n_bad} mismatches)")


def run_recovery(config, model_state, frame_gray, frame_dep, result):
    """Tracking-loss recovery on the final state against one frame of the
    run (gray uint8 and integer depth, (H, W) numpy): the top-2 kernel
    launches once and agrees with its plain version. Then the top-2 kernel
    on the recovery's own input (the final map against that frame): held
    against its plain version and timed there; adds `launches`, `path_*`,
    `valid_rows` and `live_tiles` to the kernel's `result`."""
    import torch

    from vslam_tpu_torch.core import tracking
    from vslam_tpu_torch.models import weights as wmod
    from vslam_tpu_torch.ops import cuda_matching, matching, prng
    from vslam_tpu_torch.ops.linalg import f32_matmuls

    dev = torch.device("cuda")
    model = wmod.load_superpoint(wmod.TRAINED_SP_NPZ, device=dev)
    frame = frame_features(config, model, frame_gray, frame_dep)
    key = prng.split(prng.fold_in(prng.prng_key(42), 0), 7)[3]
    cuda_matching.reset_launch_counts()
    R, t, ok = tracking._try_pnp_recovery(model_state, frame, config, key)
    torch.cuda.synchronize()
    launches = cuda_matching.LAUNCHES["top2_match"]
    got = matching.knn2_ratio_match_streaming(
        frame.desc, model_state.map.desc, frame.valid, model_state.map.valid,
        ratio=config.frontend.flann_ratio_threshold ** 0.5)
    ref = matching.knn2_ratio_match(
        frame.desc, model_state.map.desc, frame.valid, model_state.map.valid,
        ratio=config.frontend.flann_ratio_threshold ** 0.5, mutual=False)
    gv, rv = got.valid.cpu().numpy(), ref.valid.cpu().numpy()
    gi, ri = got.idx.cpu().numpy(), ref.idx.cpu().numpy()
    mism = int((gv != rv).sum() + (gi[rv] != ri[rv]).sum())
    res = dict(top2_launches=launches, recovery_ok=bool(ok), matches=int(rv.sum()),
               mismatches=mism, R_finite=bool(torch.isfinite(R).all()),
               t_finite=bool(torch.isfinite(t).all()))
    print("recovery: " + json.dumps(res), flush=True)
    if launches != 1:
        fail(f"recovery launched the top-2 kernel {launches} times, not once")
    if mism:
        fail(f"recovery matches disagree with the plain version ({mism})")
    if not (res["R_finite"] and res["t_finite"]):
        fail("recovery returned a non-finite pose")

    db, vdb, q = model_state.map.desc, model_state.map.valid, frame.desc
    with f32_matmuls():
        n_bad, derr = _top2_mismatches(cuda_matching.top2_match(db, vdb, q), db, vdb, q,
                                       atol=1e-4)
    ms = time_ms(lambda: cuda_matching.top2_match(db, vdb, q))
    b_ms, b_by = bound(*top2_work(vdb, q.shape[0], q.shape[1]))
    result.update(launches=launches, path_ms=ms, path_bound_ms=b_ms, path_bound_by=b_by,
                  valid_rows=int(vdb.sum()), live_tiles=live_tiles(vdb),
                  path_mismatches=n_bad, max_abs_err=max(result["max_abs_err"], derr))
    print(f"top2_match[path]: M={db.shape[0]} valid={result['valid_rows']} "
          f"live_tiles={result['live_tiles']} mismatches={n_bad} max_err={derr:.3g} "
          f"ms={ms:.4f}", flush=True)
    if n_bad:
        fail(f"kernel top2_match disagrees with its plain version on the recovery's own "
             f"input ({n_bad} mismatches)")
    return res


def run_loop_path(config, model, variant, kernels):
    """The coupled path through a loop closure on the JAX bench's stress
    world `variant`: render it, derive stationarity and gravity from its
    accelerometer, run `run_coupled` once (no warm-up; under the sync
    debug mode, which counts every host sync), then RTS
    (`result_from_outputs`) and `run_backend`. Then the fold check: the
    final state's ring drifted (`drift_ring`) and folded by
    `inrun_pgo_correct` on the card and on the CPU (`compare_folds`); and
    the radius and top-2 kernels on the run's own final map against its
    last frame (`loop_path_ms`; `loop_launches` from the run). Returns the
    result dict; the caller applies `loop_failures`."""
    import numpy as np
    import torch

    from vslam_tpu_torch.core import coupled, pipeline, tracking
    from vslam_tpu_torch.core.state import from_numpy, init_state, to_numpy
    from vslam_tpu_torch.data import synthetic
    from vslam_tpu_torch.eval import ate as ate_mod
    from vslam_tpu_torch.ops import cuda_matching, gridhash, matching
    from vslam_tpu_torch.ops.linalg import f32_matmuls

    spec = STRESS[variant]
    n, C = spec["frames"], STRESS_CHUNK
    c = config.camera
    t0 = time.perf_counter()
    d = synthetic.make_stress_image_sequence(
        n, width=c.width, height=c.height, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
        num_landmarks=6000, **spec["kw"])
    render_s = time.perf_counter() - t0
    stat_np = pipeline.detect_stationary(d["accel"], d["timestamps"],
                                         window=config.ekf.stationary_window_s,
                                         threshold=config.ekf.stationary_accel_std)
    gravity, h0 = pipeline.compute_gravity_direction(d["accel"], np.eye(3, dtype=np.float32))
    dev = torch.device("cuda")
    S, H, W = n // C, c.height, c.width
    gray = torch.from_numpy(d["gray"].reshape(S, C, H, W)).to(dev)
    dep = torch.from_numpy(d["depth_u16"].astype(np.int32).reshape(S, C, H, W)).to(dev)
    ts = torch.from_numpy(d["timestamps"].astype(np.float32).reshape(S, C)).to(dev)
    fid = torch.arange(n, dtype=torch.int32).reshape(S, C).to(dev)
    stat = torch.from_numpy(stat_np.reshape(S, C)).to(dev)
    st0 = init_state(config, gravity=gravity, initial_height=h0, device=dev)
    dense0 = gridhash.init_dense_map(config.dense.hash_capacity, config.dense.cloud_capacity,
                                     device=dev)

    box = {}
    cuda_matching.reset_launch_counts()
    tracking.reset_stats()
    pipeline.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sync_sites = count_host_syncs(lambda: box.update(out=coupled.run_coupled(
        model, st0, dense0, gray, dep, None, ts, fid, stat, config)))
    run_s = time.perf_counter() - t0
    st_f, dense_f, outs = box["out"]
    launches = dict(cuda_matching.LAUNCHES)
    stats, pstats = dict(tracking.STATS), dict(pipeline.STATS)

    t0 = time.perf_counter()
    result = pipeline.result_from_outputs(st_f, outs, keep_refine=config.ekf.smooth_keep_refine,
                                          rts_parallel=config.ekf.rts_parallel)
    rts_s = time.perf_counter() - t0
    tracking.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_b = pipeline.run_backend(result, config)
    torch.cuda.synchronize()
    backend_s = time.perf_counter() - t0
    backend_reads = tracking.STATS["branch_reads"]

    def ate(t_est):
        if not np.isfinite(t_est).all():
            return float("inf")
        return float(ate_mod.compute_ate(d["timestamps"], t_est, d["timestamps"], d["t"],
                                         with_scale=False).rmse)

    o = {k: getattr(outs, k).cpu().numpy()
         for k in ("is_keyframe", "bridged", "recovered", "tracking_ok", "num_matches")}
    tok = o["tracking_ok"]
    n_syncs = sum(sync_sites.values())
    res = dict(
        variant=variant, frames=n, chunk=C, render_s=render_s, run_s=run_s, fps=n / run_s,
        rts_s=rts_s, backend_s=backend_s, backend_branch_reads=backend_reads,
        ate_raw_m=ate(result.t), ate_smoothed_m=ate(result.t_smoothed),
        ate_backend_m=ate(res_b.t_smoothed),
        backend_identity=bool(np.array_equal(res_b.t_smoothed, result.t_smoothed)),
        keyframes=int(o["is_keyframe"].sum()), bridged=int(o["bridged"].sum()),
        lost_frames=int((~tok).sum()), recovered=int(o["recovered"].sum()),
        stationary_frames=int(stat_np.sum()), tracked_frac=float(tok[1:].mean()),
        loop_constraints=int(st_f.loops.valid.sum()),
        inrun_corrections=int(st_f.inrun_corrections), inrun_calls=pstats["inrun_calls"],
        inrun_solves=pstats["pgo_solves"], track_frames=stats["track_frames"],
        radius_launches=launches["radius_match"], top2_launches=launches["top2_match"],
        recovery_attempts=recovery_attempts(o["num_matches"], o["recovered"],
                                            config.frontend.min_matches,
                                            config.pnp.recovery_cooldown_frames),
        host_syncs=n_syncs, host_syncs_per_frame=n_syncs / n,
        branch_reads=stats["branch_reads"], host_sync_sites=dict(sync_sites.most_common(8)),
        cloud_count=int(dense_f.cloud_count), peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )

    # The fold check, from one drifted copy of the final state.
    t0 = time.perf_counter()
    before = drift_ring(to_numpy(st_f), n)
    folded = {}
    for where in ("cuda", "cpu"):
        pipeline.reset_stats()
        out = pipeline.inrun_pgo_correct(from_numpy(before, where), config)
        folded[where] = (to_numpy(out), pipeline.STATS["pgo_solves"])
    res.update(compare_folds(before, folded["cuda"][0], folded["cpu"][0], folded["cuda"][1],
                             folded["cpu"][1]))
    res["fold_check_s"] = time.perf_counter() - t0

    # The kernels on this path's own final input.
    frame = frame_features(config, model, d["gray"][-1], d["depth_u16"][-1])
    inputs = path_radius_inputs(config, st_f, frame)
    radius = config.map.track_search_radius_px
    thresh = config.map.track_desc_threshold
    with f32_matmuls():
        got = cuda_matching.radius_match(*inputs, radius_px=radius, desc_thresh=thresh)
        ref = matching.radius_descriptor_match_fused_plain(*inputs, radius, thresh)
        n_bad_r, _, _ = _radius_mismatches(got, ref)
        ms_r = time_ms(lambda: cuda_matching.radius_match(*inputs, radius_px=radius,
                                                          desc_thresh=thresh))
        db, vdb, q = st_f.map.desc, st_f.map.valid, frame.desc
        n_bad_t, _ = _top2_mismatches(cuda_matching.top2_match(db, vdb, q), db, vdb, q,
                                      atol=1e-4)
        ms_t = time_ms(lambda: cuda_matching.top2_match(db, vdb, q))
    work = radius_work(inputs[1], inputs[2], inputs[4], inputs[5], inputs[0].shape[-1], radius)
    b_r, by_r = bound(work["nbytes"], work["flops"])
    b_t, by_t = bound(*top2_work(vdb, q.shape[0], q.shape[1]))
    tag = "" if variant == "s101_l1" else "long_"
    kernels["radius_match"].update({f"{tag}loop_launches": res["radius_launches"],
                                    f"{tag}loop_path_ms": ms_r,
                                    f"{tag}loop_path_bound_ms": b_r,
                                    f"{tag}loop_path_bound_by": by_r,
                                    f"{tag}loop_path_mismatches": n_bad_r})
    kernels["top2_match"].update({f"{tag}loop_launches": res["top2_launches"],
                                  f"{tag}loop_path_ms": ms_t,
                                  f"{tag}loop_path_bound_ms": b_t,
                                  f"{tag}loop_path_bound_by": by_t,
                                  f"{tag}loop_path_mismatches": n_bad_t,
                                  f"{tag}loop_valid_rows": int(vdb.sum()),
                                  f"{tag}loop_live_tiles": live_tiles(vdb)})
    res.update(radius_path_mismatches=n_bad_r, top2_path_mismatches=n_bad_t)
    print("loop path: " + json.dumps(res), flush=True)
    return res


def check_loop(res, jax_figures=JAX_STRESS):
    """Fails the run on any of the loop path's checks: `loop_failures`,
    the fold check, the kernels on the path's input."""
    fails = loop_failures(res, jax_figures)
    if res["fold_step_card"] != 1:
        fails.append(f"the drifted ring did not fold on the card (step {res['fold_step_card']})")
    if res["fold_mismatches"]:
        fails.append(f"the card's fold differs from the CPU's: {res['fold_max_err']}")
    if res["radius_path_mismatches"] or res["top2_path_mismatches"]:
        fails.append("a kernel disagrees with its plain version on the loop path's input")
    if fails:
        fail(f"loop path {res['variant']}: " + "; ".join(fails))


# --------------------------------------------------------------------------
# Side worlds (mono, mono_depth, noise, holdout) and a run's outputs
# --------------------------------------------------------------------------


def side_world(config, name, main_data):
    """The frames of side world `name` (`SIDE_WORLDS`) as numpy: the main
    phase's seed-0 world (`main_data`) reused where it is that world,
    with its depth zeroed (mono worlds) or under `apply_sensor_noise`;
    else rendered by the port (the held-out v2 family)."""
    import numpy as np

    from vslam_tpu_torch.data import synthetic

    spec = SIDE_WORLDS[name]
    if spec["seed"] == 0 and spec["family"] == "v1":
        d = dict(main_data)
    else:
        c = config.camera
        d = synthetic.make_image_sequence(
            N_FRAMES, width=c.width, height=c.height, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
            seed=spec["seed"], num_landmarks=6000, radius=3.0, with_rgb=False,
            family=spec["family"])
    if spec["noise"]:
        d = synthetic.apply_sensor_noise(d, seed=0)
    if spec["zero_depth"]:
        d["depth_u16"] = np.zeros_like(d["depth_u16"])
    return d


def side_failures(res, jax_fig, rgbd: bool):
    """The checks of a side phase's result dict; returns the failed ones:
    finite poses, ATE within `side_ate_limit` of JAX's CPU run, tracked
    fraction above `side_tracked_floor`, the radius kernel once per
    tracked frame and the top-2 kernel once per recovery attempt."""
    out = []
    if not res["poses_finite"]:
        out.append("non-finite poses")
    lim = side_ate_limit(jax_fig["ate_m"], rgbd)
    if not res["ate_m"] <= lim:
        out.append(f"ATE {res['ate_m']:.4f} m > {lim:.4f} m")
    floor = side_tracked_floor(jax_fig["tracked_frac"])
    if not res["tracked_frac"] >= floor:
        out.append(f"tracked fraction {res['tracked_frac']:.4f} < {floor:.4f}")
    if res["radius_launches"] != res["track_frames"]:
        out.append(f"radius kernel launched {res['radius_launches']} times for "
                   f"{res['track_frames']} tracked frames")
    if res["top2_launches"] != res["recovery_attempts"]:
        out.append(f"top-2 kernel launched {res['top2_launches']} times for "
                   f"{res['recovery_attempts']} recovery attempts")
    return out


def run_side_path(config, model, name, main_data, kernels, depth_model=None):
    """`run_coupled` once over side world `name` (128 frames in chunks of
    32, a fresh dense map; no warm-up; under the sync debug mode, which
    counts every host sync, as the loop phase runs), the launch counts set
    to 0 just before and read just after; the kernels' counts go into
    `kernels` as `<name>_launches`. Fails the run on `side_failures`."""
    import numpy as np
    import torch

    from vslam_tpu_torch.core import coupled, tracking
    from vslam_tpu_torch.core.state import init_state
    from vslam_tpu_torch.eval import ate as ate_mod
    from vslam_tpu_torch.ops import cuda_matching, gridhash

    spec = SIDE_WORLDS[name]
    cfg = config.replace(rgbd=False) if spec["depthnet"] else config
    t0 = time.perf_counter()
    d = side_world(cfg, name, main_data)
    render_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    c = cfg.camera
    S, C, H, W = N_FRAMES // CHUNK, CHUNK, c.height, c.width
    gray = torch.from_numpy(d["gray"].reshape(S, C, H, W)).to(dev)
    dep = torch.from_numpy(d["depth_u16"].astype(np.int32).reshape(S, C, H, W)).to(dev)
    ts = torch.from_numpy(d["timestamps"].astype(np.float32).reshape(S, C)).to(dev)
    fid = torch.arange(N_FRAMES, dtype=torch.int32).reshape(S, C).to(dev)
    stat = torch.zeros((S, C), dtype=torch.bool, device=dev)
    st0 = init_state(cfg, device=dev)
    dense0 = gridhash.init_dense_map(cfg.dense.hash_capacity, cfg.dense.cloud_capacity, device=dev)

    box = {}
    cuda_matching.reset_launch_counts()
    tracking.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sync_sites = count_host_syncs(lambda: box.update(out=coupled.run_coupled(
        model, st0, dense0, gray, dep, None, ts, fid, stat, cfg, depth_params=depth_model)))
    run_s = time.perf_counter() - t0
    st_f, dense_f, outs = box["out"]
    launches = dict(cuda_matching.LAUNCHES)
    stats = dict(tracking.STATS)
    n_syncs = sum(sync_sites.values())

    o = {k: getattr(outs, k).cpu().numpy() for k in (
        "t", "R", "is_keyframe", "used_3d3d", "tracking_ok", "num_matches", "recovered",
        "bridged")}
    finite = bool(np.isfinite(o["t"]).all() and np.isfinite(o["R"]).all())
    ate = (ate_mod.compute_ate(d["timestamps"], o["t"], d["timestamps"], d["t"],
                               with_scale=spec["sim3"]).rmse if finite else float("inf"))
    tok = o["tracking_ok"]
    res = dict(
        phase=name, frames=N_FRAMES, chunk=CHUNK, rgbd=cfg.rgbd, render_s=render_s, run_s=run_s,
        fps=N_FRAMES / run_s, ate_m=float(ate), ate_kind="sim3" if spec["sim3"] else "raw",
        poses_finite=finite, tracked_frac=float(tok[1:].mean()),
        essential_frames=int((~o["used_3d3d"] & tok).sum()),
        keyframes=int(o["is_keyframe"].sum()), bridged=int(o["bridged"].sum()),
        recovered=int(o["recovered"].sum()), mean_matches=float(o["num_matches"][1:].mean()),
        track_frames=stats["track_frames"], radius_launches=launches["radius_match"],
        top2_launches=launches["top2_match"],
        recovery_attempts=recovery_attempts(o["num_matches"], o["recovered"],
                                            cfg.frontend.min_matches,
                                            cfg.pnp.recovery_cooldown_frames),
        radius_batched_launches=launches["radius_match_batched"],
        host_syncs=n_syncs, host_syncs_per_frame=n_syncs / N_FRAMES,
        branch_reads=stats["branch_reads"], host_sync_sites=dict(sync_sites.most_common(8)),
        live_map_points=int(st_f.map.valid.sum()), cloud_count=int(dense_f.cloud_count),
        jax_cpu=SIDE_JAX[name],
        ate_limit_m=side_ate_limit(SIDE_JAX[name]["ate_m"], rgbd=not spec["zero_depth"]),
    )
    print(f"side {name}: " + json.dumps(res), flush=True)
    kernels["radius_match"][f"{name}_launches"] = launches["radius_match"]
    kernels["top2_match"][f"{name}_launches"] = launches["top2_match"]
    kernels["radius_match_batched"][f"{name}_launches"] = launches["radius_match_batched"]
    fails = side_failures(res, SIDE_JAX[name], rgbd=not spec["zero_depth"])
    if launches["radius_match_batched"]:
        fails.append("the batched radius kernel ran on a single-sequence path")
    if fails:
        fail(f"side phase {name}: " + "; ".join(fails))
    return res


def check_depthnet_chunk(config, model, depth_model, main_data, smi_line):
    """DepthNet on one chunk (the first 32 frames of the seed-0 world) on
    the card against the same chunk on the CPU: the f32 net (TF32 off)
    within DN_F32_ATOL, the bf16 net the path runs within DN_LOG_ATOL (with
    the share of cells more than 1e-3 apart), and the depth the bf16 net
    fills in at the card's keypoints of that chunk within DN_LOG_ATOL
    relative. Times the chunk on the card (device time, `time_ms`: log
    depth, and the whole fill with the keypoint samples)."""
    import torch

    from vslam_tpu_torch.core import frontend as fe
    from vslam_tpu_torch.models import depthnet
    from vslam_tpu_torch.models import weights as wmod
    from vslam_tpu_torch.ops.linalg import f32_matmuls

    gray = torch.from_numpy(main_data["gray"][:CHUNK]).to("cuda")
    kps, _ = fe.extract_chunk(model, gray, config)
    with f32_matmuls():
        f32 = [depthnet.predict_log_depth(wmod.load_depthnet(device=where,
                                                             compute_dtype=torch.float32),
                                          gray.to(where)).cpu() for where in ("cuda", "cpu")]
    cpu_model = wmod.load_depthnet(device="cpu")
    logd = depthnet.predict_log_depth(depth_model, gray)
    logd_cpu = depthnet.predict_log_depth(cpu_model, gray.cpu())
    kpd = fe.predicted_keypoint_depth(depth_model, gray, kps.xy)
    kpd_cpu = fe.predicted_keypoint_depth(cpu_model, gray.cpu(), kps.xy.cpu())
    f32_err = float((f32[0] - f32[1]).abs().max())
    diff = (logd.cpu() - logd_cpu).abs()
    log_err = float(diff.max())
    kp_rel = float(((kpd.cpu() - kpd_cpu).abs() / kpd_cpu).max())
    res = dict(frames=CHUNK, log_depth_shape=list(logd.shape), f32_max_abs_err=f32_err,
               log_depth_max_abs_err=log_err,
               log_depth_share_above_1em3=float((diff > 1e-3).float().mean()),
               keypoint_depth_max_rel_err=kp_rel, f32_atol=DN_F32_ATOL, log_atol=DN_LOG_ATOL,
               depth_range_m=[float(kpd.min()), float(kpd.max())],
               log_depth_ms=time_ms(lambda: depthnet.predict_log_depth(depth_model, gray), 11),
               fill_ms=time_ms(lambda: fe.predicted_keypoint_depth(depth_model, gray, kps.xy),
                               11),
               card=smi_line)
    print("depthnet chunk: " + json.dumps(res), flush=True)
    if not (f32_err <= DN_F32_ATOL and log_err <= DN_LOG_ATOL and kp_rel <= DN_LOG_ATOL):
        fail(f"DepthNet on the card differs from the CPU: {res}")
    return res


def resume_mismatches(a, b):
    """Names of the leaves of trees `a` and `b` (NamedTuples of tensors,
    None leaves allowed) that are not equal to the last digit."""
    out = []
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            out += [f"{name}.{m}" for m in resume_mismatches(x, y)]
        elif (x is None) != (y is None) or (
                x is not None and not (x.shape == y.shape and x.dtype == y.dtype
                                       and bool((x.cpu() == y.cpu()).all()))):
            out.append(name)
    return out


def run_outputs(config, model, main_data, st_f, outs, smi_line):
    """A run's outputs, on the main phase's result: RPE (of the trajectory
    aligned to the ground truth's frame); `beautify_cloud`
    of the final sparse map on the card against the same call on the CPU
    (its SOR and surface masks equal, the cloud's count equal, points and
    normals within OUT_ATOL); `fuse_sequence` of the world's depths at the
    smoothed poses (chunks of 48, so the last is padded) against a
    chunk-by-chunk replay with `fuse_chunk_scan` on the CPU (winners,
    counts and points, as the main phase's dense check); a PLY of the
    beautified cloud and one of the fused cloud, a full TUM trajectory,
    each read back; a checkpoint of the state after chunk 2, loaded back
    and tracked through chunks 3-4, equal to the main phase's run to the
    last digit."""
    import tempfile

    import numpy as np
    import torch

    from vslam_tpu_torch.core import coupled, pipeline
    from vslam_tpu_torch.core.state import init_state
    from vslam_tpu_torch.eval import ate as ate_mod
    from vslam_tpu_torch.io import checkpoint, ply, trajectory
    from vslam_tpu_torch.ops import gridhash, pointcloud, se3

    dev = torch.device("cuda")
    c, dn = config.camera, config.dense
    d = main_data
    res = dict(card=smi_line)
    result = pipeline.result_from_outputs(st_f, outs, keep_refine=config.ekf.smooth_keep_refine,
                                          rts_parallel=config.ekf.rts_parallel)
    # RPE compares displacement vectors without aligning the frames (the
    # reference's definition); the run's world is its first camera's, so
    # the trajectory is first put into the ground truth's frame (SE(3)).
    R_a, t_a, _ = ate_mod.align_umeyama(result.t, d["t"], with_scale=False)
    rpe = ate_mod.compute_rpe(d["timestamps"], result.t @ R_a.T + t_a, d["timestamps"], d["t"])
    res.update(rpe_rmse_m=rpe.rmse, rpe_max_m=rpe.max, rpe_pairs=rpe.num_pairs,
               ate_smoothed_m=ate_mod.compute_ate(d["timestamps"], result.t_smoothed,
                                                  d["timestamps"], d["t"],
                                                  with_scale=False).rmse)

    # beautify_cloud of the final sparse map, card and CPU
    pts, valid = st_f.map.pos, st_f.map.valid
    traj = result.t
    n = pts.shape[0]
    masks = {}
    for where in ("cuda", "cpu"):
        p, v = pts.to(where), valid.to(where)
        box = torch.as_tensor(traj, device=where)
        v = v & torch.all((p >= box.min(0).values - 3.0) & (p <= box.max(0).values + 3.0), -1)
        sor = pointcloud.statistical_outlier_removal(p, v, k=min(25, n - 1), std_ratio=0.6)
        surf = pointcloud.surface_aware_filter(p, sor, k=min(25, n - 1), min_anisotropy=0.4)
        masks[where] = (sor.cpu(), surf.cpu())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b_pts, b_nrm = pointcloud.beautify_cloud(pts, valid, traj=traj)
    torch.cuda.synchronize()
    res["beautify_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c_pts, c_nrm = pointcloud.beautify_cloud(pts.cpu(), valid.cpu(), traj=traj)
    res["beautify_cpu_s"] = time.perf_counter() - t0
    mask_mism = sum(int((a != b).sum()) for a, b in zip(masks["cuda"], masks["cpu"]))
    same_n = b_pts.shape == c_pts.shape
    res.update(map_points=int(valid.sum()), sor_kept=int(masks["cuda"][0].sum()),
               surface_kept=int(masks["cuda"][1].sum()), beautified=int(b_pts.shape[0]),
               beautified_cpu=int(c_pts.shape[0]), beautify_mask_mismatches=mask_mism,
               beautify_pts_max_err=(float((b_pts.cpu() - c_pts).abs().max())
                                     if same_n and len(c_pts) else None),
               beautify_normals_max_err=(float((b_nrm.cpu() - c_nrm).abs().max())
                                         if same_n and len(c_pts) else None))

    # fuse_sequence at the smoothed poses against a chunk-by-chunk replay
    depth_m = torch.from_numpy(d["depth_u16"].astype(np.float32) / c.depth_scale)
    R_s = torch.from_numpy(np.asarray(result.R, np.float32))
    t_s = torch.from_numpy(np.asarray(result.t_smoothed, np.float32))
    kw = dict(pixel_step=dn.pixel_step, max_depth=dn.max_depth, voxel_size=dn.voxel_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = gridhash.fuse_sequence(
        gridhash.init_dense_map(dn.hash_capacity, dn.cloud_capacity, device=dev),
        depth_m.to(dev), None, R_s.to(dev), t_s.to(dev), c.fx, c.fy, c.cx, c.cy,
        chunk=FUSE_CHUNK, frames_per_step=dn.fuse_frames_per_insert, **kw)
    torch.cuda.synchronize()
    res["fuse_sequence_s"] = time.perf_counter() - t0
    cpu = gridhash.init_dense_map(dn.hash_capacity, dn.cloud_capacity, device="cpu")
    for k in range(0, N_FRAMES, FUSE_CHUNK):
        dd, RR, tt = depth_m[k:k + FUSE_CHUNK], R_s[k:k + FUSE_CHUNK], t_s[k:k + FUSE_CHUNK]
        pad = FUSE_CHUNK - dd.shape[0]
        dd = torch.cat([dd, torch.zeros((pad,) + dd.shape[1:])])
        RR = torch.cat([RR, torch.eye(3).expand(pad, 3, 3)])
        tt = torch.cat([tt, torch.zeros(pad, 3)])
        cpu = gridhash.fuse_chunk_scan(
            cpu, dd, None, RR, tt, c.fx, c.fy, c.cx, c.cy,
            frames_per_step=math.gcd(FUSE_CHUNK, dn.fuse_frames_per_insert), **kw)
    cd = [x.cpu() for x in card]
    nc = int(cd[3])
    slots = int((cd[0] != cpu.table_winner).sum())
    xyz_err = float((cd[1][:nc] - cpu.cloud_xyz[:nc]).abs().max()) if nc else 0.0
    fuse_mism = slots + int(nc != int(cpu.cloud_count)) + int(int(cd[4]) != int(cpu.insert_epoch))
    fuse_mism += int(xyz_err > 1e-5)
    res.update(fused_points=nc, fuse_slot_mismatches=slots, fuse_xyz_max_err=xyz_err,
               fuse_mismatches=fuse_mism)

    # PLY and trajectory files, read back
    with tempfile.TemporaryDirectory() as tmp:
        p1, p2, p3 = (os.path.join(tmp, f) for f in ("map.ply", "dense.ply", "traj.txt"))
        ply.save_ply(p1, b_pts, normals=b_nrm)
        ply.save_ply(p2, cd[1][:nc], colors=cd[2][:nc])
        trajectory.save_trajectory_full(p3, d["timestamps"], outs.R, outs.t)
        back1, back2 = ply.load_ply(p1), ply.load_ply(p2)
        ts_b, pos_b, q_b = trajectory.load_trajectory(p3)
        res["ply_bytes"] = os.path.getsize(p1) + os.path.getsize(p2)
    R_b = se3.matrix_from_quat(torch.from_numpy(q_b.astype(np.float32))).numpy()
    file_errs = dict(
        ply_map=int(not (np.array_equal(back1["points"], b_pts.cpu().numpy())
                         and np.array_equal(back1["normals"], b_nrm.cpu().numpy()))),
        ply_dense=int(not (np.array_equal(back2["points"], cd[1][:nc].numpy())
                           and np.array_equal(back2["colors"], cd[2][:nc].numpy()))),
        traj=int(not (len(ts_b) == N_FRAMES
                      and np.abs(pos_b - outs.t.cpu().numpy()).max() <= 1e-6
                      and np.abs(R_b - outs.R.cpu().numpy()).max() <= 1e-5)))
    res["file_mismatches"] = file_errs

    # checkpoint after chunk 2, resumed through chunks 3-4
    S, H, W = N_FRAMES // CHUNK, c.height, c.width
    gray = torch.from_numpy(d["gray"].reshape(S, CHUNK, H, W)).to(dev)
    dep = torch.from_numpy(d["depth_u16"].astype(np.int32).reshape(S, CHUNK, H, W)).to(dev)
    ts = torch.from_numpy(d["timestamps"].astype(np.float32).reshape(S, CHUNK)).to(dev)
    fid = torch.arange(N_FRAMES, dtype=torch.int32).reshape(S, CHUNK).to(dev)
    stat = torch.zeros((S, CHUNK), dtype=torch.bool, device=dev)
    dense0 = gridhash.init_dense_map(dn.hash_capacity, dn.cloud_capacity, device=dev)
    h = S // 2  # chunks before the checkpoint: 2 of 4
    st_h, _, _ = coupled.run_coupled(model, init_state(config, device=dev), dense0, gray[:h],
                                     dep[:h], None, ts[:h], fid[:h], stat[:h], config)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        checkpoint.save_state(path, st_h, metadata={"frames": h * CHUNK})
        st_l, meta = checkpoint.load_state(path, config, device=dev)
    saved = resume_mismatches(st_l, st_h)
    st_r, _, outs_r = coupled.run_coupled(model, st_l, dense0, gray[h:], dep[h:], None, ts[h:],
                                          fid[h:], stat[h:], config)
    tail = type(outs)(*(x[h * CHUNK:] for x in outs))
    res.update(checkpoint_meta=meta, checkpoint_load_mismatches=saved,
               resume_state_mismatches=resume_mismatches(st_r, st_f),
               resume_output_mismatches=resume_mismatches(outs_r, tail))
    print("outputs: " + json.dumps(res), flush=True)
    fails = []
    if mask_mism or not same_n:
        fails.append("beautify_cloud's masks or count differ between the card and the CPU")
    elif res["beautify_pts_max_err"] is not None and not (
            res["beautify_pts_max_err"] <= OUT_ATOL
            and res["beautify_normals_max_err"] <= OUT_ATOL):
        fails.append("beautify_cloud's points or normals differ between the card and the CPU")
    if res["beautified"] < 100:
        fails.append(f"beautify_cloud kept {res['beautified']} points")
    if fuse_mism or nc == 0:
        fails.append(f"fuse_sequence differs from its chunk-by-chunk replay ({fuse_mism})")
    if any(file_errs.values()):
        fails.append(f"a written file did not read back: {file_errs}")
    if saved or res["resume_state_mismatches"] or res["resume_output_mismatches"]:
        fails.append("the run resumed from a checkpoint differs from the uninterrupted run")
    if not np.isfinite(rpe.rmse):
        fails.append("RPE is not finite")
    if fails:
        fail("outputs: " + "; ".join(fails))
    return res


# --------------------------------------------------------------------------
# App phase: the TUM application (`vslam_tpu_torch.apps.run_tum`)
# --------------------------------------------------------------------------

APP_FRAMES = 96  # the seed-0 room world, make_room_sequence(num_frames=96, seed=0)
# The JAX app's own CPU run of each mode on that directory (frame step 1,
# default SlamConfig; tests/test_torch_app.py::test_app_full_size_vs_jax
# prints these): ATE of the written trajectory against groundtruth.txt,
# raw (no scale) and sim(3) (the app's own figure); for live, per segment.
APP_JAX = {
    "sp_rgbd": dict(raw=0.00413, sim3=0.002594),
    "cache_ba": dict(raw=0.002328, sim3=0.002165),
    "orb": dict(raw=0.082777, sim3=0.082006),
    "mono_midas": dict(raw=0.211935, sim3=0.029895),
    "live_seg0": dict(raw=0.003204, sim3=0.002489),
    "live_seg1": dict(raw=0.002425, sim3=0.002419),
}
# Tracked fraction floor of every RGB-D app run (the main path's).
APP_MIN_TRACKED = 0.95
# ORB on the card against the CPU: keypoints, validity and scores equal;
# descriptor bits may differ where a keypoint's angle (atan2, cos and sin
# round differently on the card) moves a BRIEF sample across a pixel
# edge: at most ORB_BIT_SHARE of the bits.
ORB_BIT_SHARE = 1e-3
# The card's Poisson mesh against the CPU's from the same points and
# normals (the card's splat adds in no fixed order): vertex and face
# counts within MESH_COUNT_SHARE, and every vertex of either mesh within
# MESH_DIST_FRAC of a grid cell of the other's nearest vertex.
MESH_COUNT_SHARE = 0.01
MESH_DIST_FRAC = 0.5
# MiDaS (random-init, f32, TF32 off) on the card against the CPU: the
# min-max normalised relative depth.
MIDAS_ATOL = 1e-4


def app_ate_limits(run, jax_figures=None):
    """{result key: limit} of an app run's ATEs: `side_ate_limit` of JAX's
    figure (twice JAX's, at least 0.02 m with depth). The mono run is held
    by its sim(3) ATE, live by each segment's sim(3) ATE (the figure the
    app prints), the others by raw and sim(3) ATE."""
    fig = APP_JAX if jax_figures is None else jax_figures
    if run == "live":
        return {f"ate_seg{i}_sim3_m": side_ate_limit(fig[f"live_seg{i}"]["sim3"], True)
                for i in range(2)}
    if run == "mono_midas":
        return {"ate_sim3_m": side_ate_limit(fig[run]["sim3"], False)}
    return {f"ate_{k}_m": side_ate_limit(fig[run][k], True) for k in ("raw", "sim3")}


def app_failures(res, limits, rgbd: bool):
    """The checks of one app run's result dict; returns the failed ones:
    finite poses, each ATE under its limit (`app_ate_limits`), the
    tracked fraction (RGB-D runs), the radius kernel once per tracked
    frame, top-2 once per recovery attempt, the batched kernel never, and
    every file written and read back."""
    out = []
    if not res["poses_finite"]:
        out.append("non-finite poses")
    for key, lim in limits.items():
        if not res[key] <= lim:
            out.append(f"{key} {res[key]:.4f} m > {lim:.4f} m")
    if rgbd and not res["tracked_frac"] >= APP_MIN_TRACKED:
        out.append(f"tracked fraction {res['tracked_frac']:.4f} < {APP_MIN_TRACKED}")
    if res["radius_launches"] != res["track_frames"]:
        out.append(f"radius kernel launched {res['radius_launches']} times for "
                   f"{res['track_frames']} tracked frames")
    if res["top2_launches"] != res["recovery_attempts"]:
        out.append(f"top-2 kernel launched {res['top2_launches']} times for "
                   f"{res['recovery_attempts']} recovery attempts")
    if res["radius_batched_launches"]:
        out.append("the batched radius kernel ran in the app")
    for name, ok in res["files"].items():
        if not ok:
            out.append(f"{name} not written or not read back")
    return out


def mesh_failures(card, cpu, cell):
    """Card mesh against CPU mesh ((verts, faces) each): counts within
    MESH_COUNT_SHARE and the symmetric nearest-vertex distance within
    MESH_DIST_FRAC of the grid cell. Returns (failures, max distance)."""
    from scipy.spatial import cKDTree

    out = []
    for i, what in ((0, "vertex"), (1, "face")):
        a, b = len(card[i]), len(cpu[i])
        if not b or abs(a - b) > MESH_COUNT_SHARE * b:
            out.append(f"{what} count {a} (card) against {b} (CPU)")
    if not len(card[0]) or not len(cpu[0]):
        return out + ["empty mesh"], float("inf")
    dist = max(float(cKDTree(cpu[0]).query(card[0])[0].max()),
               float(cKDTree(card[0]).query(cpu[0])[0].max()))
    if not dist <= MESH_DIST_FRAC * cell:
        out.append(f"nearest-vertex distance {dist:.3g} > {MESH_DIST_FRAC} cell ({cell:.3g})")
    return out, dist


def orb_mismatches(card, cpu):
    """OrbFrontend outputs (xy, score, valid, desc) on the card against
    the CPU: (keypoint mismatches, descriptor bit share that differs)."""
    import numpy as np

    c = [np.asarray(x.cpu()) for x in card]
    h = [np.asarray(x.cpu()) for x in cpu]
    kp = int((c[0] != h[0]).any(-1).sum() + (c[1] != h[1]).sum() + (c[2] != h[2]).sum())
    return kp, float(np.mean(c[3] != h[3]))


def _read_back(out_dir, live_segments=0):
    """Each file an app run writes, read back: {name: ok}."""
    from vslam_tpu_torch.io import ply, trajectory

    names = ([f"estimated_trajectory_seg{i}.txt" for i in range(live_segments)] if live_segments
             else ["estimated_trajectory.txt", "estimated_trajectory_full.txt"])
    ok = {}
    for n in names:
        p = os.path.join(out_dir, n)
        ok[n] = os.path.exists(p) and len(trajectory.load_trajectory(p)[0]) > 0
    if not live_segments:
        p = os.path.join(out_dir, "dense_map.ply")
        ok["dense_map.ply"] = os.path.exists(p) and len(ply.load_ply(p)["points"]) > 0
        p = os.path.join(out_dir, "estimated_map.ply")  # the beautified cloud may be empty
        ok["estimated_map.ply"] = os.path.exists(p) and ply.load_ply(p)["points"].ndim == 2
    p = os.path.join(out_dir, "viewer.html")
    ok["viewer.html"] = os.path.exists(p) and "<title>" in open(p).read(4096)
    return ok


def run_app(name, root, out, argv, gt, dev, kernels, rgbd=True, live_segments=0):
    """One app run through `apps.run_tum.main`, the launch counts set to 0
    just before and read just after; returns its result dict (and the
    runs' RunResults)."""
    import numpy as np
    import torch

    from vslam_tpu_torch.apps import run_tum
    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.core import tracking
    from vslam_tpu_torch.eval import ate as ate_mod
    from vslam_tpu_torch.ops import cuda_matching

    cfg = SlamConfig()
    argv = [root, "--out", out, "--frame-step", "1"] + argv + (
        ["--cpu"] if dev == "cpu" else [])
    cuda_matching.reset_launch_counts()
    tracking.reset_stats()
    if dev != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary, results = run_tum.main(argv)
    if dev != "cpu":
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, stats = dict(cuda_matching.LAUNCHES), dict(tracking.STATS)
    res = dict(run=name, argv=argv[3:], run_s=run_s, summary=summary,
               track_frames=stats["track_frames"], branch_reads=stats["branch_reads"],
               radius_launches=launches["radius_match"], top2_launches=launches["top2_match"],
               radius_batched_launches=launches["radius_match_batched"])
    finite, tracked, attempts = True, [], 0
    for i, r in enumerate(results):
        key = "" if len(results) == 1 else f"_seg{i}"
        finite &= bool(np.isfinite(r.t_smoothed).all() and np.isfinite(r.R).all())
        for kind, scale in (("raw", False), ("sim3", True)):
            res[f"ate{key}_{kind}_m"] = (float(ate_mod.compute_ate(
                r.timestamps, r.t_smoothed, gt[:, 0], gt[:, 1:4], with_scale=scale).rmse)
                if finite else float("inf"))
        o = r.outputs
        tok, nm, rec = (o.tracking_ok.cpu().numpy(), o.num_matches.cpu().numpy(),
                        o.recovered.cpu().numpy())
        tracked.append(tok[1:])
        attempts += recovery_attempts(nm, rec, cfg.frontend.min_matches,
                                      cfg.pnp.recovery_cooldown_frames)
    res.update(poses_finite=finite, tracked_frac=float(np.concatenate(tracked).mean()),
               recovery_attempts=attempts, files=_read_back(out, live_segments))
    kernels["radius_match"][f"app_{name}_launches"] = launches["radius_match"]
    kernels["top2_match"][f"app_{name}_launches"] = launches["top2_match"]
    kernels["radius_match_batched"][f"app_{name}_launches"] = launches["radius_match_batched"]
    return res, results


def check_orb_card_vs_cpu(root, smi_line, n=8):
    """OrbFrontend on the card against the same frontend on the CPU over
    the directory's first `n` decoded frames; times the card's call."""
    import numpy as np
    import torch

    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.core import frontend as fe
    from vslam_tpu_torch.data import loader

    cfg = SlamConfig()
    ld = loader.open_sequence(root)
    grays = np.stack([np.mean(ld.get(i)[0], axis=-1).astype(np.float32) / 255.0
                      for i in range(n)])
    card_fe, cpu_fe = fe.OrbFrontend(cfg, device="cuda"), fe.OrbFrontend(cfg, device="cpu")
    card = card_fe.extract(grays)
    cpu = cpu_fe.extract(grays)
    kp, bits = orb_mismatches(card, cpu)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_fe.extract(grays)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    res = dict(frames=n, card=smi_line, keypoint_mismatches=kp, desc_bit_share=bits,
               valid=int(card[2].sum()), extract_s=host_s,
               extract_device_ms=time_ms(lambda: card_fe.extract(grays), reps=5))
    print("app orb card-vs-cpu: " + json.dumps(res), flush=True)
    if kp or bits > ORB_BIT_SHARE:
        fail(f"ORB on the card differs from the CPU: {kp} keypoint mismatches, "
             f"{bits:.2e} of descriptor bits (limit {ORB_BIT_SHARE})")
    return res


def check_midas(root, smi_line, n=8):
    """MiDaS (random-init parameters, f32 with TF32 off) `estimate_depth`
    on `n` frames at 640x480 on the card against the CPU; times it."""
    import numpy as np
    import torch

    from vslam_tpu_torch.data import loader
    from vslam_tpu_torch.models import midas, weights
    from vslam_tpu_torch.ops.linalg import f32_matmuls

    ld = loader.open_sequence(root)
    img = np.stack([ld.get(i)[0] for i in range(n)]).astype(np.float32) / 255.0
    card_m, src = weights.load_or_init_midas(search_dirs=(), device="cuda",
                                             compute_dtype=torch.float32)
    cpu_m, _ = weights.load_or_init_midas(search_dirs=(), device="cpu",
                                          compute_dtype=torch.float32)
    x = torch.from_numpy(img)
    with f32_matmuls():
        card = midas.estimate_depth(card_m, x.cuda()).cpu()
        cpu = midas.estimate_depth(cpu_m, x)
        ms = time_ms(lambda: midas.estimate_depth(card_m, x.cuda()), reps=5)
    err = float((card - cpu).abs().max())
    res = dict(frames=n, weights=src, card=smi_line, max_abs_err=err, device_ms=ms,
               finite=bool(torch.isfinite(card).all()), shape=list(card.shape))
    print("app midas: " + json.dumps(res), flush=True)
    if not (res["finite"] and err <= MIDAS_ATOL and tuple(card.shape) == (n, 480, 640)):
        fail(f"MiDaS on the card: max error {err:.3g} against the CPU (limit {MIDAS_ATOL})")
    return res


def run_app_phase(kernels, smi_line, dev="cuda", n_frames=APP_FRAMES):
    """The app phase (see the module docstring): the seed-0 room world as
    a TUM directory, then each app run with its checks."""
    import shutil
    import tempfile

    import cv2
    import numpy as np

    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.core import frontend as fe
    from vslam_tpu_torch.data import synthetic, tum
    from vslam_tpu_torch.io import feature_cache

    tmp = tempfile.mkdtemp(prefix="vslam_app_")
    try:
        root = os.path.join(tmp, "room96")
        t0 = time.perf_counter()
        synthetic.write_tum_sequence(root, synthetic.make_room_sequence(num_frames=n_frames,
                                                                        seed=0),
                                     write_cache="sp_cache.npz")
        gt = tum.load_sequence(root).gt
        res = dict(card=smi_line, frames=n_frames, write_s=time.perf_counter() - t0)
        try:
            import matplotlib  # noqa: F401

            res["matplotlib"] = "yes"
        except ImportError:
            res["matplotlib"] = "no"
        print(f"app: import matplotlib: {res['matplotlib']}", flush=True)
        fails = []

        def out_dir(name):
            return os.path.join(tmp, "out_" + name)

        # 1. SuperPoint, RGB-D, writing sp.npz; Poisson on its dense cloud
        sp = os.path.join(tmp, "sp.npz")
        r1, res1 = run_app("sp_rgbd", root, out_dir("sp_rgbd"), ["--cache", sp, "--poisson"],
                           gt, dev, kernels)
        fails += [f"sp_rgbd: {f}" for f in app_failures(r1, app_ate_limits("sp_rgbd"), True)]
        base = res1[0]
        # 2. replays: the npz, the same features as SPCF, and at frame step 2
        xy, score, desc, valid, ids = feature_cache.load_npz(sp)
        spcf = os.path.join(tmp, "sp.bin")
        feature_cache.save_spcf(spcf, feature_cache.from_padded(xy, score, desc, valid,
                                                                frame_ids=ids))
        replays = {}
        for name, cache in (("replay_npz", sp), ("replay_spcf", spcf)):
            r, rr = run_app(name, root, out_dir(name), ["--cache", cache], gt, dev, kernels)
            same = (np.array_equal(rr[0].t_smoothed, base.t_smoothed)
                    and np.array_equal(rr[0].R, base.R))
            replays[name] = dict(equal_to_run1=same, run_s=r["run_s"],
                                 radius_launches=r["radius_launches"],
                                 track_frames=r["track_frames"])
            if not same:
                fails.append(f"{name}: trajectory differs from run 1")
        front = fe.make_frontend(SlamConfig(), device=dev)
        ld_grays = np.zeros((n_frames // 2, 1, 1), np.float32)  # replay reads no pixels
        sub = fe.extract_sequence(front, ld_grays, None, np.zeros(n_frames // 2),
                                  cache_path=sp, frame_indices=np.arange(0, n_frames, 2))
        step2_ok = (np.array_equal(sub.xy.cpu().numpy(), xy[::2])
                    and np.array_equal(sub.desc.cpu().numpy(), desc[::2]))
        r, _ = run_app("replay_step2", root, out_dir("replay_step2"),
                       ["--cache", sp, "--frame-step", "2"], gt, dev, kernels)
        replays["replay_step2"] = dict(rows_by_frame_id=step2_ok, frames=r["summary"]["frames"],
                                       radius_launches=r["radius_launches"],
                                       track_frames=r["track_frames"])
        if not step2_ok or r["summary"]["frames"] != n_frames // 2:
            fails.append("replay at --frame-step 2 did not select the cache rows by frame id")
        if r["radius_launches"] != r["track_frames"]:
            fails.append("replay_step2: radius launches != tracked frames")
        # --render on a replay of run 1: the scene frames read back
        r, _ = run_app("render", root, out_dir("render"), ["--cache", sp, "--render"], gt, dev,
                       kernels)
        viz = os.path.join(out_dir("render"), "viz")
        scenes = sorted(p for p in os.listdir(viz) if p.startswith("frame_"))
        images = [cv2.imread(os.path.join(viz, p)) for p in scenes]
        render = dict(scene_frames=len(scenes), run_s=r["run_s"],
                      hud_frames=len([p for p in os.listdir(viz) if p.startswith("hud_")]),
                      lit_pixels_min=min((render_stats(im)[0] for im in images
                                          if im is not None), default=0),
                      sparse_pixels_min=min((render_stats(im)[1] for im in images
                                             if im is not None), default=0))
        fails += [f"render: {f}" for f in render_failures(n_frames, images)]
        # 3. the synthetic cache with --ba (run_synthetic's flow)
        r3, _ = run_app("cache_ba", root, out_dir("cache_ba"),
                        ["--cache", os.path.join(root, "sp_cache.npz"), "--ba"], gt, dev,
                        kernels)
        fails += [f"cache_ba: {f}" for f in app_failures(r3, app_ate_limits("cache_ba"), True)]
        # 4. ORB: the frontend card vs CPU, then the app
        orb = check_orb_card_vs_cpu(root, smi_line) if dev != "cpu" else None
        r4, _ = run_app("orb", root, out_dir("orb"), ["--orb"], gt, dev, kernels)
        fails += [f"orb: {f}" for f in app_failures(r4, app_ate_limits("orb"), True)]
        # 5. mono with DepthNet (no MiDaS checkpoint is found)
        r5, _ = run_app("mono_midas", root, out_dir("mono_midas"), ["--mono", "--midas"], gt,
                        dev, kernels)
        fails += [f"mono_midas: {f}" for f in app_failures(r5, app_ate_limits("mono_midas"),
                                                             False)]
        # 6. live with a restart
        r6, res6 = run_app("live", root, out_dir("live"), ["--live", "--restart-at",
                                                            str(n_frames // 2)], gt, dev,
                           kernels, live_segments=2)
        r6["inrun_pgo"] = r6["summary"]["inrun_pgo"]
        if r6["summary"]["segments"] != 2 or len(res6) != 2:
            fails.append("live: not two segments")
        fails += [f"live: {f}" for f in app_failures(r6, app_ate_limits("live"), True)]
        # 7. Poisson: run 1's mesh on the card against the CPU's from the
        # same points and the card's normals
        pois = r1["summary"].get("poisson", {})
        if pois.get("branch") != "native":
            fails.append(f"Poisson ran {pois.get('branch')}, not the native solver")
        mesh_res = None
        if dev != "cpu" and pois.get("branch") == "native":
            mesh_res = check_poisson_cpu(out_dir("sp_rgbd"), tmp, fails)
        midas_res = check_midas(root, smi_line) if dev != "cpu" else None

        res.update(runs=[r1, r3, r4, r5, r6], replays=replays, render=render, orb=orb,
                   poisson=pois, poisson_mesh=mesh_res, midas=midas_res)
        print("app: " + json.dumps(res, default=float), flush=True)
        if fails:
            fail("app phase: " + "; ".join(fails))
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_poisson_cpu(card_out, tmp, fails):
    """The card's poisson_mesh.ply (the app's run) against the CPU's mesh
    of the same dense cloud with the same normals: `mesh_failures`; times
    both meshings."""
    import numpy as np
    import torch

    from vslam_tpu_torch.io import ply
    from vslam_tpu_torch.ops import pointcloud as pc
    from vslam_tpu_torch.ops import poisson

    pts = ply.load_ply(os.path.join(card_out, "dense_map.ply"))["points"].astype(np.float32)
    dev = torch.device("cuda")
    pt = torch.from_numpy(pts).to(dev)
    nrm = pc.estimate_normals(pt, torch.ones(len(pts), dtype=torch.bool, device=dev),
                              k=min(16, len(pts) - 1),
                              viewpoint=torch.from_numpy(pts.mean(0)).to(dev)).cpu().numpy()
    out = {}
    for where in ("cuda", "cpu"):
        if where == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh = poisson.poisson_mesh(pts, nrm, resolution=128, trim_frac=0.0, device=where)
        if where == "cuda":
            torch.cuda.synchronize()
        out[where] = (mesh, time.perf_counter() - t0)
    card_file = ply.load_ply(os.path.join(card_out, "poisson_mesh.ply"))
    span = float((pts.max(0) - pts.min(0)).max())
    cell = span * (1 + 2 * 0.15) / 127
    f, dist = mesh_failures(out["cuda"][0], out["cpu"][0], cell)
    res = dict(points=len(pts), verts_card=len(out["cuda"][0][0]),
               faces_card=len(out["cuda"][0][1]), verts_cpu=len(out["cpu"][0][0]),
               faces_cpu=len(out["cpu"][0][1]), app_file_verts=len(card_file["points"]),
               mesh_s_card=out["cuda"][1], mesh_s_cpu=out["cpu"][1], max_vertex_dist=dist,
               cell=cell)
    fails += [f"poisson: {x}" for x in f]
    return res


# --------------------------------------------------------------------------
# Train phase
# --------------------------------------------------------------------------

# The recipes' widths (SuperPoint 120x160, batch 16, a quarter synthetic
# shapes; DepthNet 240x320, batch 8), cut in steps and images to keep the
# phase near two minutes.
TRAIN_SP = dict(steps=200, batch=16, images=128, mix_shapes=0.25, steps_per_scan=50)
TRAIN_DN = dict(steps=100, batch=8, images=32, steps_per_scan=25)
# One training step on the card against the CPU, from the same parameters,
# batch and key, in bf16 as the trainers run: the losses within
# TRAIN_LOSS_RTOL (relative; the devices' bf16 convolutions accumulate in
# other orders), and at most TRAIN_FLIP_SHARE of the parameters updated
# more than half a learning rate apart (Adam's first step moves each
# parameter by about lr in the sign of its gradient, so this is the share
# of gradients whose sign differs). Measured on an H100 80GB HBM3 at 700 W:
# SuperPoint's losses 1.1e-7 (total), 6.9e-7 (det) and 1.05e-5 (desc)
# apart, 0.31% of its parameters; DepthNet's loss 2.3e-7, 0.031%.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_FLIP_SHARE = 0.01
# The JAX package's CPU figures for the same evaluation calls on the
# committed checkpoints (`train_superpoint.evaluate_detector(params,
# n_pairs=8)`, `train_depthnet.evaluate(params)`: 16 images), and how far
# the card's may be from them (bf16 keypoints and depths round otherwise
# in the two frameworks). Measured on the same card: repeatability 3.2e-3
# and match precision 8.1e-5 apart (one match of the ~272 moves precision
# by 3.7e-3); abs_rel 1.6e-7, rmse_log 3.0e-8, delta_1.25 1.3e-5 (one cell
# of 76,800).
EVAL_SP_JAX = {"repeatability": 0.8896104097366333, "match_precision": 0.9779411764705882,
               "matches_per_pair": 34.0, "kps_per_image": 39.625}
EVAL_SP_ATOL = {"repeatability": 0.01, "match_precision": 0.005}
EVAL_DN_JAX = {"abs_rel": 0.12209262698888779, "rmse_log": 0.15228816866874695,
               "delta_1.25": 0.8670182291666667, "n_cells": 76800}
EVAL_DN_ATOL = {"abs_rel": 2e-5, "rmse_log": 2e-5, "delta_1.25": 2e-4}
# `--render`'s scene frames (1024x768): each lights at least
# RENDER_MIN_LIT pixels (the card's frames lit 49,082 or more; the HUD
# text alone lights 9,091) and shows the sparse map's cyan on at least
# RENDER_MIN_SPARSE pixels.
RENDER_MIN_LIT = 20_000
RENDER_MIN_SPARSE = 100
# The round-tripped checkpoint drives `run_coupled` over the main world's
# first frames (one chunk).
ROUNDTRIP_FRAMES = 32


def step_failures(card, cpu, lr, rtol=TRAIN_LOSS_RTOL, flip_share=TRAIN_FLIP_SHARE):
    """One training step on the card against the CPU: `card` and `cpu` map
    "losses" to {name: float} and "delta" to the flat parameter update.
    Returns (failures, share of parameters updated > lr / 2 apart)."""
    import numpy as np

    out = []
    for k, want in cpu["losses"].items():
        got = card["losses"][k]
        if not abs(got - want) <= rtol * abs(want):
            out.append(f"{k} {got:.6g} (card) against {want:.6g} (CPU), rtol {rtol}")
    flips = float(np.mean(np.abs(card["delta"] - cpu["delta"]) > 0.5 * lr))
    if not flips <= flip_share:
        out.append(f"{flips:.4f} of the parameters updated apart (limit {flip_share})")
    return out, flips


def eval_failures(got, want, atol):
    """Each figure of `atol` within its distance of JAX's."""
    return [f"{k} {got[k]:.4f} against JAX's {want[k]:.4f} (limit {atol[k]})"
            for k in atol if not abs(got[k] - want[k]) <= atol[k]]


def loss_falls(losses, steps_per_scan):
    """(first scan's mean loss, last scan's mean loss, whether it fell)."""
    import numpy as np

    h = np.asarray(losses, np.float64).reshape(-1, steps_per_scan)
    first, last = float(h[0].mean()), float(h[-1].mean())
    return first, last, bool(np.isfinite(last) and last < first)


def render_stats(im):
    """(lit pixels, pixels of the sparse map's cyan) of a scene frame as
    cv2 reads it (BGR)."""
    lit = int((im > 0).any(axis=-1).sum())
    cyan = int(((im[..., 0] == 255) & (im[..., 1] == 255) & (im[..., 2] == 0)).sum())
    return lit, cyan


def render_failures(n_frames, images, min_lit=RENDER_MIN_LIT, min_sparse=RENDER_MIN_SPARSE):
    """`--render`'s scene frames read back (`images`: BGR arrays, None
    where a file did not read): ceil(N / every) of them, every = max(N //
    20, 1) as the app picks it, each with at least `min_lit` lit pixels and
    `min_sparse` pixels of the sparse map's colour."""
    every = max(n_frames // 20, 1)
    want = -(-n_frames // every)
    out = [] if len(images) == want else [f"{len(images)} scene frames, not {want}"]
    stats = [None if im is None else render_stats(im) for im in images]
    blank = sum(1 for st in stats if st is None or st[0] < min_lit)
    if blank:
        out.append(f"{blank} blank or unreadable frames (under {min_lit} lit pixels)")
    nomap = sum(1 for st in stats if st is not None and st[1] < min_sparse)
    if nomap:
        out.append(f"{nomap} frames without the sparse map (under {min_sparse} cyan pixels)")
    return out


def _flat_params(model):
    import torch

    return torch.cat([p.detach().float().reshape(-1).cpu() for p in model.parameters()]).numpy()


def train_step_card_vs_cpu(name, make_trainer, params, batch, seed, lr):
    """One `train_step` of `make_trainer(device=...)`'s trainer from
    `params` on `batch` (numpy arrays) with key prng_key(seed), on the card
    and on the CPU; returns (result, failures)."""
    import numpy as np
    import torch

    from vslam_tpu_torch.ops import prng
    from vslam_tpu_torch.ops.device import to_device

    out = {}
    for dev in ("cuda", "cpu"):
        init, step, _ = make_trainer(device=dev)
        st = init(params=params)
        p0 = _flat_params(st.model)
        st, m = step(st, *(torch.from_numpy(a).to(dev) for a in batch),
                     to_device(prng.prng_key(seed), dev))
        losses = {k: float(v) for k, v in (m.items() if isinstance(m, dict) else [("loss", m)])}
        out[dev] = dict(losses=losses, delta=_flat_params(st.model) - p0)
    fails, flips = step_failures(out["cuda"], out["cpu"], lr)
    res = dict(card_losses=out["cuda"]["losses"], cpu_losses=out["cpu"]["losses"],
               max_param_diff=float(np.abs(out["cuda"]["delta"] - out["cpu"]["delta"]).max()),
               flipped_share=flips, loss_rtol=TRAIN_LOSS_RTOL, flip_limit=TRAIN_FLIP_SHARE)
    print(f"train {name} step card-vs-cpu: " + json.dumps(res), flush=True)
    return res, [f"{name} step: {f}" for f in fails]


def _timed_training(run):
    """Run a trainer with a log callback that marks each scan; returns
    (state, history, seconds, seconds of the last scan)."""
    import torch

    marks = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, history = run(lambda msg: marks.append(time.perf_counter()))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    last = marks[-1] - marks[-2] if len(marks) > 1 else total
    return state, history, total, last


def coupled_first_frames(config, model, main_data, n=ROUNDTRIP_FRAMES):
    """`run_coupled` over the main world's first `n` frames (one chunk) with
    `model`, launch counts set to 0 just before; returns (R, t, radius
    launches, tracked frames)."""
    import numpy as np
    import torch

    from vslam_tpu_torch.core import coupled, tracking
    from vslam_tpu_torch.core.state import init_state
    from vslam_tpu_torch.ops import cuda_matching, gridhash

    dev = torch.device("cuda")
    c = config.camera
    gray = torch.from_numpy(main_data["gray"][:n].reshape(1, n, c.height, c.width)).to(dev)
    dep = torch.from_numpy(main_data["depth_u16"][:n].astype(np.int32)
                           .reshape(1, n, c.height, c.width)).to(dev)
    ts = torch.from_numpy(main_data["timestamps"][:n].astype(np.float32).reshape(1, n)).to(dev)
    fid = torch.arange(n, dtype=torch.int32, device=dev).reshape(1, n)
    stat = torch.zeros((1, n), dtype=torch.bool, device=dev)
    dense = gridhash.init_dense_map(config.dense.hash_capacity, config.dense.cloud_capacity,
                                    device=dev)
    cuda_matching.reset_launch_counts()
    tracking.reset_stats()
    _, _, outs = coupled.run_coupled(model, init_state(config, device=dev), dense, gray, dep,
                                     None, ts, fid, stat, config)
    torch.cuda.synchronize()
    return (outs.R.cpu().numpy(), outs.t.cpu().numpy(),
            cuda_matching.LAUNCHES["radius_match"], tracking.STATS["track_frames"])


def run_train_phase(config, model, main_data, kernels, smi_line):
    """The train phase (see the module docstring)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vslam_tpu_torch.models import superpoint, depthnet
    from vslam_tpu_torch.models import train_depthnet as tdn
    from vslam_tpu_torch.models import train_superpoint as tsp
    from vslam_tpu_torch.models import weights as wmod
    from vslam_tpu_torch.utils import flops

    fails = []
    res = dict(card=smi_line)
    # 1. one SuperPoint step, card against CPU, batch of 4 at 120x160
    imgs, corners, cmask = tsp.textured_batch(np.random.default_rng(7), 4, 120, 160)
    res["sp_step"], f = train_step_card_vs_cpu(
        "superpoint", tsp.make_trainer, superpoint.init_params(seed=0), (imgs, corners, cmask),
        5, 1e-3)
    fails += f
    # 2. a short SuperPoint run from random init at the recipe's widths
    sp = TRAIN_SP
    t0 = time.perf_counter()
    data = tsp.render_training_set(sp["images"], 120, 160, seed=0, mix_shapes=sp["mix_shapes"])
    render_s = time.perf_counter() - t0
    state, hist, train_s, last_s = _timed_training(lambda log: tsp.train_textured(
        steps=sp["steps"], batch=sp["batch"], steps_per_scan=sp["steps_per_scan"], seed=0,
        device="cuda", dataset=data, log=log))
    first, last, fell = loss_falls([row[0] for row in hist], sp["steps_per_scan"])
    step_flops = flops.superpoint_train_step_flops(sp["batch"], 120, 160)
    rate = sp["steps"] / train_s
    res["sp_train"] = dict(
        **sp, render_s=render_s, train_s=train_s, steps_per_s=rate, ms_per_step=1e3 / rate,
        last_scan_ms_per_step=1e3 * last_s / sp["steps_per_scan"],
        step_gflop=step_flops / 1e9, tflops=step_flops * rate / 1e12,
        tflops_last_scan=step_flops * sp["steps_per_scan"] / last_s / 1e12,
        peak_share=step_flops * rate / H100_BF16_FLOPS, first_scan_loss=first,
        last_scan_loss=last)
    print("train superpoint: " + json.dumps(res["sp_train"]), flush=True)
    if not fell:
        fails.append(f"superpoint loss did not fall: {first:.4f} -> {last:.4f}")
    # 3. the committed checkpoint's held-out evaluation against JAX's
    committed = wmod.load_superpoint(device="cuda")
    ev = tsp.evaluate_detector(committed, n_pairs=8)
    res["sp_eval"] = dict(card=ev, jax_cpu=EVAL_SP_JAX, atol=EVAL_SP_ATOL)
    print("train superpoint eval: " + json.dumps(res["sp_eval"]), flush=True)
    fails += [f"superpoint eval: {x}" for x in eval_failures(ev, EVAL_SP_JAX, EVAL_SP_ATOL)]
    # 4. checkpoint round trips, then the main path on the round-tripped file
    tmp = tempfile.mkdtemp(prefix="vslam_train_")
    try:
        rt = os.path.join(tmp, "superpoint_roundtrip.npz")
        wmod.save_superpoint_npz(rt, wmod.superpoint_params_from_npz(wmod.TRAINED_SP_NPZ))
        with np.load(rt) as a, np.load(wmod.TRAINED_SP_NPZ) as b:
            file_equal = sorted(a.files) == sorted(b.files) and all(
                a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in b.files)
        trained = os.path.join(tmp, "superpoint_trained.npz")
        wmod.save_superpoint_npz(trained, state.model)
        back = wmod.superpoint_params_from_npz(trained)
        trained_equal = all(torch.equal(back[k], v.detach().cpu().half().float())
                            for k, v in state.model.state_dict().items())
        R0, t0_, l0, n0 = coupled_first_frames(config, model, main_data)
        R1, t1, l1, n1 = coupled_first_frames(config, wmod.load_superpoint(rt, device="cuda"),
                                              main_data)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = bool(np.array_equal(R0, R1) and np.array_equal(t0_, t1))
    res["roundtrip"] = dict(committed_file_equal=file_equal, trained_file_equal=trained_equal,
                            frames=ROUNDTRIP_FRAMES, trajectory_equal=same,
                            radius_launches=l1, track_frames=n1)
    kernels["radius_match"]["train_roundtrip_launches"] = l1
    print("train roundtrip: " + json.dumps(res["roundtrip"]), flush=True)
    if not (file_equal and trained_equal):
        fails.append("a checkpoint did not read back equal")
    if not same:
        fails.append("the round-tripped checkpoint's trajectory differs from the committed one's")
    if not l1 == n1 == n0 == l0 or not n1:
        fails.append(f"round trip: radius launches {l1} for {n1} tracked frames")
    # 5. DepthNet: one step card vs CPU, a short run, the committed net's eval
    gray, logd, valid = tdn.render_dataset(np.random.default_rng(7), 2)
    res["dn_step"], f = train_step_card_vs_cpu(
        "depthnet", tdn.make_trainer, depthnet.init_params(seed=11), (gray, logd, valid), 5,
        2e-3)
    fails += f
    dn = TRAIN_DN
    t0 = time.perf_counter()
    data = tdn.render_dataset(np.random.default_rng(0), dn["images"])
    render_s = time.perf_counter() - t0
    _, hist, train_s, last_s = _timed_training(lambda log: tdn.train(
        steps=dn["steps"], batch=dn["batch"], steps_per_scan=dn["steps_per_scan"], seed=0,
        device="cuda", dataset=data, log=log))
    first, last, fell = loss_falls(hist, dn["steps_per_scan"])
    step_flops = flops.depthnet_train_step_flops(dn["batch"], 240, 320)
    rate = dn["steps"] / train_s
    res["dn_train"] = dict(
        **dn, render_s=render_s, train_s=train_s, steps_per_s=rate, ms_per_step=1e3 / rate,
        last_scan_ms_per_step=1e3 * last_s / dn["steps_per_scan"],
        step_gflop=step_flops / 1e9, tflops=step_flops * rate / 1e12,
        peak_share=step_flops * rate / H100_BF16_FLOPS, first_scan_loss=first,
        last_scan_loss=last)
    print("train depthnet: " + json.dumps(res["dn_train"]), flush=True)
    if not fell:
        fails.append(f"depthnet loss did not fall: {first:.4f} -> {last:.4f}")
    ev = tdn.evaluate(wmod.load_depthnet(device="cuda"))
    res["dn_eval"] = dict(card=ev, jax_cpu=EVAL_DN_JAX, atol=EVAL_DN_ATOL)
    print("train depthnet eval: " + json.dumps(res["dn_eval"]), flush=True)
    fails += [f"depthnet eval: {x}" for x in eval_failures(ev, EVAL_DN_JAX, EVAL_DN_ATOL)]
    if fails:
        fail("train phase: " + "; ".join(fails))
    return res


# --------------------------------------------------------------------------
# Mesh phase
# --------------------------------------------------------------------------

MESH_FRAMES, MESH_CHUNK = 64, 32  # the main world's first 64 frames, chunks of 32
VMAP_FRAMES, VMAP_B = 32, 2  # the within-device forms: worlds of seeds 0 and 1
RUN_BATCH_ARGS = ["--devices", "1", "--frames", "64", "--frame-step", "3"]
# JAX's examples/run_batch.py on the app phase's room directory with
# RUN_BATCH_ARGS on the CPU (tests/test_torch_run_batch.py::
# test_run_batch_full_size_vs_jax prints it).
RUN_BATCH_JAX = 0.020734
BENCH_ARGS = ["--n", "16", "--b", "4", "--bs", "1,2,4"]
FMA_SAMPLES = 1 << 20
SOLVE_SAMPLES = 8192


def run_batch_ate_limit(jax_ate_m: float = None) -> float:
    """`run_batch`'s ATE limit on the room directory: twice JAX's CPU
    figure, at least 0.02 m (the main path's)."""
    return max(2 * (RUN_BATCH_JAX if jax_ate_m is None else jax_ate_m), 0.02)


def tree_mismatches(got, want) -> list:
    """Leaf positions (in `to_numpy` order) where two trees differ in any
    bit; empty when equal to the last digit."""
    import numpy as np

    from vslam_tpu_torch.core.state import to_numpy

    def leaves(t):
        if isinstance(t, tuple):
            return [x for v in t for x in leaves(v)]
        return [t]

    a, b = leaves(to_numpy(got)), leaves(to_numpy(want))
    if len(a) != len(b):
        return ["structure"]
    def bits(x):
        x = np.ascontiguousarray(x).reshape(-1)
        return x.view(np.uint8) if x.dtype.kind == "f" else x

    return [i for i, (x, y) in enumerate(zip(a, b))
            if x is not None and (x.shape != y.shape or not np.array_equal(bits(x), bits(y)))]


def rounding_mismatches(dev="cuda", n=FMA_SAMPLES, m=SOLVE_SAMPLES, seed=0) -> dict:
    """Bits that differ: `ops.device.fma` and `fms` on `dev` against their
    f64 emulation (product and sum in f64, rounded once to f32),
    `device.sqrt` against the f64 square root rounded once, and
    `ops.libm`'s sincos and atan2f on `dev` against the CPU's, over n
    random inputs each; and the minimal solves that run through them
    (`linalg.svd3x3`, `kabsch`, the eight-point and DLT solves, a
    Cholesky solve) on `dev` against the CPU's, over m random problems
    each."""
    import torch

    from vslam_tpu_torch.ops import device, epipolar, kabsch, libm, linalg, pnp

    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x.view(torch.int64)

    def differ(got, want):
        return int((bits(got.cpu()) != bits(want)).sum())

    a, b, c = rnd(n, scale=10), rnd(n, scale=10), rnd(n, scale=10)
    a64, b64, c64 = a.double(), b.double(), c.double()
    # Every non-negative finite float32 is as likely (denormals included).
    pos = torch.randint(0, 0x7F800000, (n,), generator=g, dtype=torch.int32).view(torch.float32)
    out = {"fma": differ(device.fma(a.to(dev), b.to(dev), c.to(dev)),
                         (a64 * b64 + c64).float()),
           "fms": differ(device.fms(a.to(dev), b.to(dev), c.to(dev)),
                         (c64 - a64 * b64).float()),
           "sqrt": differ(device.sqrt(pos.to(dev)), torch.sqrt(pos.double()).float())}
    ang, A = rnd(n, scale=2.0), rnd(m, 3, 3)
    M = torch.cat([A[: m // 2], A[m // 2:] @ A[m // 2:].transpose(-1, -2)])
    uv1 = torch.rand(m, 8, 2, generator=g) * 640
    uv2 = uv1 + rnd(m, 8, 2, scale=5.0)
    X, xn = rnd(m, 6, 3) + 6.0, rnd(m, 6, 2, scale=0.3)
    H = A @ A.transpose(-1, -2) + torch.eye(3)
    cases = {
        "sincos": (lambda x: libm.sincos(x), (ang,)),
        "atan2f": (lambda y, x: libm.atan2f(y, x), (ang, rnd(n))),
        "eigh3x3": (linalg.eigh3x3, (M[m // 2:],)),
        "svd3x3": (linalg.svd3x3, (M,)),
        "kabsch": (lambda s, d: kabsch.kabsch(s, d)[:2], (A, A + rnd(m, 3, 3, scale=0.1))),
        "eight_point": (lambda p, q: epipolar.eight_point(p, q), (uv1, uv2)),
        "dlt_pose": (pnp._dlt_pose, (X, xn)),
        "cholesky_solve": (linalg.cholesky_solve_small, (H, rnd(m, 3))),
    }
    for name, (fn, args) in cases.items():
        want, got = fn(*args), fn(*(x.to(dev) for x in args))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        out[name] = sum(differ(x, y) for x, y in zip(got, want))
    return out


def chunk_features(config, model, gray, dep, ts, fid, n, chunk, dev):
    """The frontend's features of frames [0, n) of a world (numpy (N, H, W)
    gray / depth, (N,) timestamps), chunk by chunk as `run_coupled` runs
    it; one FrameFeatures with (n, ...) leaves."""
    import numpy as np
    import torch

    from vslam_tpu_torch.core import frontend as fe
    from vslam_tpu_torch.core.state import FrameFeatures

    parts = []
    for s in range(0, n, chunk):
        sl = slice(s, s + chunk)
        parts.append(fe.frontend_features(
            model, torch.from_numpy(gray[sl]).to(dev),
            torch.from_numpy(dep[sl].astype(np.int32)).to(dev),
            torch.from_numpy(ts[sl].astype(np.float32)).to(dev),
            torch.from_numpy(fid[sl]).to(dev), torch.zeros(chunk, dtype=torch.bool, device=dev),
            config))
    return FrameFeatures(*(torch.cat(f) for f in zip(*parts)))


def run_mesh_phase(config, model, main_data, worlds, kernels, smi_line, dev="cuda"):
    """The mesh phase (see the module docstring). `worlds` are the multi
    phase's worlds (seed 0 first). Fails the run on any mismatch."""
    import tempfile

    import numpy as np
    import torch

    from vslam_tpu_torch.apps import bench_batched_step, run_batch
    from vslam_tpu_torch.core import coupled, tracking, tracking_batched
    from vslam_tpu_torch.core.state import init_state, member, stack_trees
    from vslam_tpu_torch.data import loader as loader_mod, synthetic
    from vslam_tpu_torch.ops import cuda_matching, gridhash
    from vslam_tpu_torch.parallel import mesh as pm

    dev = torch.device(dev)
    res, fails = dict(card=smi_line), []
    n, C = MESH_FRAMES, MESH_CHUNK
    fid = np.arange(N_FRAMES, dtype=np.int32)

    def counted(fn):
        """fn() with the parent's launch and tracking counts set to 0 just
        before and read just after."""
        cuda_matching.reset_launch_counts()
        tracking.reset_stats()
        tracking_batched.reset_stats()
        out = fn()
        return out, dict(cuda_matching.LAUNCHES), dict(tracking.STATS), dict(
            tracking_batched.STATS)

    def worker_rule(name, stats):
        ln, st = stats["launches"], stats["tracking"]
        if dev.type == "cuda" and ln["radius_match"] != st["track_frames"]:
            fails.append(f"{name}: the worker launched the radius kernel {ln['radius_match']} "
                         f"times for {st['track_frames']} tracked frames")

    # 1. the mesh: one card, and more cards than there are raises
    t0 = time.perf_counter()
    mesh_dev = "cpu" if dev.type == "cpu" else "cuda"
    m = pm.make_mesh(1, device=mesh_dev)
    res["mesh"] = repr(m)
    if dev.type == "cuda":
        try:
            pm.make_mesh(torch.cuda.device_count() + 1)
            fails.append("make_mesh accepted more devices than the machine has")
        except ValueError:
            pass

    # 2. sharded_tracking_scan against the parent's run_frames
    g, dp, ts = main_data["gray"], main_data["depth_u16"], main_data["timestamps"]
    frames = chunk_features(config, model, g, dp, ts, fid, n, C, dev)
    ids = fid[:n].tolist()
    (st_p, out_p), ln_p, stats_p, _ = counted(
        lambda: tracking.run_frames(init_state(config, device=dev), frames, ids, config))
    (st_s, out_s), _, _, _ = counted(lambda: pm.sharded_tracking_scan(
        pm.replicate_state(config, 1, device=dev), stack_trees([frames]), config, m))
    w = m.stats[0]
    res["sharded_track"] = dict(worker=w, parent_launches=ln_p, parent_tracked=stats_p[
        "track_frames"])
    bad = tree_mismatches(member(out_s, 0), out_p) + tree_mismatches(
        member(st_s, 0), st_p)
    if bad:
        fails.append(f"sharded_tracking_scan differs from run_frames at leaves {bad[:8]}")
    worker_rule("sharded_tracking_scan", w)
    kernels["radius_match"]["mesh_track_launches"] = w["launches"]["radius_match"]

    # 3. sharded_coupled_run against run_coupled over the same two chunks
    S = n // C
    H, W = config.camera.height, config.camera.width
    x = dict(gray=torch.from_numpy(g[:n].reshape(S, C, H, W)),
             dep=torch.from_numpy(dp[:n].astype(np.int32).reshape(S, C, H, W)),
             ts=torch.from_numpy(ts[:n].astype(np.float32).reshape(S, C)),
             fid=torch.from_numpy(fid[:n].reshape(S, C)),
             stat=torch.zeros((S, C), dtype=torch.bool))
    dense0 = gridhash.init_dense_map(config.dense.hash_capacity, config.dense.cloud_capacity,
                                     device=dev)
    (st_c, dn_c, out_c), _, _, _ = counted(lambda: coupled.run_coupled(
        model, init_state(config, device=dev), dense0, x["gray"], x["dep"], None, x["ts"],
        x["fid"], x["stat"], config, device=dev))
    (st_m, dn_m, out_m), _, _, _ = counted(lambda: pm.sharded_coupled_run(
        model, pm.replicate_state(config, 1, device=dev), stack_trees([dense0]),
        x["gray"][None], x["dep"][None], None, x["ts"][None], x["fid"][None],
        x["stat"][None], config, m))
    w = m.stats[0]
    res["sharded_coupled"] = dict(worker=w, cloud_count=int(dn_m.cloud_count[0]))
    for what, a, b in (("state", member(st_m, 0), st_c), ("dense map", member(dn_m, 0),
                                                             dn_c),
                       ("outputs", member(out_m, 0), out_c)):
        bad = tree_mismatches(a, b)
        if bad:
            fails.append(f"sharded_coupled_run's {what} differs from run_coupled at leaves "
                         f"{bad[:8]}")
    worker_rule("sharded_coupled_run", w)
    kernels["radius_match"]["mesh_coupled_launches"] = w["launches"]["radius_match"]
    kernels["top2_match"]["mesh_launches"] = w["launches"]["top2_match"]

    # 4. batched_diagnostics through the collective against the host
    diag = pm.batched_diagnostics(out_m, m)
    o = {k: getattr(out_m, k).cpu().numpy() for k in ("num_matches", "num_inliers",
                                                      "is_keyframe", "tracking_ok")}
    inv = np.float32(1) / np.float32(o["num_matches"].size)
    host = {"mean_matches": np.float32(o["num_matches"].sum()) * inv,
            "mean_inliers": np.float32(o["num_inliers"].sum()) * inv,
            "keyframes": np.int32(o["is_keyframe"].sum()),
            "tracked_frac": np.float32(o["tracking_ok"].sum()) * inv}
    res["diagnostics"] = {k: float(v) for k, v in diag.items()}
    if any(diag[k].numpy() != host[k] for k in host):
        fails.append(f"batched_diagnostics {res['diagnostics']} != host {host}")
    m.close()
    res["mesh_s"] = time.perf_counter() - t0

    # 5. the within-device forms at B 2 against each member's solo run
    t0 = time.perf_counter()
    fr2 = [chunk_features(config, model, wd["gray"], wd["depth_u16"], wd["timestamps"], fid,
                          VMAP_FRAMES, VMAP_FRAMES, dev) for wd in worlds[:VMAP_B]]
    solo = [tracking.run_frames(init_state(config, device=dev), f, fid[:VMAP_FRAMES].tolist(),
                                config) for f in fr2]
    (_, out_v), ln_v, st_v, _ = counted(lambda: pm.vmapped_tracking_scan(
        pm.replicate_state(config, VMAP_B, device=dev), stack_trees(fr2), config))
    (_, out_b), ln_b, _, tb_b = counted(lambda: pm.batched_tracking_scan(
        pm.replicate_state(config, VMAP_B, device=dev), stack_trees(fr2), config))
    for name, outs in (("vmapped", out_v), ("batched", out_b)):
        for b in range(VMAP_B):
            bad = tree_mismatches(member(outs, b), solo[b][1])
            if bad:
                fails.append(f"{name}_tracking_scan member {b} differs from its solo run at "
                             f"leaves {bad[:8]}")
    res["within_device"] = dict(vmapped_launches=ln_v, vmapped_tracked=st_v["track_frames"],
                                batched_launches=ln_b, batched_steps=tb_b["track_steps"],
                                seconds=time.perf_counter() - t0)
    if dev.type == "cuda":
        if ln_v["radius_match"] != st_v["track_frames"] or ln_v["radius_match_batched"]:
            fails.append(f"vmapped: launches {ln_v} for {st_v['track_frames']} tracked frames")
        if ln_b["radius_match_batched"] != tb_b["track_steps"] or ln_b["radius_match"]:
            fails.append(f"batched: launches {ln_b} for {tb_b['track_steps']} tracked steps")
    kernels["radius_match"]["mesh_vmapped_launches"] = ln_v["radius_match"]
    kernels["radius_match_batched"]["mesh_batched_launches"] = ln_b["radius_match_batched"]

    # 6.-7. run_batch and the loaders on the app phase's room directory
    tmp = tempfile.mkdtemp(prefix="vslam_mesh_")
    root = os.path.join(tmp, "room96")
    t0 = time.perf_counter()
    synthetic.write_tum_sequence(root, synthetic.make_room_sequence(num_frames=APP_FRAMES,
                                                                    seed=0))
    res["write_s"] = time.perf_counter() - t0
    cpu = ["--cpu"] if dev.type == "cpu" else []
    for name, argv in (("room96", [root] + RUN_BATCH_ARGS + cpu),
                       ("synthetic", RUN_BATCH_ARGS + cpu)):
        t0 = time.perf_counter()
        rb = run_batch.main(argv)
        w = rb["rank_stats"][0]
        res[f"run_batch_{name}"] = dict(frames_per_s=rb["frames_per_s"],
                                        ate_rmse_m=rb["ate_rmse_m"], worker=w,
                                        seconds=time.perf_counter() - t0)
        worker_rule(f"run_batch {name}", w)
        ates = list(rb["ate_rmse_m"].values())
        if len(ates) != 1 or not np.isfinite(ates[0]):
            fails.append(f"run_batch {name}: ATE {rb['ate_rmse_m']}")
        kernels["radius_match"][f"run_batch_{name}_launches"] = w["launches"]["radius_match"]
    if not res["run_batch_room96"]["ate_rmse_m"]["room96"] <= run_batch_ate_limit():
        fails.append(f"run_batch ATE {res['run_batch_room96']['ate_rmse_m']} above "
                     f"{run_batch_ate_limit():.4f} m")
    c = config.camera
    lds = {"native": loader_mod.open_sequence(root, width=c.width, height=c.height),
           "python": loader_mod.open_sequence(root, prefer_native=False, width=c.width,
                                              height=c.height)}
    got = {}
    for name, ld in lds.items():
        t0 = time.perf_counter()
        got[name] = list(ld.frames())
        res[f"loader_{name}_fps"] = len(got[name]) / (time.perf_counter() - t0)
        ld.close()
    bad = [i for i, (a, b) in enumerate(zip(got["native"], got["python"]))
           if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2] == b[2])]
    if bad or len(got["native"]) != APP_FRAMES:
        fails.append(f"the loaders differ on frames {bad[:8]} ({len(got['native'])} frames)")
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)

    # 8. the batched step's per-component split
    t0 = time.perf_counter()
    bench, ln_bench, _, _ = counted(lambda: bench_batched_step.run(
        bench_batched_step.parse_args(BENCH_ARGS + cpu), config))
    res["bench_s"] = time.perf_counter() - t0
    print("bench_batched_step: " + json.dumps(bench), flush=True)
    kernels["radius_match_batched"]["bench_launches"] = ln_bench["radius_match_batched"]

    # 9. fma / fms and the minimal solves on the card, bitwise
    res["rounding_mismatches"] = rounding_mismatches(dev)
    if any(res["rounding_mismatches"].values()):
        fails.append(f"fma / fms or the minimal solves differ in bits from their "
                     f"references: {res['rounding_mismatches']}")
    print("mesh: " + json.dumps(res), flush=True)
    if fails:
        fail("mesh: " + "; ".join(fails))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also split the main path's time and trace one chunk")
    ap.add_argument("--long", action="store_true",
                    help="also run the loop path on the long stress world (2,560 frames)")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(ROOT, "vslam_tpu_torch")):
        print("FAIL: chip_smoke.py must run from a checkout of the repository "
              "(vslam_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "unknown"
    print(smi_line, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.core.state import member
    from vslam_tpu_torch.ops import cuda_matching

    phases = {}
    t0 = time.perf_counter()
    cuda_matching.build(force=True)
    build_s = phases["build"] = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s", flush=True)
    with open(os.path.join(cuda_matching.BUILD_DIR, "ptxas.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("ptxas: " + line.strip(), flush=True)

    config = SlamConfig()
    t0 = time.perf_counter()
    kernels = check_kernels(config)
    phases["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    main_res, st_f, main_outs, main_data, model, trace_main = run_main_path(
        config, args.profile)
    kernels["radius_match"]["launches"] = main_res["launches"]["radius_match"]
    # Each radius kernel on its path's own input: the final state's map at
    # its final pose against the last frame's keypoints.
    check_path_radius(config, kernels["radius_match"], [path_radius_inputs(
        config, st_f, frame_features(config, model, main_data["gray"][-1],
                                     main_data["depth_u16"][-1]))], batched=False)
    phases["main"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    multi_res, st_m, worlds, trace_multi = run_multi_path(
        config, model, main_data, main_outs, args.profile)
    kernels["radius_match_batched"]["launches"] = multi_res["launches"]["radius_match_batched"]
    check_path_radius(config, kernels["radius_match_batched"], [path_radius_inputs(
        config, member(st_m, b), frame_features(config, model, w["gray"][-1],
                                                w["depth_u16"][-1]))
        for b, w in enumerate(worlds)], batched=True)
    phases["multi"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_recovery(config, st_f, main_data["gray"][-1], main_data["depth_u16"][-1],
                 kernels["top2_match"])
    phases["recovery"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_outputs(config, model, main_data, st_f, main_outs, smi_line)
    phases["outputs"] = time.perf_counter() - t0
    depth_model = None
    for name in SIDE_WORLDS:
        t0 = time.perf_counter()
        if SIDE_WORLDS[name]["depthnet"] and depth_model is None:
            from vslam_tpu_torch.models import weights as wmod

            depth_model = wmod.load_depthnet(device="cuda")
            check_depthnet_chunk(config.replace(rgbd=False), model, depth_model, main_data,
                                 smi_line)
        run_side_path(config, model, name, main_data, kernels,
                      depth_model if SIDE_WORLDS[name]["depthnet"] else None)
        phases[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    check_loop(run_loop_path(config, model, "s101_l1", kernels))
    phases["loop"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_app_phase(kernels, smi_line)
    phases["app"] = time.perf_counter() - t0
    print(f"app: {phases['app']:.1f} s", flush=True)
    t0 = time.perf_counter()
    run_train_phase(config, model, main_data, kernels, smi_line)
    phases["train"] = time.perf_counter() - t0
    print(f"train: {phases['train']:.1f} s", flush=True)
    t0 = time.perf_counter()
    run_mesh_phase(config, model, main_data, worlds, kernels, smi_line)
    phases["mesh"] = time.perf_counter() - t0
    print(f"mesh: {phases['mesh']:.1f} s", flush=True)
    if args.long:
        t0 = time.perf_counter()
        check_loop(run_loop_path(config, model, "s202_l2.5", kernels), jax_figures=None)
        phases["loop_long"] = time.perf_counter() - t0
    print("phases_s: " + json.dumps(phases), flush=True)
    for trace in (trace_main, trace_multi):  # --profile: after every timed run
        if trace is not None:
            trace()

    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
