#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`vslam_tpu_torch`) on one GPU.

    python3 chip_smoke.py              # all phases (what a checkout is held to)
    python3 chip_smoke.py --profile    # + where the main path's time goes

Phases, each failing the run on any error:
  1. build   — compile `vslam_tpu_torch/csrc/matching.cu` with nvcc
               (sm_90a) into `vslam_tpu_torch/_build/`.
  2. kernels — hold each CUDA kernel against its plain PyTorch version on
               the card at the main path's shapes (K=400 keypoints,
               M=16384 map rows, D=256 bf16), plus ties, all-invalid and
               M=16383; time kernel, plain version and the bf16 matmul
               alone as a yardstick.
  3. main    — render 128 frames of the seed-0 synthetic room with the
               port's own renderer, run `run_coupled` with the default
               `SlamConfig` and the committed SuperPoint checkpoint
               (warm-up; a run under PyTorch's CUDA sync debug mode that
               counts every operation that makes the host wait for the
               card; then the timed run), check pose finiteness, raw ATE,
               tracked fraction, keyframe count and radius-kernel launches.
  4. recovery — call the tracking-loss recovery on the final state; the
               top-2 kernel must launch once and agree with its plain
               version.

Prints the card's name and power limit, one JSON line of per-kernel
results, one JSON line of main-path results, and as the last line
{"ok": true, "device": {...}}. Exits non-zero (printing no result line)
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
N_FRAMES, CHUNK = 128, 32  # the main path: 128 frames in chunks of 32

H100_BF16_FLOPS = 989e12  # dense tensor-core bf16, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
# No single PyTorch call computes either matcher, so `library_ms` is null;
# the bf16 distance product alone is timed beside each kernel as a
# yardstick (`matmul_ms`). The port never calls it.
MATMUL_CALL = "torch.matmul bf16 (M,D)x(D,K) alone"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(nbytes: int, flops: int):
    tb = nbytes / H100_BYTES_PER_S
    tf = flops / H100_BF16_FLOPS
    return max(tb, tf) * 1e3, ("operations" if tf >= tb else "bytes")


def time_ms(fn, reps: int = 25) -> float:
    """Median of per-call CUDA-event times (ms) after two warm-up calls."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


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
    rows = rng.choice(M, near, replace=False)
    # Half the queries sit near map projections with near-copy descriptors.
    db[rows] = np.clip(q[:near] + rng.integers(-1, 2, (near, D)) / 256.0, -66 / 256, 66 / 256)
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
    dev = "cuda"
    return (
        torch.tensor(q, dtype=torch.bfloat16, device=dev),
        torch.tensor(uv_q, dtype=torch.float32, device=dev),
        torch.tensor(vq, device=dev),
        torch.tensor(db, dtype=torch.bfloat16, device=dev),
        torch.tensor(uv_db, dtype=torch.float32, device=dev),
        torch.tensor(vdb, device=dev),
    )


def check_kernels(config):
    """Holds both kernels against their plain versions; returns the
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
    mism, err = 0, 0.0
    timed_inputs = None
    with f32_matmuls():
        for case, m in (("structured", M), ("ties", M), ("all_invalid", M), ("odd_m", M - 1)):
            args = _radius_inputs(rng, K, m, D, case)
            if case == "structured":
                timed_inputs = args
            got = cuda_matching.radius_match(*args, radius_px=radius, desc_thresh=thresh)
            ref = matching.radius_descriptor_match_fused_plain(*args, radius, thresh)
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
            mism += n_bad
            err = max(err, derr)
            print(f"radius_match[{case}]: M={m} matched={int(ok.sum())} mismatches={n_bad} "
                  f"max_dist_err={derr:.3g}", flush=True)
            if case == "structured" and int(ok.sum()) < K // 4:
                fail("radius check input produced too few matches")
        q, uvq, vq, db, uvdb, vdb = timed_inputs
        cuda_matching.reset_launch_counts()
        k_ms = time_ms(lambda: cuda_matching.radius_match(
            q, uvq, vq, db, uvdb, vdb, radius_px=radius, desc_thresh=thresh))
        p_ms = time_ms(lambda: matching.radius_descriptor_match_fused_plain(
            q, uvq, vq, db, uvdb, vdb, radius, thresh))
        mm_ms = time_ms(lambda: torch.matmul(db, q.T))
    nbytes = (K * D * 2 + K * 8 + K + M * D * 2 + M * 8 + M) + (K * 4 + K + K * 4 + M * 4)
    b_ms, b_by = bound(nbytes, 2 * M * K * D)
    results["radius_match"] = dict(
        name="radius_match", route="cuda", source="vslam_tpu_torch/csrc/matching.cu",
        replaces="vslam_tpu/ops/pallas_matching.py:218", path="main",
        ok=mism == 0, mismatches=mism, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, matmul_ms=mm_ms,
        matmul_call=MATMUL_CALL, shapes=f"K={K} M={M} D={D} bf16",
    )

    # ---- top-2 match ----
    mism, err = 0, 0.0
    with f32_matmuls():
        for case, m in (("structured", M), ("ties", M), ("all_invalid", M), ("odd_m", M - 1)):
            q, _, vq, db, _, vdb = _radius_inputs(rng, K, m, D, case)
            if case == "structured":
                timed_inputs = (db, vdb, q)
            got = cuda_matching.top2_match(db, vdb, q)
            ref = matching.top2_match_plain(db, vdb, q)
            torch.cuda.synchronize()
            g = [x.cpu().numpy() for x in got]
            r = [x.cpu().numpy() for x in ref]
            has = r[0] < 0.5e9  # some valid db row (plain gives idx 0, kernel -1 otherwise)
            derr = float(max(np.abs(g[0] - r[0]).max(), np.abs(g[1] - r[1]).max()))
            n_bad = int((g[2][has] != r[2][has]).sum()) + int((g[2][~has] != -1).sum())
            if derr > 1e-4:
                n_bad += 1
            mism += n_bad
            err = max(err, derr)
            print(f"top2_match[{case}]: M={m} mismatches={n_bad} max_err={derr:.3g}", flush=True)
        db, vdb, q = timed_inputs
        k_ms = time_ms(lambda: cuda_matching.top2_match(db, vdb, q))
        p_ms = time_ms(lambda: matching.top2_match_plain(db, vdb, q))
        mm_ms = time_ms(lambda: torch.matmul(db, q.T))
    nbytes = (M * D * 2 + M + K * D * 2) + 3 * K * 4
    b_ms, b_by = bound(nbytes, 2 * M * K * D)
    results["top2_match"] = dict(
        name="top2_match", route="cuda", source="vslam_tpu_torch/csrc/matching.cu",
        replaces="vslam_tpu/ops/pallas_matching.py:93", path="recovery",
        ok=mism == 0, mismatches=mism, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, matmul_ms=mm_ms,
        matmul_call=MATMUL_CALL, shapes=f"Kq={K} M={M} D={D} bf16",
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
    from vslam_tpu_torch.ops import cuda_matching

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

    def run():
        return coupled.run_coupled(model, st0, None, gray, dep, None, ts, fid, stat, config)

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
    st_f, _, outs = run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(cuda_matching.LAUNCHES)
    stats = dict(tracking.STATS)

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
        launches=launches,
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
    if profile:
        profile_main_path(config, model, st0, gray, dep, ts, fid, stat)
    return res, st_f, (gray, dep)


def profile_main_path(config, model, st0, gray, dep, ts, fid, stat):
    """Where the time goes (--profile): the host-clock split of one more
    run between the frontend and the tracking loop, then a torch.profiler
    trace of the second chunk: device-busy share of the wall time, kernel
    launches per frame and the kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vslam_tpu_torch.core import frontend as fe
    from vslam_tpu_torch.core import tracking
    from vslam_tpu_torch.core.state import clone_tree

    ids = fid.cpu().tolist()

    def chunk(st, s):
        frames = fe.frontend_features(model, gray[s], dep[s], ts[s], fid[s], stat[s], config)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st, _ = tracking.run_frames(st, frames, ids[s], config)
        torch.cuda.synchronize()
        return st, t1

    st = clone_tree(st0)
    fe_s = tr_s = 0.0
    for s in range(gray.shape[0]):
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
    n_frames = gray.shape[1]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    res = dict(
        frontend_s=fe_s, tracking_s=tr_s, profiled_frames=n_frames,
        profiled_wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
        device_idle_share=1.0 - busy / wall_us,
        kernel_launches_per_frame=len(kernels) / n_frames,
        top_kernels=[dict(name=k[:80], launches=v[0], device_ms=v[1] / 1e3) for k, v in top],
    )
    print("profile: " + json.dumps(res), flush=True)
    if not kernels:
        fail("the profiler recorded no device kernel on the main path")


def run_recovery(config, model_state, frame_gray, frame_dep):
    """Tracking-loss recovery on the final state against one frame of the
    run: the top-2 kernel launches once and agrees with its plain version."""
    import numpy as np
    import torch

    from vslam_tpu_torch.core import frontend as fe
    from vslam_tpu_torch.core import tracking
    from vslam_tpu_torch.models import weights as wmod
    from vslam_tpu_torch.ops import cuda_matching, matching, prng

    dev = torch.device("cuda")
    model = wmod.load_superpoint(wmod.TRAINED_SP_NPZ, device=dev)
    frames = fe.frontend_features(
        model, frame_gray[None], frame_dep[None],
        torch.zeros(1, device=dev), torch.zeros(1, dtype=torch.int32, device=dev),
        torch.zeros(1, dtype=torch.bool, device=dev), config,
    )
    frame = tracking.frame_at(frames, 0)
    frame = frame._replace(desc=frame.desc.to(torch.bfloat16))
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
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also split the main path's time and trace one chunk")
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
    from vslam_tpu_torch.ops import cuda_matching

    t0 = time.perf_counter()
    cuda_matching.build(force=True)
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s", flush=True)
    with open(os.path.join(cuda_matching.BUILD_DIR, "ptxas.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("ptxas: " + line.strip(), flush=True)

    config = SlamConfig()
    kernels = check_kernels(config)
    main_res, st_f, (gray, dep) = run_main_path(config, args.profile)
    kernels["radius_match"]["launches"] = main_res["launches"]["radius_match"]
    rec = run_recovery(config, st_f, gray[-1, -1], dep[-1, -1])
    kernels["top2_match"]["launches"] = rec["top2_launches"]

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
