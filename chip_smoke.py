#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`vslam_tpu_torch`) on one GPU.

    python3 chip_smoke.py              # all phases (what a checkout is held to)
    python3 chip_smoke.py --profile    # + where the main path's time goes

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

Prints the card's name and power limit, one JSON line of per-kernel
results, one JSON line each of main-path and multi-path results, and as
the last line {"ok": true, "device": {...}}. Exits non-zero (printing no
result line) without a CUDA device or outside a checkout of the
repository.
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
    from vslam_tpu_torch.core.state import member
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
    main_res, st_f, main_outs, main_data, model, trace_main = run_main_path(
        config, args.profile)
    kernels["radius_match"]["launches"] = main_res["launches"]["radius_match"]
    # Each radius kernel on its path's own input: the final state's map at
    # its final pose against the last frame's keypoints.
    check_path_radius(config, kernels["radius_match"], [path_radius_inputs(
        config, st_f, frame_features(config, model, main_data["gray"][-1],
                                     main_data["depth_u16"][-1]))], batched=False)
    multi_res, st_m, worlds, trace_multi = run_multi_path(
        config, model, main_data, main_outs, args.profile)
    kernels["radius_match_batched"]["launches"] = multi_res["launches"]["radius_match_batched"]
    check_path_radius(config, kernels["radius_match_batched"], [path_radius_inputs(
        config, member(st_m, b), frame_features(config, model, w["gray"][-1],
                                                w["depth_u16"][-1]))
        for b, w in enumerate(worlds)], batched=True)
    run_recovery(config, st_f, main_data["gray"][-1], main_data["depth_u16"][-1],
                 kernels["top2_match"])
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
