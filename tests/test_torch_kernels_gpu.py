"""The CUDA matching kernels (`vslam_tpu_torch/csrc/matching.cu`) against
their plain PyTorch versions, on the card; the batched radius kernel also
against B launches of the single one. The CUDA graphs of `ops.graphs`,
the epipolar RANSACs' (`ops.ransac`), the 3D-3D half of `step.motion`'s
and `step.pose`'s two (`core.tracking`), against the eager CUDA code,
bit for bit.

Marked `gpu`: without a CUDA device every test skips (a CUDA kernel has
no interpret mode). This file imports neither JAX nor the JAX package, so
it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerance: descriptors are quantised to multiples of 1/256 (exact in
bf16, and every dot product of two of them is exact in f32 whatever the
order of summation), pixels to the half-pixel grid (both pixel-distance
formulas exact), so indices, flags and distances must be equal; min_pix_d2
to 0.5 px^2 + 1e-4 relative (the plain version's |a|^2+|b|^2-2ab rounding
at |uv| ~ 640, and far more at |uv| ~ 1e6), both capped at 1e9 as the
kernels cap it.
"""

import numpy as np
import pytest
import torch

from vslam_tpu_torch.ops import cuda_matching
from vslam_tpu_torch.ops import graphs
from vslam_tpu_torch.ops import matching
from vslam_tpu_torch.ops import prng
from vslam_tpu_torch.ops import ransac as rs
from vslam_tpu_torch.ops.linalg import f32_matmuls

pytestmark = pytest.mark.gpu

RADIUS, THRESH = 12.0, 0.7


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, M, K, D, dev, case="random"):
    """Quantised descriptors and half-pixel projections. Cases: `dense`
    (every row and keypoint within 5.85 px of one centre, all valid: every
    pair inside the radius), `dense_tail` (dense, with the near-copy pairs
    in the last rows and the last keypoints, where the partial 64-row tile
    and 64-keypoint chunk lie), `far_uv` (every other row at |uv| ~ 1e6,
    valid; every fourth off the image, outside every keypoint's radius),
    `packed` (live rows only in the lowest third of the slots)."""
    rng = np.random.default_rng(seed)

    def qdesc(n):
        x = rng.normal(size=(n, D))
        x /= np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12
        return np.round(x * 256) / 256

    db, q = qdesc(M), qdesc(K)
    near = min(K // 2, M)
    rows = M - 1 - np.arange(near) if case == "dense_tail" else rng.choice(M, near, replace=False)
    db[rows] = q[:near] + rng.integers(-2, 3, (near, D)) / 256
    uv_db = np.round(rng.uniform(0, 640, (M, 2)) * 2) / 2
    uv_q = np.round(rng.uniform(0, 640, (K, 2)) * 2) / 2
    uv_q[:near] = uv_db[rows] + np.round(rng.normal(0, 4, (near, 2)) * 2) / 2
    vq, vdb = rng.random(K) > 0.1, rng.random(M) > 0.15
    if case in ("dense", "dense_tail"):
        def disc(n):
            r, a = 5.5 * np.sqrt(rng.random(n)), rng.uniform(0, 2 * np.pi, n)
            return np.round(np.stack([320 + r * np.cos(a), 240 + r * np.sin(a)], -1) * 2) / 2
        uv_db, uv_q = disc(M), disc(K)
        vq[:], vdb[:] = True, True
    if case == "dense_tail":
        q, uv_q = q[::-1].copy(), uv_q[::-1].copy()
    if case == "far_uv":
        uv_db[1::2] = np.round(rng.uniform(-1e6, 1e6, (M // 2, 2)))
        uv_db[2::4] = -2000.0 + np.round(rng.uniform(0, 1000, (len(uv_db[2::4]), 2)))
        vdb[1::2] = True
    if case == "packed":
        vdb[:] = False
        vdb[: M // 3] = True
    return (torch.tensor(q, dtype=torch.bfloat16, device=dev),
            torch.tensor(uv_q, dtype=torch.float32, device=dev),
            torch.tensor(vq, device=dev),
            torch.tensor(db, dtype=torch.bfloat16, device=dev),
            torch.tensor(uv_db, dtype=torch.float32, device=dev),
            torch.tensor(vdb, device=dev))


@pytest.mark.parametrize("M,K,D", [(2048, 96, 64), (1000, 96, 64), (16383, 400, 256)])
def test_radius_kernel_matches_plain(dev, M, K, D):
    args = _inputs(0, M, K, D, dev)
    n0 = cuda_matching.LAUNCHES["radius_match"]
    got = cuda_matching.radius_match(*args, radius_px=RADIUS, desc_thresh=THRESH)
    want = matching.radius_descriptor_match_fused_plain(*args, RADIUS, THRESH)
    torch.cuda.synchronize()
    assert cuda_matching.LAUNCHES["radius_match"] == n0 + 1
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert int(got[1].sum()) >= K // 8
    assert torch.equal(got[2][got[1]], want[2][want[1]])
    torch.testing.assert_close(got[3], want[3], atol=0.5, rtol=1e-4)


def _assert_radius_equal(got, want):
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert torch.equal(got[2][got[1]], want[2][want[1]])
    torch.testing.assert_close(torch.clamp(got[3], max=1e9), torch.clamp(want[3], max=1e9),
                               atol=0.5, rtol=1e-4)


@pytest.mark.parametrize("case", ["dense", "dense_tail", "far_uv", "packed"])
@pytest.mark.parametrize("M,K,D", [(2048, 96, 64), (16384, 400, 256), (16383, 400, 256),
                                   (40, 96, 64), (1000, 48, 64)])
def test_radius_kernel_gated_families(dev, case, M, K, D):
    """The inputs on which the gated design does different work: every pair
    a candidate (tensor-core tiles, partial ones shifted back inside the
    inputs; on the CUDA cores when no 64 x 64 tile fits), rows far outside
    the image, dead slots above the live ones."""
    args = _inputs(3, M, K, D, dev, case)
    got = cuda_matching.radius_match(*args, radius_px=RADIUS, desc_thresh=THRESH)
    want = matching.radius_descriptor_match_fused_plain(*args, RADIUS, THRESH)
    torch.cuda.synchronize()
    _assert_radius_equal(got, want)
    assert int(got[1].sum()) >= 4
    if case == "dense_tail":  # the best pairs lie in the last, partial keypoint chunk
        assert got[1][K // 64 * 64:].any() or K % 64 == 0


@pytest.mark.parametrize("M,K", [(0, 96), (1000, 0), (0, 0), (1000, 77), (333, 33), (64, 1),
                                 (65, 2100)])
def test_radius_kernel_edge_shapes(dev, M, K):
    """Empty map or keypoints, K not a multiple of 32 or 64, and K above the
    kernel's shared-memory stage (2048 keypoints)."""
    args = _inputs(4, M, K, 64, dev)
    got = cuda_matching.radius_match(*args, radius_px=RADIUS, desc_thresh=THRESH)
    torch.cuda.synchronize()
    assert got[0].shape == (K,) and got[3].shape == (M,)
    if M and K:
        _assert_radius_equal(got, matching.radius_descriptor_match_fused_plain(
            *args, RADIUS, THRESH))
    else:  # the plain version's reductions refuse an empty axis
        assert (got[3] == 1e9).all()
        assert not got[1].any() and (got[0] == -1).all() and (got[2] == 1e9).all()


def test_radius_kernel_repeat_calls_are_identical(dev):
    """The claims live in the call's own buffer and are cleared by the
    kernel: a second call on the same inputs gives the same bits."""
    args = _inputs(5, 16384, 400, 256, dev)
    a = cuda_matching.radius_match(*args, radius_px=RADIUS, desc_thresh=THRESH)
    b = cuda_matching.radius_match(*args, radius_px=RADIUS, desc_thresh=THRESH)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(a[1].sum()) >= 50


@pytest.mark.parametrize("B", [1, 2, 3, 4, 5])
def test_batched_member_pointers_equal_stacked(dev, B):
    """Per-member tensors (each its own allocation) give the stacked call's
    outputs bit for bit, and B single calls'."""
    members = [_inputs(20 + b, 2047, 96, 64, dev,
                       ("random", "dense", "far_uv", "packed", "dense_tail")[b])
               for b in range(B)]
    stacked = [torch.stack(f) for f in zip(*members)]
    n0 = cuda_matching.LAUNCHES["radius_match_batched"]
    got = cuda_matching.radius_match_batched(*(list(f) for f in zip(*members)),
                                             radius_px=RADIUS, desc_thresh=THRESH)
    ref = cuda_matching.radius_match_batched(*stacked, radius_px=RADIUS, desc_thresh=THRESH)
    single = [cuda_matching.radius_match(*m, radius_px=RADIUS, desc_thresh=THRESH)
              for m in members]
    want = matching.radius_descriptor_match_fused_batched_plain(*stacked, RADIUS, THRESH)
    torch.cuda.synchronize()
    assert cuda_matching.LAUNCHES["radius_match_batched"] == n0 + 2
    for g, r, s in zip(got, ref, zip(*single)):
        assert torch.equal(g, r) and torch.equal(g, torch.stack(s))
    _assert_radius_equal(got, want)


def _top2_expected(db, vdb, q):
    """The plain version's (d1, d2, idx), idx -1 in place of its 0 where no
    row is valid; for an empty map (which its reductions refuse) 1e9, 1e9,
    -1."""
    K = q.shape[0]
    if db.shape[0] == 0:
        big = torch.full((K,), 1e9, device=q.device)
        return big, big.clone(), torch.full((K,), -1, dtype=torch.int32, device=q.device)
    p1, p2, pidx = matching.top2_match_plain(db, vdb, q)
    return p1, p2, torch.where(p1 < 0.5e9, pidx, -1).to(torch.int32)


_TOP2_SHAPES = [(m, k, 256) for m in (0, 17, 63, 1000, 16383, 16384) for k in (1, 96, 400)]


@pytest.mark.parametrize("case,M,K,D", [("random", *s) for s in _TOP2_SHAPES] + [
    ("random", 2048, 96, 64), ("random", 1000, 96, 64), ("one_valid", 16384, 400, 256),
    ("one_valid", 1000, 96, 64), ("tied_best", 16384, 400, 256), ("tied_best", 1000, 96, 64),
    ("low_slots", 16384, 400, 256), ("last_tile", 16383, 400, 256), ("last_tile", 1000, 96, 64)])
def test_top2_kernel_matches_plain(dev, case, M, K, D):
    """Map sizes below one 64-row tile, not a multiple of it and empty;
    query counts below, at and not a multiple of the 80-query chunk. Cases:
    one valid row (d2 = 1e9); `tied_best`, the best rows of 40 queries
    copied 64 * 7 + 3 rows on, in another tile (d2 == d1, the lower row
    wins); `low_slots`, valid
    rows only in the 5,000 lowest slots (the recovery map's layout: most
    tiles are skipped); `last_tile`, valid rows only in the partial last
    tile."""
    q, _, _, db, _, vdb = _inputs(1, M, K, D, dev)
    if case == "one_valid":
        vdb[:] = False
        vdb[M // 2 + 5] = True
    if case == "tied_best":  # the best rows of the first 40 queries, copied 451 rows on
        p1, _, pidx = matching.top2_match_plain(db, vdb, q[:40])
        src = torch.unique(pidx[p1 < 0.5e9].long())
        dst = (src + 64 * 7 + 3) % M
        keep = ~torch.isin(dst, src)
        src, dst = src[keep], dst[keep]
        db[dst], vdb[dst] = db[src], True
    if case == "low_slots":
        vdb[5000:] = False
    if case == "last_tile":
        vdb[: (M - 1) // 64 * 64] = False
    n0 = cuda_matching.LAUNCHES["top2_match"]
    got = cuda_matching.top2_match(db, vdb, q)
    want = _top2_expected(db, vdb, q)
    torch.cuda.synchronize()
    assert cuda_matching.LAUNCHES["top2_match"] == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    d1, d2, idx = got
    if case == "one_valid":
        assert (idx == M // 2 + 5).all() and (d2 == 1e9).all()
    if case == "tied_best":
        assert int((d1 == d2).sum()) >= 4
    if case in ("low_slots", "last_tile"):
        lo = 0 if case == "low_slots" else (M - 1) // 64 * 64
        hi = 5000 if case == "low_slots" else M
        assert ((idx >= lo) & (idx < hi)).all()


def test_top2_kernel_repeat_calls_are_identical(dev):
    """The partials live in the call's own buffer and are overwritten by the
    kernel: back-to-back calls give the same bits."""
    q, _, _, db, _, vdb = _inputs(6, 16384, 400, 256, dev)
    a = cuda_matching.top2_match(db, vdb, q)
    b = cuda_matching.top2_match(db, vdb, q)
    c = cuda_matching.top2_match(db, vdb, q)
    torch.cuda.synchronize()
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_top2_kernel_without_queries_launches_nothing(dev):
    q, _, _, db, _, vdb = _inputs(8, 1000, 0, 64, dev)
    n0 = cuda_matching.LAUNCHES["top2_match"]
    d1, d2, idx = cuda_matching.top2_match(db, vdb, q)
    torch.cuda.synchronize()
    assert cuda_matching.LAUNCHES["top2_match"] == n0
    assert d1.shape == d2.shape == idx.shape == (0,)


def test_top2_kernel_is_one_device_kernel(dev):
    """A call is one kernel on the card: no memset, no second kernel
    (counted from a torch.profiler trace of one call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q, _, _, db, _, vdb = _inputs(7, 16384, 400, 256, dev)
    cuda_matching.top2_match(db, vdb, q)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cuda_matching.top2_match(db, vdb, q)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "top2_match_kernel" in names[0], names


def test_kernels_with_no_valid_map_row(dev):
    q, uvq, vq, db, uvdb, vdb = _inputs(2, 1000, 96, 64, dev)
    vdb = torch.zeros_like(vdb)
    mp_idx, kp_ok, _, _ = cuda_matching.radius_match(q, uvq, vq, db, uvdb, vdb,
                                                     radius_px=RADIUS, desc_thresh=THRESH)
    d1, _, idx = cuda_matching.top2_match(db, vdb, q)
    torch.cuda.synchronize()
    assert not kp_ok.any() and (mp_idx == -1).all()
    assert (idx == -1).all() and (d1 >= 1e9).all()


def _batched_inputs(B, M, K, D, dev, dead_member=None):
    members = [_inputs(10 + b, M, K, D, dev) for b in range(B)]
    args = [torch.stack(f) for f in zip(*members)]
    if dead_member is not None:
        args[5][dead_member] = False  # no valid map row in this member
    return args


@pytest.mark.parametrize("B,M,K,D,dead", [(3, 2048, 96, 64, None), (4, 16383, 400, 256, None),
                                          (3, 1000, 96, 64, 1)])
def test_batched_radius_kernel(dev, B, M, K, D, dead):
    args = _batched_inputs(B, M, K, D, dev, dead)
    n0 = dict(cuda_matching.LAUNCHES)
    got = cuda_matching.radius_match_batched(*args, radius_px=RADIUS, desc_thresh=THRESH)
    want = matching.radius_descriptor_match_fused_batched_plain(*args, RADIUS, THRESH)
    torch.cuda.synchronize()
    assert cuda_matching.LAUNCHES["radius_match_batched"] == n0["radius_match_batched"] + 1
    assert cuda_matching.LAUNCHES["radius_match"] == n0["radius_match"]
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert torch.equal(got[2][got[1]], want[2][want[1]])
    torch.testing.assert_close(got[3], want[3], atol=0.5, rtol=1e-4)
    # Fresh copies: a member's slice of a stacked tensor need not be
    # 16-byte aligned, which the single wrapper requires.
    single = [cuda_matching.radius_match(*(a[b].clone() for a in args), radius_px=RADIUS,
                                         desc_thresh=THRESH) for b in range(B)]
    for g, s in zip(got, zip(*single)):
        assert torch.equal(g, torch.stack(s))
    if dead is not None:
        assert not got[1][dead].any() and (got[0][dead] == -1).all()
        assert got[1][dead - 1].any()
    # The dispatcher sends CUDA tensors to the kernel.
    d = matching.radius_descriptor_match_fused_batched(*args, RADIUS, THRESH)
    assert all(torch.equal(x, y) for x, y in zip(d, got))


def test_step_components_fused_local_map_launches_the_radius_kernel(dev):
    """`apps.bench_step_components` at N 2 on the card (tiny configuration):
    the fused local-map row launches the radius kernel once a call, its
    plain twin never, and every row has a time and device activities."""
    from vslam_tpu_torch.apps import bench_step_components
    from vslam_tpu_torch.config import tiny_test_config

    out = bench_step_components.run(bench_step_components.parse_args(["--n", "2"]),
                                    tiny_test_config())
    assert out["radius_launches_per_call"] == {"fused": 1, "plain": 0}
    assert out["local_map_matches"]["fused"] == out["local_map_matches"]["plain"] > 0
    for row, us in out["us_per_iter"].items():
        assert us > 0 and out["activities_per_iter"][row] > 0, row


# The epipolar RANSACs at the benchmark's shapes: K 400, 128 hypotheses.
_INTR = (525.0, 525.0, 319.5, 239.5)
# Each: the public function, its keywords, its device function and that
# function's statics under those keywords.
_RANSAC = {
    "fundamental": (rs.ransac_fundamental, dict(num_hypotheses=128, threshold_px=3.0),
                    rs._fundamental, (3.0, 8)),
    "essential": (rs.ransac_essential, dict(zip(("fx", "fy", "cx", "cy"), _INTR),
                                            num_hypotheses=128, threshold_px=1.0,
                                            min_inliers=15),
                  rs._essential, (*_INTR, 1.0, 15, 8)),
}


def _correspondences(seed, dev, B=3, K=400):
    """(B, K, 2) pixel pairs of a rigid motion, a quarter of them outliers,
    and (B, K) validity: B members' batched storage."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = _INTR
    X = rng.uniform(-2, 2, (B, K, 3)) + [0, 0, 5.0]
    w = rng.normal(size=3)
    w *= 0.08 / np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    R = np.eye(3) + np.sin(0.08) / 0.08 * W + (1 - np.cos(0.08)) / 0.08 ** 2 * W @ W
    X2 = X @ R.T + [0.3, 0.05, 0.02]

    def pix(P):
        return np.stack([fx * P[..., 0] / P[..., 2] + cx, fy * P[..., 1] / P[..., 2] + cy], -1)

    uv1 = pix(X) + rng.normal(0, 0.3, (B, K, 2))
    uv2 = pix(X2) + rng.normal(0, 0.3, (B, K, 2))
    bad = rng.random((B, K)) < 0.25
    uv2[bad] += rng.uniform(-60, 60, (bad.sum(), 2))
    valid = rng.random((B, K)) > 0.1
    return (torch.tensor(uv1, dtype=torch.float32, device=dev),
            torch.tensor(uv2, dtype=torch.float32, device=dev), torch.tensor(valid, device=dev))


def _ransac(which, key, uv1, uv2, valid, graphed):
    """The public RANSAC (a graph replay on the card) where `graphed`, else
    its device function run eagerly on the same draw, moved to the card."""
    fn, kw, device_fn, statics = _RANSAC[which]
    with f32_matmuls():
        if graphed:
            return fn(key, uv1, uv2, valid, **kw)
        u = rs.draw_minimal_sets(key, valid.shape[-1], kw["num_hypotheses"], 8)
        return device_fn(u.to(valid.device), uv1, uv2, valid, *statics)


def _leaves(out):
    return [x for o in out for x in (o if isinstance(o, tuple) else (o,))]


def _assert_bitwise(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y)


@pytest.mark.parametrize("which", ["fundamental", "essential"])
def test_epipolar_graph_replay_equals_eager(dev, which):
    """Replays give the eager CUDA path's bits, for several draws and on
    member slices of batched storage (offset views)."""
    uv1, uv2, valid = _correspondences(1, dev)
    oks = []
    for fid in range(4):
        key = prng.fold_in(prng.prng_key(42), fid)
        b = fid % 3
        args = (uv1[b], uv2[b], valid[b])
        want = _ransac(which, key, *args, graphed=False)
        got = _ransac(which, key, *args, graphed=True)
        _assert_bitwise(got, want)
        oks.append(bool(got[-1].ok))
    assert any(oks), which


@pytest.mark.parametrize("which", ["fundamental", "essential"])
def test_epipolar_graph_replays_do_not_alias(dev, which):
    """Two replays' results, held at once, are each their own inputs'."""
    uv1, uv2, valid = _correspondences(2, dev)
    key = prng.prng_key(5)
    first = _ransac(which, key, uv1[0], uv2[0], valid[0], graphed=True)
    second = _ransac(which, prng.prng_key(6), uv1[1], uv2[1], valid[1], graphed=True)
    _assert_bitwise(first, _ransac(which, key, uv1[0], uv2[0], valid[0], graphed=False))
    _assert_bitwise(second, _ransac(which, prng.prng_key(6), uv1[1], uv2[1], valid[1],
                                    graphed=False))
    assert not torch.equal(first[-1].inlier_mask, second[-1].inlier_mask)


@pytest.mark.parametrize("which", ["fundamental", "essential"])
def test_epipolar_graph_captured_once(dev, which, monkeypatch):
    """One capture for a key, then a replay per call; the eager code is
    counted nowhere."""
    monkeypatch.setattr(graphs, "_GRAPHS", {})
    uv1, uv2, valid = _correspondences(3, dev)
    graphs.reset_stats()
    for i in range(5):
        _ransac(which, prng.prng_key(i), uv1[i % 3], uv2[i % 3], valid[i % 3], graphed=True)
    _ransac(which, prng.prng_key(0), uv1[0], uv2[0], valid[0], graphed=False)
    assert graphs.STATS == {_RANSAC[which][2].__name__: {"captures": 1, "replays": 5}}
    assert len(graphs._GRAPHS) == 1


@pytest.mark.parametrize("which", ["fundamental", "essential"])
def test_epipolar_graph_replay_makes_no_sync(dev, which):
    """A replay makes the host wait for nothing: the draw goes through
    pinned memory, the inputs and outputs are copied on the card."""
    uv1, uv2, valid = _correspondences(4, dev)
    _ransac(which, prng.prng_key(1), uv1[0], uv2[0], valid[0], graphed=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _ransac(which, prng.prng_key(2), uv1[1], uv2[1], valid[1], graphed=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    _assert_bitwise(out, _ransac(which, prng.prng_key(2), uv1[1], uv2[1], valid[1],
                                 graphed=False))


# The two halves of `step.pose` (`core.tracking._pose_fusion`,
# `_pose_refinement`) and the 3D-3D half of `step.motion`
# (`_rigid_motion`) on the tracking step's own inputs: feature-level
# synthetic worlds at the default configuration (K 400, D 256, M 16384),
# one world alone and three as the members of the batched step.
_POSE = {"fusion": "_pose_fusion", "refinement": "_pose_refinement"}
_STEP = {**_POSE, "motion": "_rigid_motion"}
_POSE_FRAMES = 16


def _pose_run(dev, batched):
    """`_POSE_FRAMES` frames of world 0 through `tracking.run_frames`, or of
    worlds 0-2 through `tracking_batched.batched_tracking_scan` (members
    are views of the batched state). Returns the stacked outputs."""
    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.core import pipeline, tracking, tracking_batched
    from vslam_tpu_torch.core.state import init_state, stack_trees
    from vslam_tpu_torch.data import synthetic

    config = SlamConfig()
    worlds = [pipeline.features_from_synthetic(synthetic.make_sequence(_POSE_FRAMES, seed=s),
                                               device=dev)
              for s in range(3 if batched else 1)]
    if batched:
        states = stack_trees([init_state(config, device=dev)] * 3)
        return tracking_batched.batched_tracking_scan(states, stack_trees(worlds), config)[1]
    return tracking.run_frames(init_state(config, device=dev), worlds[0],
                               list(range(_POSE_FRAMES)), config)[1]


def _eager_motion_3d3d(state, frame, config, m, uv_kf, uv_cur, gated, key):
    """The 3D-3D half of `step.motion` written out on the public RANSAC,
    `ops.ransac.ransac_kabsch_3d3d` (eager), with the cap of the keyframe
    gap."""
    from vslam_tpu_torch.ops import camera as cam

    c, mc = config.camera, config.motion
    intr = (c.fx, c.fy, c.cx, c.cy)
    depth_cur = frame.depth[m.idx.long()]
    d_ok = ((state.kf_depth > c.depth_min) & (state.kf_depth < c.depth_max)
            & (depth_cur > c.depth_min) & (depth_cur < c.depth_max))
    p_kf = cam.backproject(uv_kf, state.kf_depth, *intr)
    p_cur = cam.backproject(uv_cur, depth_cur, *intr)
    gap = (frame.frame_id - state.kf_frame_id).to(p_kf.dtype)
    max_t = torch.clamp(gap * mc.r3d_max_translation_per_frame, min=mc.r3d_max_translation)
    R3, t3, res3 = rs.ransac_kabsch_3d3d(
        key, p_kf, p_cur, gated & d_ok, num_hypotheses=mc.r3d_iters,
        inlier_thresh=mc.r3d_inlier_thresh, max_translation=max_t,
        min_translation=mc.r3d_min_translation, min_inliers=config.frontend.min_inliers)
    return R3, t3, res3, p_kf, p_cur, d_ok


def _recorded_step_calls(dev):
    """Every call of a graphed step function (a pose half, the 3D-3D half of
    `step.motion`) in the solo and the batched run, with the eager code's
    outputs and the replay's on the same inputs, taken at the call: dicts
    of run, name, fn, statics, inputs, want, got. Besides, each call of
    `tracking._motion_3d3d` with its result and the public RANSAC's
    (`_eager_motion_3d3d`): dicts of run, name, got, want."""
    from vslam_tpu_torch.core import tracking

    calls = []
    call = graphs.call
    motion = tracking._motion_3d3d

    def recording_call(fn, statics, inputs):
        if fn.__name__ not in _STEP.values():  # the epipolar RANSACs
            return call(fn, statics, inputs)
        want = fn(*(x.to(dev) for x in inputs), *statics)  # the host draw to the card
        got = call(fn, statics, inputs)
        calls.append(dict(run=run, name=fn.__name__, fn=fn, statics=statics, inputs=inputs,
                          want=want, got=got))
        return got

    def recording_motion(*args):
        want = _eager_motion_3d3d(*args)
        got = motion(*args)
        calls.append(dict(run=run, name="_motion_3d3d", got=got, want=want))
        return got

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "call", recording_call)
        mp.setattr(tracking, "_motion_3d3d", recording_motion)
        for run in ("solo", "batched"):
            outs = _pose_run(dev, run == "batched")
            assert bool(torch.all(outs.tracking_ok)), run
    return calls


@pytest.fixture(scope="module")
def step_calls():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs have no CPU mode")
    return _recorded_step_calls(torch.device("cuda"))


def _calls_of(step_calls, run, half):
    return [c for c in step_calls if c["run"] == run and c["name"] == _STEP.get(half, half)]


@pytest.mark.parametrize("run", ["solo", "batched"])
@pytest.mark.parametrize("half", ["fusion", "refinement"])
def test_pose_graph_replay_equals_eager(step_calls, run, half):
    """Each replay gives the eager code's bits on the tracking step's own
    inputs, every tracked frame; in the batched run on members' views of
    the batched state (offset storage), copied into the graph's buffers."""
    calls = _calls_of(step_calls, run, half)
    assert len(calls) == (_POSE_FRAMES - 1) * (3 if run == "batched" else 1)
    for c in calls:
        _assert_bitwise(c["got"], c["want"])
    if run == "batched":
        assert any(x.storage_offset() > 0 for c in calls for x in c["inputs"])
    if half == "refinement":  # keyframe frames and others
        assert {bool(c["got"][4]) for c in calls} == {True, False}


@pytest.mark.parametrize("half", ["fusion", "refinement"])
def test_pose_graph_replays_do_not_alias(step_calls, half):
    """Two replays' results, held at once, are each their own inputs'."""
    a, b = _calls_of(step_calls, "solo", half)[2:7:4]
    with f32_matmuls():
        first = graphs.call(a["fn"], a["statics"], a["inputs"])
        second = graphs.call(b["fn"], b["statics"], b["inputs"])
        _assert_bitwise(first, a["fn"](*a["inputs"], *a["statics"]))
        _assert_bitwise(second, b["fn"](*b["inputs"], *b["statics"]))
    assert not torch.equal(first[1], second[1])


@pytest.mark.parametrize("run", ["solo", "batched"])
def test_pose_graphs_captured_once(dev, run, monkeypatch):
    """A run captures each half once (the batched members share it) and
    replays it on every tracked member-frame."""
    from vslam_tpu_torch.core import tracking

    monkeypatch.setattr(graphs, "_GRAPHS", {})
    graphs.reset_stats()
    tracking.reset_stats()
    _pose_run(dev, run == "batched")
    n = tracking.STATS["track_frames"]
    assert n == (_POSE_FRAMES - 1) * (3 if run == "batched" else 1)
    for name in _POSE.values():
        assert graphs.STATS[name] == {"captures": 1, "replays": n}, name


@pytest.mark.parametrize("half", ["fusion", "refinement"])
def test_pose_graph_replay_makes_no_sync(step_calls, half):
    """A replay makes the host wait for nothing: the inputs and outputs
    are copied on the card."""
    c = _calls_of(step_calls, "solo", half)[3]
    with f32_matmuls():
        graphs.call(c["fn"], c["statics"], c["inputs"])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = graphs.call(c["fn"], c["statics"], c["inputs"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        _assert_bitwise(out, c["fn"](*c["inputs"], *c["statics"]))


@pytest.mark.parametrize("run", ["solo", "batched"])
def test_motion_graph_replay_equals_eager(step_calls, run):
    """Each replay of `_rigid_motion` gives the eager code's bits on the
    tracking step's own inputs, every tracked frame (in the batched run on
    members' views, copied into the graph's buffers), and `_motion_3d3d`
    the bits of the public RANSAC on the backprojected sets."""
    n = (_POSE_FRAMES - 1) * (3 if run == "batched" else 1)
    calls = _calls_of(step_calls, run, "motion")
    assert len(calls) == n
    for c in calls:
        _assert_bitwise(c["got"], c["want"])
    if run == "batched":
        assert any(x.storage_offset() > 0 for c in calls for x in c["inputs"])
    whole = _calls_of(step_calls, run, "_motion_3d3d")
    assert len(whole) == n
    for c in whole:
        _assert_bitwise(c["got"], c["want"])
    assert any(bool(c["got"][2].ok) for c in whole)


def _rigid_scene(dev, t_norm, K=400, seed=0):
    """A keyframe's and a frame's matched keypoints with depth at the
    default configuration's intrinsics, the frame `t_norm` metres from the
    keyframe; the frame's keypoints permuted, so that the match indices
    gather. Returns (state, frame, m, uv_kf, uv_cur, gated) as
    `_motion_3d3d` takes them, keyframe id 10."""
    from types import SimpleNamespace

    fx, fy, cx, cy = _INTR
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.0, 1.0, (K, 3)) + [0.0, 0.0, 3.0]
    t = rng.normal(size=3)
    X2 = X + t * (t_norm / np.linalg.norm(t))

    def pix(P):
        return np.stack([fx * P[:, 0] / P[:, 2] + cx, fy * P[:, 1] / P[:, 2] + cy], -1)

    perm = rng.permutation(K)
    depth = np.empty(K)
    depth[perm] = X2[:, 2]

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    state = SimpleNamespace(kf_depth=f32(X[:, 2]),
                            kf_frame_id=torch.tensor(10, dtype=torch.int32, device=dev))
    frame = SimpleNamespace(depth=f32(depth), frame_id=None)
    m = SimpleNamespace(idx=torch.tensor(perm, dtype=torch.int32, device=dev))
    return (state, frame, m, f32(pix(X)), f32(pix(X2)),
            torch.tensor(rng.random(K) > 0.1, device=dev))


def test_motion_graph_cap_follows_the_input(dev, monkeypatch):
    """One graph, two keyframe gaps: matches 0.35 m apart fail under the
    0.2 m cap two frames after the keyframe and pass ten frames after it
    (0.05 m a frame), as the eager code does."""
    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.core import tracking

    monkeypatch.setattr(graphs, "_GRAPHS", {})
    graphs.reset_stats()
    config = SlamConfig()
    state, frame, m, uv_kf, uv_cur, gated = _rigid_scene(dev, 0.35)
    key = prng.prng_key(3)
    oks = []
    with f32_matmuls():
        for gap in (2, 10):
            frame.frame_id = state.kf_frame_id + gap
            got = tracking._motion_3d3d(state, frame, config, m, uv_kf, uv_cur, gated, key)
            _assert_bitwise(got, _eager_motion_3d3d(state, frame, config, m, uv_kf, uv_cur,
                                                    gated, key))
            oks.append(bool(got[2].ok))
    assert oks == [False, True]
    assert graphs.STATS == {"_rigid_motion": {"captures": 1, "replays": 2}}


def test_motion_graph_replays_do_not_alias(step_calls):
    """Two replays' results, held at once, are each their own inputs'."""
    a, b = _calls_of(step_calls, "solo", "motion")[2:7:4]
    with f32_matmuls():
        first = graphs.call(a["fn"], a["statics"], a["inputs"])
        second = graphs.call(b["fn"], b["statics"], b["inputs"])
        _assert_bitwise(first, a["want"])
        _assert_bitwise(second, b["want"])
    assert not torch.equal(first[1], second[1])


@pytest.mark.parametrize("run", ["solo", "batched"])
def test_motion_graph_captured_once(dev, run, monkeypatch):
    """A run captures `_rigid_motion` once (the batched members share it)
    and replays it on every tracked member-frame."""
    from vslam_tpu_torch.core import tracking

    monkeypatch.setattr(graphs, "_GRAPHS", {})
    graphs.reset_stats()
    tracking.reset_stats()
    _pose_run(dev, run == "batched")
    n = tracking.STATS["track_frames"]
    assert n == (_POSE_FRAMES - 1) * (3 if run == "batched" else 1)
    assert graphs.STATS[_STEP["motion"]] == {"captures": 1, "replays": n}


def test_motion_graph_replay_makes_no_sync(step_calls):
    """A replay makes the host wait for nothing: the draw goes through
    pinned memory, the other inputs and the outputs are copied on the
    card."""
    c = _calls_of(step_calls, "solo", "motion")[3]
    with f32_matmuls():
        graphs.call(c["fn"], c["statics"], c["inputs"])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = graphs.call(c["fn"], c["statics"], c["inputs"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    _assert_bitwise(out, c["want"])
