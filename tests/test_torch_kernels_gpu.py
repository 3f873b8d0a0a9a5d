"""The CUDA matching kernels (`vslam_tpu_torch/csrc/matching.cu`) against
their plain PyTorch versions, on the card; the batched radius kernel also
against B launches of the single one.

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
from vslam_tpu_torch.ops import matching

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
