"""Descriptor matchers of the port (`vslam_tpu_torch.ops.matching`): the
plain versions of the two CUDA kernels against the JAX package's XLA path
(`vslam_tpu.ops.matching`) and its Pallas kernels run in interpret mode
(`vslam_tpu.ops.pallas_matching`), at the sizes of
`tests/test_pallas_matching.py` (M 2048 / 1000, K 96, D 64, tile 256).

The batched plain matcher is held against the batched Pallas kernel
(`radius_match_pallas_batched`, interpret mode) and the JAX package's
batched XLA path at the sizes of `tests/test_pallas_matching.py:141`
(B 3, M 1024, K 96, D 64).

Tolerance: indices and flags equal; distances within 1e-4 (f32 sums of
the same products in another order). Against the Pallas kernel, which
measures pixel distance by subtraction where the plain version uses the
|a|^2+|b|^2-2ab identity (as the XLA path does), a radius-gate decision
may flip for a pair with |pix_d2 - r^2| <= 1 px^2; the inputs here are
drawn on a half-pixel grid so that both formulas are exact and nothing
flips, and min_pix_d2 is held to 0.5 px^2 (the identity's rounding at
|uv| ~ 640).

The CUDA kernels themselves run only on the card
(`tests/test_torch_kernels_gpu.py`, marked `gpu`).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vslam_tpu.ops import matching as j_m
from vslam_tpu.ops import pallas_matching as pm
from vslam_tpu_torch.ops import cuda_matching
from vslam_tpu_torch.ops import matching as t_m

RADIUS, THRESH = 12.0, 0.7


def unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def radius_inputs(rng, M, K=96, D=64, case="random"):
    db = unit(rng, M, D)
    near = K // 2
    q = np.concatenate([db[:near] + rng.normal(0, 0.05, (near, D)).astype(np.float32),
                        unit(rng, K - near, D)])
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    uv_db = (np.round(rng.uniform(0, 640, (M, 2)) * 2) / 2).astype(np.float32)
    uv_q = np.concatenate([uv_db[:near] + np.round(rng.normal(0, 4, (near, 2)) * 2) / 2,
                           np.round(rng.uniform(0, 640, (K - near, 2)) * 2) / 2]).astype(np.float32)
    vdb = rng.random(M) > 0.15
    vq = rng.random(K) > 0.1
    if case == "ties":
        # Map rows M/2.. copy rows 0..: the copy claims the same keypoint
        # at the same distance, so the lower row must win. Keypoints 60..
        # copy 0..: equal row distances, so the lower keypoint must win.
        o = M // 2
        db[o:o + near], uv_db[o:o + near] = db[:near], uv_db[:near]
        vdb[:near] = vdb[o:o + near] = True
        q[60:70], uv_q[60:70], vq[:10], vq[60:70] = q[:10], uv_q[:10], True, True
    if case == "all_invalid":
        vdb[:] = False
    if case == "dense":
        # Every row and keypoint within 5.85 px of one centre (5.5 px, then
        # the half-pixel rounding): every pair lies inside the 12 px radius.
        def disc(n):
            r, a = 5.5 * np.sqrt(rng.random(n)), rng.uniform(0, 2 * np.pi, n)
            xy = np.stack([320 + r * np.cos(a), 240 + r * np.sin(a)], -1)
            return (np.round(xy * 2) / 2).astype(np.float32)
        uv_db, uv_q = disc(M), disc(K)
        vdb[:], vq[:] = True, True
    if case == "far_uv":
        # Every other row far outside the image (|uv| ~ 1e6, valid, no
        # candidate), and every fourth near it but outside the radius of
        # any keypoint (valid rows with no candidate).
        uv_db[1::2] = np.round(rng.uniform(-1e6, 1e6, (M // 2, 2)))
        uv_db[2::4] = -2000.0 + np.round(rng.uniform(0, 1000, (len(uv_db[2::4]), 2)))
        vdb[1::2] = True
    if case == "packed":
        # Free-slot insertion packs the live rows into the lowest slots.
        vdb[:] = False
        vdb[: M // 3] = True
    return q, uv_q, vq, db, uv_db, vdb


def as_bf16(x):
    """Round f32 to bf16 values, kept as f32 (the same numbers in both
    packages)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("case,M", [("random", 2048), ("ties", 2048), ("all_invalid", 2048),
                                    ("random", 1000)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_radius_plain_vs_xla(rng, case, M, dtype):
    q, uv_q, vq, db, uv_db, vdb = radius_inputs(rng, M, case=case)
    if dtype == "bf16":
        q, db = as_bf16(q), as_bf16(db)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    got = t_m.radius_descriptor_match_fused_plain(
        torch.from_numpy(q).to(tdt), torch.from_numpy(uv_q), torch.from_numpy(vq),
        torch.from_numpy(db).to(tdt), torch.from_numpy(uv_db), torch.from_numpy(vdb),
        RADIUS, THRESH,
    )
    want = j_m.radius_descriptor_match_fused(
        jnp.asarray(q, jdt), jnp.asarray(uv_q), jnp.asarray(vq),
        jnp.asarray(db, jdt), jnp.asarray(uv_db), jnp.asarray(vdb),
        radius_px=RADIUS, desc_thresh=THRESH,
    )
    g = [x.numpy() for x in got]
    w = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(g[1], w[1])
    np.testing.assert_array_equal(g[0], w[0])
    np.testing.assert_allclose(g[2], w[2], atol=1e-4)
    np.testing.assert_allclose(g[3], w[3], atol=0.5, rtol=1e-4)
    if case == "random":
        assert g[1].sum() >= 20
    if case == "ties":
        assert g[1][:10].all() and not g[1][60:70].any()
        assert (g[0][:10] < M // 2).all()
    if case == "all_invalid":
        assert not g[1].any() and (g[0] == -1).all()


@pytest.mark.parametrize("case,M", [("random", 2048), ("ties", 2048), ("all_invalid", 2048),
                                    ("random", 1000), ("dense", 2048), ("far_uv", 2048),
                                    ("packed", 2048)])
def test_radius_plain_vs_pallas(rng, case, M):
    q, uv_q, vq, db, uv_db, vdb = radius_inputs(rng, M, case=case)
    got = t_m.radius_descriptor_match_fused_plain(
        *(torch.from_numpy(a) for a in (q, uv_q, vq, db, uv_db, vdb)), RADIUS, THRESH)
    want = pm.radius_match_pallas(
        *(jnp.asarray(a) for a in (q, uv_q, vq, db, uv_db, vdb)),
        radius_px=RADIUS, desc_thresh=THRESH, tile=256, interpret=True,
    )
    g = [x.numpy() for x in got]
    w = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(g[1], w[1])
    np.testing.assert_array_equal(g[0], w[0])
    ok = w[1]
    np.testing.assert_allclose(g[2][ok], w[2][ok], atol=1e-4)
    np.testing.assert_allclose(np.minimum(g[3], 1e9), np.minimum(w[3], 1e9), atol=0.5, rtol=1e-4)
    if case in ("dense", "far_uv", "packed"):
        assert g[1].sum() >= (5 if case == "far_uv" else 20)
    if case == "dense":
        assert (w[3] <= RADIUS ** 2).all()
    if case == "far_uv":
        assert (w[3][1::2] >= 1e9).all() and (w[3][2::4] > RADIUS ** 2).all()
        assert (g[0][g[1]] % 4 == 0).all()
    if case == "packed":
        assert (g[0][g[1]] < M // 3).all()


def top2_inputs(rng, M, Kq=96, D=64, case="random"):
    db = unit(rng, M, D)
    q = np.concatenate([db[:32] + rng.normal(0, 0.02, (32, D)).astype(np.float32),
                        unit(rng, Kq - 32, D)])
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    vdb = rng.random(M) > 0.1
    if case == "ties":
        db[M // 2: M // 2 + 32] = db[:32]  # exact duplicates: the lower row wins
        vdb[:32] = vdb[M // 2: M // 2 + 32] = True
    if case == "all_invalid":
        vdb[:] = False
    return db, vdb, q


@pytest.mark.parametrize("case,M", [("random", 1000), ("ties", 1000), ("all_invalid", 1000),
                                    ("random", 2048)])
def test_top2_plain_vs_pallas_and_xla(rng, case, M):
    db, vdb, q = top2_inputs(rng, M, case=case)
    d1, d2, idx = (x.numpy() for x in t_m.top2_match_plain(
        torch.from_numpy(db), torch.from_numpy(vdb), torch.from_numpy(q)))
    p1, p2, pidx = (np.asarray(x) for x in pm.top2_match_pallas(
        jnp.asarray(db), jnp.asarray(vdb), jnp.asarray(q), tile=256, interpret=True))
    np.testing.assert_allclose(d1, p1, atol=1e-4)
    np.testing.assert_allclose(d2, p2, atol=1e-4)
    has = p1 < 0.5e9
    np.testing.assert_array_equal(idx[has], pidx[has])
    # No valid row: the kernel keeps its -1, the dense argmin says 0.
    assert (pidx[~has] == -1).all() and (idx[~has] == 0).all()
    if case == "all_invalid":
        assert not has.any()
    if case == "ties":
        assert (idx[:32] == np.arange(32)).all()
    ratio = 0.7 ** 0.5
    got = t_m.knn2_ratio_match_streaming(
        torch.from_numpy(q), torch.from_numpy(db), torch.ones(len(q), dtype=torch.bool),
        torch.from_numpy(vdb), ratio=ratio)
    want = j_m.knn2_ratio_match(jnp.asarray(q), jnp.asarray(db), jnp.ones(len(q), bool),
                                jnp.asarray(vdb), ratio=ratio, mutual=False)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(want.dist), atol=1e-4)


def _quantized_unit(rng, n, d):
    """Unit-ish rows on a 1/256 grid: every dot product of two of them is
    exact in f32 whatever the order or blocking of the sum, so a product
    over part of the map gives the whole map's bits."""
    return (np.round(unit(rng, n, d) * 256) / 256).astype(np.float32)


def _fold_partials(parts, order, Kq):
    """The CUDA top-2 kernel's merge rule, on the host: partials (d1, d2,
    row) folded in `order` with the best as the packed (float bits of d1)
    << 32 | row (the least d, then the lowest row) and the second as
    min(max(b, tb), min(s, ts)). Starts from (1e9, row 0xffffffff), so no
    partial gives idx -1."""
    key = np.full(Kq, (np.float32(1e9).view(np.uint32).astype(np.uint64) << 32) | 0xFFFFFFFF,
                  np.uint64)
    s = np.full(Kq, 1e9, np.float32)
    for i in order:
        d1, d2, row = parts[i]
        t = (d1.astype(np.float32).view(np.uint32).astype(np.uint64) << np.uint64(32)) | \
            row.astype(np.int64).astype(np.uint64)
        b, tb = (key >> np.uint64(32)).astype(np.uint32).view(np.float32), d1.astype(np.float32)
        s = np.minimum(np.maximum(b, tb), np.minimum(s, d2))
        key = np.minimum(key, t)
    d1 = (key >> np.uint64(32)).astype(np.uint32).view(np.float32)
    return d1, s, (key & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("case", ["random", "ties", "all_invalid", "one_valid", "low_slots",
                                  "last_tile"])
def test_top2_split_merge_equals_whole_map(rng, case):
    """The decomposition the CUDA top-2 kernel relies on: the map cut into
    64-row tiles, tile t to split t % S, tiles with no valid row dropped,
    `top2_match_plain` per split, the partials folded by `_fold_partials`
    in three shuffled orders. Each fold must equal the whole-map plain
    version bit for bit, idx -1 where no row is valid (the plain version
    says 0 there), and the Pallas kernel (interpret mode): idx equal,
    distances within 1e-6."""
    M, Kq, D, S, T = 1000, 96, 64, 5, 64  # M % 64 = 40: a partial last tile
    db, q = _quantized_unit(rng, M, D), _quantized_unit(rng, Kq, D)
    q[:32] = db[rng.choice(M, 32, replace=False)] + np.round(
        rng.normal(0, 0.02, (32, D)) * 256) / 256
    vdb = rng.random(M) > 0.15
    if case == "ties":
        db[M // 2: M // 2 + 32] = db[:32]  # exact duplicates in other tiles and splits
        vdb[:32] = vdb[M // 2: M // 2 + 32] = True
        q[:32] = db[:32]
    if case == "all_invalid":
        vdb[:] = False
    if case == "one_valid":
        vdb[:] = False
        vdb[517] = True
    if case == "low_slots":  # the recovery map's layout: most tiles dead
        vdb[300:] = False
    if case == "last_tile":
        vdb[: M // T * T] = False
    tdb, tvdb, tq = torch.from_numpy(db), torch.from_numpy(vdb), torch.from_numpy(q)
    parts = []
    for split in range(S):
        rows = np.concatenate([np.arange(t * T, min(t * T + T, M))
                               for t in range(split, -(-M // T), S)
                               if vdb[t * T: t * T + T].any()] or [np.zeros(0, np.int64)])
        if rows.size:
            d1, d2, j = (x.numpy() for x in t_m.top2_match_plain(
                tdb[rows], tvdb[rows], tq))
            parts.append((d1, d2, rows[j]))
    whole = [x.numpy() for x in t_m.top2_match_plain(tdb, tvdb, tq)]
    has = whole[0] < 0.5e9
    pal = [np.asarray(x) for x in pm.top2_match_pallas(
        jnp.asarray(db), jnp.asarray(vdb), jnp.asarray(q), tile=256, interpret=True)]
    for _ in range(3):
        f1, f2, fidx = _fold_partials(parts, rng.permutation(len(parts)), Kq)
        np.testing.assert_array_equal(f1, whole[0])
        np.testing.assert_array_equal(f2, whole[1])
        np.testing.assert_array_equal(fidx, np.where(has, whole[2], -1))
        # Against the Pallas kernel: the same dots (exact), but PyTorch's
        # CPU sqrt is not always correctly rounded (1 ulp off XLA's).
        np.testing.assert_allclose(f1, pal[0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(f2, pal[1], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(fidx, pal[2])
    if case == "ties":
        assert (fidx[:32] == np.arange(32)).all() and (f1[:32] == f2[:32]).all()
    if case == "one_valid":
        assert (fidx == 517).all() and (f2 == 1e9).all()
    if case == "all_invalid":
        assert not parts and not has.any()
    if case in ("low_slots", "last_tile"):  # most or all but one tile dropped
        assert len(parts) == S if case == "low_slots" else len(parts) == 1


@pytest.mark.parametrize("mutual", [True, False])
def test_knn2_ratio_match_vs_xla(rng, mutual):
    """The keyframe matcher of the tracking step (bf16 descriptors)."""
    a, b = unit(rng, 64, 64), unit(rng, 64, 64)
    b[:40] = a[:40] + rng.normal(0, 0.05, (40, 64)).astype(np.float32)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    a, b = as_bf16(a), as_bf16(b)
    va, vb = rng.random(64) > 0.1, rng.random(64) > 0.1
    got = t_m.knn2_ratio_match(
        torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16),
        torch.from_numpy(va), torch.from_numpy(vb), ratio=0.8, mutual=mutual, max_dist=1.0)
    want = j_m.knn2_ratio_match(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16), jnp.asarray(va),
        jnp.asarray(vb), ratio=0.8, mutual=mutual, max_dist=1.0)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(want.dist), atol=1e-4)
    assert got.valid.sum() >= 20


def test_cpu_tensors_take_the_plain_version(rng):
    q, uv_q, vq, db, uv_db, vdb = (torch.from_numpy(a) for a in radius_inputs(rng, 512))
    a = t_m.radius_descriptor_match_fused(q, uv_q, vq, db, uv_db, vdb, RADIUS, THRESH)
    b = t_m.radius_descriptor_match_fused_plain(q, uv_q, vq, db, uv_db, vdb, RADIUS, THRESH)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def batched_radius_inputs(rng, B=3, M=1024, K=96, D=64):
    """B members of `radius_inputs`: one random, one with ties, one whose
    map has no valid row."""
    members = [radius_inputs(rng, M, K, D, case)
               for case in ("random", "ties", "all_invalid")[:B]]
    return [np.stack(f) for f in zip(*members)]


def test_radius_batched_plain_vs_pallas_and_xla(rng):
    args = batched_radius_inputs(rng)
    got = [x.numpy() for x in t_m.radius_descriptor_match_fused_batched_plain(
        *(torch.from_numpy(a) for a in args), RADIUS, THRESH)]
    jargs = [jnp.asarray(a) for a in args]
    pal = [np.asarray(x) for x in pm.radius_match_pallas_batched(
        *jargs, radius_px=RADIUS, desc_thresh=THRESH, tile=256, interpret=True)]
    xla = [np.asarray(x) for x in j_m.radius_descriptor_match_fused_batched(
        *jargs, radius_px=RADIUS, desc_thresh=THRESH)]
    assert got[0].shape == (3, 96) and got[3].shape == (3, 1024)
    for want in (pal, xla):
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
        ok = want[1]
        np.testing.assert_allclose(got[2][ok], want[2][ok], atol=1e-4)
        np.testing.assert_allclose(np.minimum(got[3], 1e9), np.minimum(want[3], 1e9),
                                   atol=0.5, rtol=1e-4)
    np.testing.assert_allclose(got[2], xla[2], atol=1e-4)
    assert got[1][0].sum() >= 20 and got[1][1].any() and not got[1][2].any()
    # Member b of the batched plain version is the single plain version.
    for b in range(3):
        single = t_m.radius_descriptor_match_fused_plain(
            *(torch.from_numpy(a[b]) for a in args), RADIUS, THRESH)
        for g, s in zip(got, single):
            np.testing.assert_array_equal(g[b], s.numpy())


def test_batched_dispatch_takes_the_plain_version_on_cpu(rng):
    args = [torch.from_numpy(a) for a in batched_radius_inputs(rng, B=2, M=300)]
    a = t_m.radius_descriptor_match_fused_batched(*args, RADIUS, THRESH)
    b = t_m.radius_descriptor_match_fused_batched_plain(*args, RADIUS, THRESH)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_batched_member_lists_equal_the_stacked_form(rng):
    """The multi-sequence step hands each member's own tensors (lists)
    rather than stacked copies; on the CPU both forms give the same."""
    args = [torch.from_numpy(a) for a in batched_radius_inputs(rng, B=3, M=300)]
    lists = [[x.clone() for x in a] for a in args]
    a = t_m.radius_descriptor_match_fused_batched(*lists, RADIUS, THRESH)
    b = t_m.radius_descriptor_match_fused_batched(*args, RADIUS, THRESH)
    for x, y in zip(a, b):
        assert x.shape == y.shape and torch.equal(x, y)


def test_kernel_wrappers_refuse_cpu_tensors(rng):
    """The wrappers launch on the card or raise: no quiet CPU fallback."""
    q, uv_q, vq, db, uv_db, vdb = (torch.from_numpy(a) for a in radius_inputs(rng, 512))
    before = dict(cuda_matching.LAUNCHES)
    with pytest.raises(ValueError):
        cuda_matching.radius_match(q.bfloat16(), uv_q, vq, db.bfloat16(), uv_db, vdb,
                                   radius_px=RADIUS, desc_thresh=THRESH)
    with pytest.raises(ValueError):
        cuda_matching.top2_match(db.bfloat16(), vdb, q.bfloat16())
    with pytest.raises(ValueError):
        cuda_matching.radius_match_batched(
            q.bfloat16()[None], uv_q[None], vq[None], db.bfloat16()[None], uv_db[None],
            vdb[None], radius_px=RADIUS, desc_thresh=THRESH)
    with pytest.raises(ValueError):
        cuda_matching.radius_match_batched(
            [q.bfloat16()], [uv_q], [vq], [db.bfloat16()], [uv_db], [vdb],
            radius_px=RADIUS, desc_thresh=THRESH)
    assert cuda_matching.LAUNCHES == before

