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
                                    ("random", 1000)])
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
    assert cuda_matching.LAUNCHES == before

