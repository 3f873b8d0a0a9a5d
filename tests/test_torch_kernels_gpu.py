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
to 0.5 px^2 (the plain version's |a|^2+|b|^2-2ab rounding at |uv| ~ 640).
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


def _inputs(seed, M, K, D, dev):
    rng = np.random.default_rng(seed)

    def qdesc(n):
        x = rng.normal(size=(n, D))
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        return np.round(x * 256) / 256

    db, q = qdesc(M), qdesc(K)
    near = K // 2
    rows = rng.choice(M, near, replace=False)
    db[rows] = q[:near] + rng.integers(-2, 3, (near, D)) / 256
    uv_db = np.round(rng.uniform(0, 640, (M, 2)) * 2) / 2
    uv_q = np.round(rng.uniform(0, 640, (K, 2)) * 2) / 2
    uv_q[:near] = uv_db[rows] + np.round(rng.normal(0, 4, (near, 2)) * 2) / 2
    vq, vdb = rng.random(K) > 0.1, rng.random(M) > 0.15
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


@pytest.mark.parametrize("M,K,D", [(2048, 96, 64), (1000, 96, 64), (16383, 400, 256)])
def test_top2_kernel_matches_plain(dev, M, K, D):
    q, _, _, db, _, vdb = _inputs(1, M, K, D, dev)
    n0 = cuda_matching.LAUNCHES["top2_match"]
    d1, d2, idx = cuda_matching.top2_match(db, vdb, q)
    p1, p2, pidx = matching.top2_match_plain(db, vdb, q)
    torch.cuda.synchronize()
    assert cuda_matching.LAUNCHES["top2_match"] == n0 + 1
    assert torch.equal(d1, p1) and torch.equal(d2, p2) and torch.equal(idx, pidx)


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
