"""Dense voxel fusion of the port (`vslam_tpu_torch.ops.gridhash`) against
the JAX package's `vslam_tpu.ops.gridhash`, on the same numpy inputs.

Tolerance: the hash, the slot winners (`table_winner`), `cloud_count`,
`insert_epoch` and the colors are integers and must be equal; the cloud's
points are equal to 1e-5 m. The port applies the rotation as elementwise
products summed in a fixed order (so that the CPU and the card round
alike) where the JAX package takes a matrix product, so a point may differ
in its last bit; none of the inputs here lies within that of a voxel face,
and the winners agree exactly. Grouped and per-frame insertion within the
port are held bit for bit, as `tests/test_pipeline.py::
test_dense_fusion_frame_batching_exact` holds them in the JAX package.
`fuse_sequence` (chunks padded with zero-depth frames at identity poses)
is held to the JAX package's under the same tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vslam_tpu.ops import gridhash as j_gh
from vslam_tpu_torch.ops import gridhash as t_gh

INT_MIN, INT_MAX = -(2 ** 31), 2 ** 31 - 1


def _np(state):
    return [np.asarray(x) for x in state]


def _t_np(state):
    return [x.numpy() for x in state]


def _assert_maps_equal(a, b, xyz_atol=1e-5):
    """a, b: (table_winner, cloud_xyz, cloud_rgb, cloud_count, insert_epoch) numpy."""
    np.testing.assert_array_equal(a[0], b[0], err_msg="table_winner")
    assert int(a[3]) == int(b[3]) and int(a[4]) == int(b[4])
    n = int(a[3])
    np.testing.assert_allclose(a[1][:n], b[1][:n], atol=xyz_atol, rtol=0)
    np.testing.assert_array_equal(a[2][:n], b[2][:n])


def test_voxel_hash_wraps_like_jax():
    """int32 products overflow and wrap; abs(INT_MIN) stays INT_MIN and
    the floor remainder maps it into range."""
    rng = np.random.default_rng(0)
    coords = np.concatenate([
        rng.integers(-300, 300, (200, 3)),
        rng.integers(INT_MIN, INT_MAX, (200, 3), endpoint=True),
        [[INT_MIN, 0, 0], [0, INT_MIN, 0], [0, 0, INT_MIN], [INT_MIN] * 3, [INT_MAX] * 3,
         [INT_MIN, INT_MAX, -1], [1, 1, 1], [0, 0, 0]],
    ]).astype(np.int32)
    for cap in (1 << 21, 1 << 12, 1000003):
        got = t_gh.voxel_hash(torch.from_numpy(coords), cap).numpy()
        want = np.asarray(j_gh.voxel_hash(jnp.asarray(coords), cap))
        np.testing.assert_array_equal(got, want)
        assert ((got >= 0) & (got < cap)).all()
    # The raw product overflows int32 here, and the xor of the three can be INT_MIN.
    assert (np.abs(coords[200:400].astype(np.int64) * 73856093) > INT_MAX).any()


def _insert_case(rng, K=600):
    pts = rng.uniform(-1.0, 1.0, (K, 3)).astype(np.float32)
    pts[100:150] = pts[50:100] + 0.001  # in-batch duplicates of earlier points' voxels
    cols = rng.integers(0, 255, (K, 3)).astype(np.uint8)
    valid = rng.random(K) > 0.1
    valid[60] = False  # an invalid point whose voxel a later valid point claims
    return pts, cols, valid


@pytest.mark.parametrize("hash_cap,cloud_cap", [(1 << 14, 4096), (97, 4096), (1 << 14, 40)])
def test_insert_points_vs_jax(hash_cap, cloud_cap):
    """Three inserts: in-batch duplicates and invalid points; a 97-slot
    table where voxels collide with others (dropped); a 40-point cloud
    that fills up (later winners dropped)."""
    rng = np.random.default_rng(1)
    sj = j_gh.init_dense_map(hash_cap, cloud_cap)
    st = t_gh.init_dense_map(hash_cap, cloud_cap, device="cpu")
    for _ in range(3):
        pts, cols, valid = _insert_case(rng)
        sj = j_gh.insert_points(sj, jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid))
        st = t_gh.insert_points(st, torch.from_numpy(pts), torch.from_numpy(cols),
                                torch.from_numpy(valid))
        _assert_maps_equal(_t_np(st), _np(sj), xyz_atol=0)
    n = int(st.cloud_count)
    assert int(st.insert_epoch) == 3 * 600
    if cloud_cap == 40:
        assert n == 40
    elif hash_cap == 97:
        assert n <= 97
    else:
        assert 300 < n < 1800


def _fusion_inputs(seed, N=8, H=24, W=32):
    rng = np.random.default_rng(seed)
    depths = rng.uniform(0.3, 4.0, (N, H, W)).astype(np.float32)
    depths[:, :3] = 0.0  # invalid rows
    depths[-1, :, :5] = 7.0  # beyond max_depth
    rgbs = rng.integers(0, 255, (N, H, W, 3)).astype(np.uint8)
    ang = rng.normal(0, 0.2, (N, 3))
    Rs = np.stack([_rot(a) for a in ang]).astype(np.float32)
    ts = rng.normal(0, 0.05, (N, 3)).astype(np.float32)
    return depths, rgbs, Rs, ts


def _rot(w):
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


INTR = (120.0, 120.0, 15.5, 11.5)


def _fuse_torch(depths, rgbs, Rs, ts, F, cap=(1 << 14, 4096)):
    st = t_gh.init_dense_map(*cap, device="cpu")
    return t_gh.fuse_chunk_scan(
        st, torch.from_numpy(depths), None if rgbs is None else torch.from_numpy(rgbs),
        torch.from_numpy(Rs), torch.from_numpy(ts), *INTR, pixel_step=2, frames_per_step=F)


def test_fuse_grouped_equals_per_frame():
    depths, rgbs, Rs, ts = _fusion_inputs(5)
    a = _t_np(_fuse_torch(depths, rgbs, Rs, ts, 1))
    b = _t_np(_fuse_torch(depths, rgbs, Rs, ts, 4))
    _assert_maps_equal(a, b, xyz_atol=0)
    assert int(a[3]) > 500


@pytest.mark.parametrize("with_rgb", [True, False])
def test_fuse_chunk_scan_vs_jax(with_rgb):
    """The same depths and poses through both packages' fusion."""
    depths, rgbs, Rs, ts = _fusion_inputs(6)
    rgbs = rgbs if with_rgb else None
    got = _t_np(_fuse_torch(depths, rgbs, Rs, ts, 4))
    sj = j_gh.fuse_chunk_scan(
        j_gh.init_dense_map(1 << 14, 4096), jnp.asarray(depths),
        None if rgbs is None else jnp.asarray(rgbs), jnp.asarray(Rs), jnp.asarray(ts), *INTR,
        pixel_step=2, frames_per_step=4)
    _assert_maps_equal(got, _np(sj))
    n = int(got[3])
    assert n > 500 and (with_rgb or not got[2][:n].any())


@pytest.mark.parametrize("chunk, fps", [(4, 16), (3, 2)])
def test_fuse_sequence_vs_jax(chunk, fps):
    """7 frames in chunks of 4 (one padded chunk; 4 frames per insert,
    gcd(4, 16)) or of 3 (two padded frames; gcd(3, 2) = 1 per insert)."""
    depths, rgbs, Rs, ts = _fusion_inputs(8, N=7)
    st = t_gh.fuse_sequence(
        t_gh.init_dense_map(1 << 14, 4096, device="cpu"), torch.from_numpy(depths),
        torch.from_numpy(rgbs), torch.from_numpy(Rs), torch.from_numpy(ts), *INTR,
        pixel_step=2, chunk=chunk, frames_per_step=fps)
    sj = j_gh.fuse_sequence(j_gh.init_dense_map(1 << 14, 4096), depths, rgbs, Rs, ts, *INTR,
                            pixel_step=2, chunk=chunk, frames_per_step=fps)
    got = _t_np(st)
    _assert_maps_equal(got, _np(sj))
    assert int(got[3]) > 500 and int(got[4]) == -(-7 // chunk) * chunk * 12 * 16


def test_backproject_frame_vs_jax():
    depths, rgbs, Rs, ts = _fusion_inputs(7, N=1, H=30, W=41)
    pts, cols, valid = t_gh.backproject_frame(
        torch.from_numpy(depths[0]), torch.from_numpy(rgbs[0]), torch.from_numpy(Rs[0]),
        torch.from_numpy(ts[0]), *INTR, pixel_step=4)
    pj, cj, vj = j_gh.backproject_frame(
        jnp.asarray(depths[0]), jnp.asarray(rgbs[0]), jnp.asarray(Rs[0]), jnp.asarray(ts[0]),
        *INTR, pixel_step=4)
    assert pts.shape == (7 * 10, 3)
    np.testing.assert_allclose(pts.numpy(), np.asarray(pj), atol=1e-6)
    np.testing.assert_array_equal(cols.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(vj))


def test_insert_batch_bound():
    st = t_gh.init_dense_map(64, 16, device="cpu")
    K = t_gh._APPEND_SCRATCH + 1
    with pytest.raises(ValueError):
        t_gh.insert_points(st, torch.zeros(K, 3), torch.zeros(K, 3, dtype=torch.uint8),
                           torch.ones(K, dtype=torch.bool))
    assert t_gh.dense_cloud_capacity(st) == 16
