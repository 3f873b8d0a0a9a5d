"""The port's dataset readers and writer (`vslam_tpu_torch.data.tum`,
`data.loader`, `data.kitti`, `data.synthetic.write_tum_sequence`) against
the JAX package's, on directories built here.

Tolerances: everything parsed or decoded is equal. `write_tum_sequence`
writes the same text files (the ground-truth quaternion columns, computed
by each package's `quat_from_matrix` in f32 and printed at 6 decimals,
within 1e-6), pixel-equal PNGs and the same feature caches.
"""

import os

import cv2
import numpy as np
import pytest

from vslam_tpu.data import kitti as j_kitti
from vslam_tpu.data import loader as j_loader
from vslam_tpu.data import synthetic as j_syn
from vslam_tpu.data import tum as j_tum
from vslam_tpu_torch.data import kitti as t_kitti
from vslam_tpu_torch.data import loader as t_loader
from vslam_tpu_torch.data import synthetic as t_syn
from vslam_tpu_torch.data import tum as t_tum


def _write_frames(root, stamps, rng, depth_stamps=None):
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    for ts in stamps:
        cv2.imwrite(os.path.join(root, "rgb", f"{ts:.6f}.png"),
                    rng.integers(0, 256, (12, 16, 3), dtype=np.uint8))
    for ts in depth_stamps if depth_stamps is not None else stamps:
        cv2.imwrite(os.path.join(root, "depth", f"{ts:.6f}.png"),
                    rng.integers(0, 65535, (12, 16), dtype=np.uint16))


def _write_imu_gt(root, rng):
    with open(os.path.join(root, "accelerometer.txt"), "w") as f:
        f.write("# accelerometer data\n# timestamp ax ay az\n")
        for r in rng.normal(size=(7, 4)):
            f.write(" ".join(f"{v:.6f}" for v in r) + "\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("# ground truth\n\n")
        for r in rng.normal(size=(5, 8)):
            f.write(" ".join(f"{v:.4f}" for v in r) + "\n")
        f.write("1.0 2.0 3.0\n")  # short line: skipped


def _same_sequence(a, b):
    assert len(a) == len(b) > 0
    for fa, fb in zip(a.frames, b.frames):
        assert (fa.timestamp, fa.rgb_path, fa.depth_path) == (fb.timestamp, fb.rgb_path,
                                                              fb.depth_path)
    for name in ("accel", "gt"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


@pytest.fixture
def associations_dir(tmp_path, rng):
    root = str(tmp_path / "assoc")
    stamps = [1.0 + 0.033 * i for i in range(5)]
    _write_frames(root, stamps, rng)
    with open(os.path.join(root, "associations.txt"), "w") as f:
        f.write("# associations\n")
        for i, ts in enumerate(stamps):
            rgb, dep = f"rgb/{ts:.6f}.png", f"depth/{ts:.6f}.png"
            # Both column orders: rgb first, then depth first.
            f.write(f"{ts:.6f} {rgb} {ts:.6f} {dep}\n" if i % 2 == 0
                    else f"{ts:.6f} {dep} {ts:.6f} {rgb}\n")
    _write_imu_gt(root, rng)
    return root


def test_associations_both_column_orders(associations_dir):
    a, b = j_tum.load_sequence(associations_dir), t_tum.load_sequence(associations_dir)
    _same_sequence(a, b)
    assert all(f.rgb_path.split(os.sep)[-2] == "rgb" for f in b.frames)
    assert b.accel.shape == (7, 4) and b.gt.shape == (5, 8)


def test_rgb_depth_lists_pair_within_20_ms(tmp_path, rng):
    root = str(tmp_path / "lists")
    stamps = [2.0, 2.1, 2.2, 2.3]
    # depth stamps: 5 ms off, 19 ms off, 30 ms off (unpaired), exact
    dstamps = [2.005, 2.119, 2.23, 2.3]
    _write_frames(root, stamps, rng, dstamps)
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("# rgb\n" + "".join(f"{t:.6f} rgb/{t:.6f}.png\n" for t in stamps))
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("# depth\n" + "".join(f"{t:.6f} depth/{t:.6f}.png\n" for t in dstamps))
    a, b = j_tum.load_sequence(root), t_tum.load_sequence(root)
    _same_sequence(a, b)
    assert [f.depth_path is None for f in b.frames] == [False, False, True, False]
    assert b.accel is None and b.gt is None


def test_rgb_directory_scan(tmp_path, rng):
    root = str(tmp_path / "scan")
    _write_frames(root, [3.25, 3.5, 3.0], rng)
    a, b = j_tum.load_sequence(root), t_tum.load_sequence(root)
    _same_sequence(a, b)
    assert [f.timestamp for f in b.frames] == [3.0, 3.25, 3.5]
    assert all(f.depth_path is None for f in b.frames)


def test_loader_get_and_frames(associations_dir):
    a = j_loader.PythonSequenceLoader(associations_dir, width=16, height=12)
    b = t_loader.open_sequence(associations_dir, width=16, height=12)
    assert len(a) == len(b) == 5
    np.testing.assert_array_equal(a.timestamps(), b.timestamps())
    b.prefetch(0, 2, 3)
    for (ra, da, ta), (rb, db, tb) in zip(a.frames(2), b.frames(2)):
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(da, db)
        assert ta == tb and rb.dtype == np.uint8 and db.dtype == np.float32


def test_loader_without_depth_gives_zeros(tmp_path, rng):
    root = str(tmp_path / "scan")
    _write_frames(root, [1.0, 2.0], rng)
    rgb, depth, ts = t_loader.open_sequence(root, width=16, height=12).get(1)
    assert ts == 2.0 and depth.shape == rgb.shape[:2] and not depth.any()
    with pytest.raises(ValueError, match="16x12, expected 640x480"):
        t_loader.open_sequence(root).get(1)  # the native reader's size check


@pytest.mark.parametrize("with_calib_and_poses", [True, False])
def test_kitti_sequence(tmp_path, rng, with_calib_and_poses):
    seq_dir = tmp_path / "sequences" / "07"
    img_dir = seq_dir / "image_0"
    img_dir.mkdir(parents=True)
    for i in range(4):
        cv2.imwrite(str(img_dir / f"{i:06d}.png"), rng.integers(0, 256, (8, 10), np.uint8))
    if with_calib_and_poses:
        np.savetxt(seq_dir / "times.txt", np.arange(4) * 0.103)
        with open(seq_dir / "calib.txt", "w") as f:
            for c in range(4):
                f.write(f"P{c}: " + " ".join(f"{v:.4f}" for v in rng.normal(size=12)) + "\n")
        (tmp_path / "poses").mkdir()
        np.savetxt(tmp_path / "poses" / "07.txt", rng.normal(size=(4, 12)))
    a, b = j_kitti.load_sequence(str(seq_dir)), t_kitti.load_sequence(str(seq_dir))
    assert a.image_paths == b.image_paths and len(b) == 4
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    assert (a.fx, a.fy, a.cx, a.cy) == (b.fx, b.fy, b.cx, b.cy)
    for name in ("gt_R", "gt_t"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None) == (not with_calib_and_poses)
        if x is not None:
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(j_kitti.load_gray(a.image_paths[2]),
                                  t_kitti.load_gray(b.image_paths[2]))


@pytest.mark.parametrize("cache", ["sp.npz", "sp.bin"])
def test_write_tum_sequence_vs_jax(tmp_path, cache):
    """160x120, 6 frames: text files equal (quaternions within 1e-6), PNGs
    pixel-equal, the feature cache equal."""
    kw = dict(max_keypoints=64, desc_dim=64, width=160, height=120, fx=120.0, fy=120.0,
              cx=79.5, cy=59.5)
    sj = j_syn.make_room_sequence(num_frames=6, seed=3, **kw)
    st = t_syn.make_room_sequence(num_frames=6, seed=3, **kw)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_syn.write_tum_sequence(dj, sj, write_cache=cache)
    t_syn.write_tum_sequence(dt, st, write_cache=cache)
    for name in ("rgb.txt", "depth.txt", "associations.txt", "accelerometer.txt"):
        with open(os.path.join(dj, name)) as a, open(os.path.join(dt, name)) as b:
            assert a.read() == b.read(), name
    gj = np.loadtxt(os.path.join(dj, "groundtruth.txt"))
    gt = np.loadtxt(os.path.join(dt, "groundtruth.txt"))
    np.testing.assert_array_equal(gj[:, :4], gt[:, :4])
    np.testing.assert_allclose(gj[:, 4:], gt[:, 4:], atol=1e-6 + 1e-9)
    for sub in ("rgb", "depth"):
        names = sorted(os.listdir(os.path.join(dj, sub)))
        assert names == sorted(os.listdir(os.path.join(dt, sub))) and len(names) == 6
        for n in names:
            a = cv2.imread(os.path.join(dj, sub, n), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(os.path.join(dt, sub, n), cv2.IMREAD_UNCHANGED)
            assert a.dtype == b.dtype and (a.dtype == np.uint16) == (sub == "depth")
            np.testing.assert_array_equal(a, b)
    with open(os.path.join(dj, cache), "rb") as a, open(os.path.join(dt, cache), "rb") as b:
        ja, tb = a.read(), b.read()
    if cache.endswith(".bin"):
        assert ja == tb
    else:
        za, zb = np.load(os.path.join(dj, cache)), np.load(os.path.join(dt, cache))
        assert za.files == zb.files
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k])
    a, b = j_tum.load_sequence(dj), t_tum.load_sequence(dt)
    assert [f.timestamp for f in a.frames] == [f.timestamp for f in b.frames]
    np.testing.assert_array_equal(a.accel, b.accel)
