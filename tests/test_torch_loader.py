"""The port's prefetching `NativeSequenceLoader` against the JAX package's
C++ loader (`vslam_tpu/native/libvtdata.so`, through the JAX package's
own wrapper) and against the cv2 `PythonSequenceLoader`, on the CPU.

Directories of 16x12 frames with each PNG variant the C++ decoder
normalises (8- and 16-bit RGB, RGBA, palette, gray, gray+alpha colour
images; 8- and 16-bit gray depth), `associations.txt` in both column
orders and absent (the `rgb.txt` / `depth.txt` pairing: nearest depth
within 20 ms, a later tie winning, none beyond). Arrays and timestamps
are held equal.
"""

import os
import time

import cv2
import numpy as np
import pytest

from vslam_tpu.data import loader as j_loader
from vslam_tpu_torch.data import loader as t_loader

W, H = 16, 12
NEEDS_LIB = pytest.mark.skipif(not os.path.exists(j_loader._LIB_PATH),
                               reason="the JAX package's native library is not built")
RGB_KINDS = ("rgb8", "rgba", "palette", "gray", "gray_alpha", "rgb16")


def _write_rgb(path, kind, rng):
    from PIL import Image

    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    if kind == "rgb8":
        cv2.imwrite(path, rgb[..., ::-1])
    elif kind == "rgba":
        a = rng.integers(0, 256, (H, W, 1), dtype=np.uint8)
        cv2.imwrite(path, np.concatenate([rgb[..., ::-1], a], -1))
    elif kind == "palette":
        Image.fromarray(rgb).quantize(colors=16).save(path)
    elif kind == "gray":
        cv2.imwrite(path, rgb[..., 0])
    elif kind == "gray_alpha":
        Image.fromarray(rgb[..., :2], mode="LA").save(path)
    elif kind == "rgb16":
        cv2.imwrite(path, rng.integers(0, 65536, (H, W, 3), dtype=np.uint16))


def _write_depth(path, eight_bit, rng):
    if eight_bit:
        cv2.imwrite(path, rng.integers(0, 256, (H, W), dtype=np.uint8))
    else:
        cv2.imwrite(path, rng.integers(0, 65536, (H, W), dtype=np.uint16))


def _write_dir(root, layout, rng):
    """Six frames, one per colour variant, depth alternating 16/8 bit."""
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    stamps = [1.0 + 0.25 * i for i in range(len(RGB_KINDS))]
    rgb_lines, depth_lines, assoc = [], [], []
    for i, (ts, kind) in enumerate(zip(stamps, RGB_KINDS)):
        rp, dp = f"rgb/{ts:.6f}.png", f"depth/{ts:.6f}.png"
        _write_rgb(os.path.join(root, rp), kind, rng)
        _write_depth(os.path.join(root, dp), i % 2 == 1, rng)
        rgb_lines.append(f"{ts:.6f} {rp}")
        if layout == "assoc":
            assoc.append(f"{ts:.6f} {rp} {ts:.6f} {dp}")
        elif layout == "assoc_swapped":
            assoc.append(f"{ts:.6f} {dp} {ts:.6f} {rp}")
    if assoc:
        with open(os.path.join(root, "associations.txt"), "w") as f:
            f.write("# associations\n" + "\n".join(assoc) + "\n")
    else:
        # Frame 0: two depths 1/128 s away on either side (a tie: the later
        # line wins); frame 1: one depth 1/32 s away (beyond 20 ms: none);
        # frame 2: its own stamp and one 1/64 s off (the exact one wins);
        # the rest their own stamps.
        extra = {0: [1.0 - 1 / 128, 1.0 + 1 / 128], 1: [1.25 + 1 / 32],
                 2: [1.5 + 1 / 64, 1.5]}
        for i, ts in enumerate(stamps):
            for dts in extra.get(i, [ts]):
                dp = f"depth/{dts:.7f}.png"
                _write_depth(os.path.join(root, dp), False, rng)
                depth_lines.append(f"{dts:.7f} {dp}")
        with open(os.path.join(root, "depth.txt"), "w") as f:
            f.write("# depth\n" + "\n".join(depth_lines) + "\n")
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("# rgb\n\n" + "\n".join(rgb_lines) + "\n")
    return stamps


@pytest.fixture(params=["assoc", "assoc_swapped", "lists"])
def tum_dir(tmp_path, request):
    root = str(tmp_path / request.param)
    _write_dir(root, request.param, np.random.default_rng(3))
    return root


def _same(a, b):
    (ra, da, ta), (rb, db, tb) = a, b
    np.testing.assert_array_equal(ra, rb)
    np.testing.assert_array_equal(da, db)
    assert ta == tb and ra.dtype == rb.dtype == np.uint8 and da.dtype == db.dtype == np.float32


@NEEDS_LIB
def test_frames_equal_the_native_library(tum_dir):
    want = j_loader.NativeSequenceLoader(tum_dir, width=W, height=H)
    got = t_loader.open_sequence(tum_dir, width=W, height=H)
    assert isinstance(got, t_loader.NativeSequenceLoader)
    assert len(got) == len(want) == len(RGB_KINDS)
    np.testing.assert_array_equal(got.timestamps(), want.timestamps())
    for i in range(len(got)):
        _same(got.get(i), want.get(i))
    want.close()
    got.close()


@NEEDS_LIB
def test_depth_pairing_without_associations(tmp_path):
    root = str(tmp_path / "lists")
    _write_dir(root, "lists", np.random.default_rng(4))
    got = t_loader.NativeSequenceLoader(root, width=W, height=H)
    names = [None if d is None else os.path.basename(d) for _, _, d in got.entries]
    assert names[:3] == [f"{1.0 + 1 / 128:.7f}.png", None, f"{1.5:.7f}.png"]
    want = j_loader.NativeSequenceLoader(root, width=W, height=H)
    for i in range(3):
        _same(got.get(i), want.get(i))
    assert not got.get(1)[1].any()  # no depth within 20 ms: zeros
    want.close()


@NEEDS_LIB
def test_prefetched_stream_and_a_frame_never_queued(tmp_path):
    root = str(tmp_path / "assoc")
    _write_dir(root, "assoc", np.random.default_rng(5))
    want = j_loader.NativeSequenceLoader(root, width=W, height=H)
    ref = [want.get(i) for i in range(len(RGB_KINDS))]
    got = t_loader.NativeSequenceLoader(root, width=W, height=H, workers=2)
    stream = list(got.frames(step=2))
    assert len(stream) == 3
    for k, fr in enumerate(stream):
        _same(fr, ref[2 * k])
    assert not got._done  # fetched frames are freed
    got.prefetch(0, 2, 2)  # frames 0 and 2 only
    t0 = time.perf_counter()
    _same(got.get(3), ref[3])  # never queued: decoded at once
    assert time.perf_counter() - t0 < 2.0
    _same(got.get(2), ref[2])
    threads = list(got._threads)
    got.close()
    for t in threads:
        t.join(timeout=5)
    assert threads and not any(t.is_alive() for t in threads)
    want.close()


def test_equals_the_cv2_reader_and_checks_the_size(tmp_path):
    root = str(tmp_path / "plain")
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    rng = np.random.default_rng(6)
    lines = []
    for i in range(4):
        ts = 2.0 + 0.5 * i
        _write_rgb(os.path.join(root, f"rgb/{ts:.6f}.png"), "rgb8", rng)
        _write_depth(os.path.join(root, f"depth/{ts:.6f}.png"), False, rng)
        lines.append(f"{ts:.6f} rgb/{ts:.6f}.png {ts:.6f} depth/{ts:.6f}.png")
    with open(os.path.join(root, "associations.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    py = t_loader.open_sequence(root, prefer_native=False, width=W, height=H)
    assert isinstance(py, t_loader.PythonSequenceLoader)
    nat = t_loader.open_sequence(root, width=W, height=H, workers=3)
    np.testing.assert_array_equal(nat.timestamps(), py.timestamps())
    for a, b in zip(nat.frames(), py.frames()):
        _same(a, b)
    with pytest.raises(ValueError, match="16x12, expected 640x480"):
        t_loader.NativeSequenceLoader(root).get(0)
    with pytest.raises(IOError, match="frame 9"):
        nat.get(9)
    nat.close()


def test_many_decode_threads_lose_no_frame(tmp_path):
    """More decode threads than cores, every frame queued twice and fetched
    in reverse order: each fetch returns its own frame's bytes, and close
    stops every thread."""
    root = str(tmp_path / "assoc")
    _write_dir(root, "assoc", np.random.default_rng(7))
    want = [t_loader.decode_rgb(e[1]) for e in t_loader.sequence_entries(root)]
    ld = t_loader.NativeSequenceLoader(root, width=W, height=H, workers=4 * os.cpu_count())
    ld.prefetch()
    ld.prefetch()
    for i in reversed(range(len(ld))):
        np.testing.assert_array_equal(ld.get(i)[0], want[i])
    threads = list(ld._threads)
    assert len(threads) == 4 * os.cpu_count()
    ld.close()
    for t in threads:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in threads)
