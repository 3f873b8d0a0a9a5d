"""The work counts behind the radius kernels' bound in `chip_smoke.py`.

`radius_work` counts the least work of a radius match on given inputs:
the candidate pairs (row valid, keypoint valid, squared pixel distance
within the radius, computed in f32 as the kernel does), the rows and
keypoints that have one, and from them the floor's bytes and operations.
Here on hand-built inputs whose counts are known exactly; the script
itself needs a card, so it is loaded from its file and only these
functions run.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def hand_built():
    """3 keypoints (the last invalid), 4 rows (the last invalid):
    row 0 sits on keypoint 0, row 1 is 136 px^2 from it, row 2 exactly
    144 px^2 (= 12^2, inside) from keypoint 1; row 3 sits on keypoint 0 but
    is invalid; keypoint 2 is 25 px^2 from row 0 but invalid."""
    uv_q = np.array([[0, 0], [100, 100], [5, 0]], np.float32)
    valid_q = np.array([True, True, False])
    uv_db = np.array([[0, 0], [10, 6], [100, 112], [0, 0]], np.float32)
    valid_db = np.array([True, True, True, False])
    return uv_q, valid_q, uv_db, valid_db


def test_radius_work_counts_a_hand_built_input(smoke):
    w = smoke.radius_work(*hand_built(), D=16, radius_px=12.0)
    assert w["pairs_in_radius"] == 3
    assert w["rows_with_candidates"] == 3
    assert w["keypoints_with_candidates"] == 2
    # pixels + validity of 4 rows and 3 keypoints, descriptors of 3 rows and
    # 2 keypoints, outputs 9 B per keypoint and 4 B per row
    assert w["nbytes"] == 9 * 7 + 2 * 16 * 5 + 9 * 3 + 4 * 4
    assert w["flops"] == 2 * 16 * 3
    b_ms, by = smoke.bound(w["nbytes"], w["flops"])
    assert by == "bytes" and b_ms == pytest.approx(266 / 3.35e12 * 1e3)


def test_radius_work_sums_members_and_takes_tensors(smoke):
    """Members are summed; a member whose rows are all invalid adds its
    pixels, validity and outputs but no descriptor and no operation."""
    uv_q, valid_q, uv_db, valid_db = hand_built()
    dead = valid_db & False
    args = [torch.from_numpy(np.stack(x)) for x in
            ((uv_q, uv_q), (valid_q, valid_q), (uv_db, uv_db), (valid_db, dead))]
    w = smoke.radius_work(*args, D=16, radius_px=12.0)
    assert w["pairs_in_radius"] == 3 and w["rows_with_candidates"] == 3
    assert w["keypoints_with_candidates"] == 2
    assert w["nbytes"] == 266 + (9 * 7 + 9 * 3 + 4 * 4)
    assert w["flops"] == 96


def test_radius_work_dense_disc_counts_every_pair(smoke):
    """Every row and keypoint in one disc of 11.7 px across: all M x K pairs
    are candidates, and the floor becomes the dense count."""
    rng = np.random.default_rng(0)
    M, K, D = 64, 40, 256
    r, a = 5.5 * np.sqrt(rng.random(M + K)), rng.uniform(0, 2 * np.pi, M + K)
    uv = np.round(np.stack([320 + r * np.cos(a), 240 + r * np.sin(a)], -1) * 2) / 2
    w = smoke.radius_work(uv[M:], np.ones(K, bool), uv[:M], np.ones(M, bool), D, 12.0)
    assert w["pairs_in_radius"] == M * K
    assert w["rows_with_candidates"] == M and w["keypoints_with_candidates"] == K
    assert w["flops"] == 2 * D * M * K
    assert w["nbytes"] == smoke._dense_radius_bytes(K, M, D)


def test_radius_work_rounds_like_the_kernel(smoke):
    """Far rows (|uv| ~ 1e6) are never candidates, and the squared distance
    is rounded in f32 at each step: a row 12 px away in f32 sits exactly on
    the radius and counts."""
    uv_q = np.array([[1e6, 1e6], [320, 240]], np.float32)
    uv_db = np.array([[1e6 + 64, 1e6], [332, 240], [-1e6, 3e5]], np.float32)
    w = smoke.radius_work(uv_q, np.ones(2, bool), uv_db, np.ones(3, bool), 32, 12.0)
    assert w["pairs_in_radius"] == 1 and w["rows_with_candidates"] == 1
