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


@pytest.mark.parametrize("M,valid_rows,tiles", [
    (0, [], 0), (17, [3], 1), (130, [0, 64, 129], 3), (130, [63, 64], 2),
    (16384, list(range(5000)), 79), (16383, [16382], 1)])
def test_live_tiles_counts_tiles_with_a_valid_row(smoke, M, valid_rows, tiles):
    """64-row tiles, the last one partial: a tile counts once however many
    of its rows are valid."""
    v = np.zeros(M, bool)
    v[valid_rows] = True
    assert smoke.live_tiles(v) == tiles
    assert smoke.live_tiles(torch.from_numpy(v)) == tiles


def test_top2_work_counts_valid_rows_only(smoke):
    """The floor reads every row's validity and the valid rows' and the
    queries' descriptors, writes 12 B per query, and does 2 D operations
    per (valid row, query) pair; at 400 x 16384 x 256 it is the operations
    that bound it, and a map with no valid row leaves only bytes."""
    v = np.zeros(16384, bool)
    v[:5000] = True
    nbytes, flops = smoke.top2_work(torch.from_numpy(v), 400, 256)
    assert nbytes == 16384 + 2 * 256 * (5000 + 400) + 12 * 400
    assert flops == 2 * 256 * 5000 * 400
    b_ms, by = smoke.bound(nbytes, flops)
    assert by == "operations" and b_ms == pytest.approx(flops / 989e12 * 1e3)
    assert smoke.bound(*smoke.top2_work(v & False, 400, 256))[1] == "bytes"


@pytest.mark.parametrize("atol", [0.0, 1e-4])
@pytest.mark.parametrize("case", ["tie", "all_invalid", "empty"])
def test_top2_check_holds_the_tie_rule_and_minus_one(smoke, case, atol):
    """The smoke's top-2 check passes the plain version's own answer and
    counts a kernel that breaks a tie to the higher row (at atol 0, where
    every idx is compared; at atol > 0 a tie is a near-tie and left out) or
    writes 0 in place of -1 where no row is valid (at any atol)."""
    from vslam_tpu_torch.ops import matching

    D = 32
    q = torch.zeros(2, D, dtype=torch.bfloat16)
    q[0, 0] = q[1, 1] = 1
    db = torch.zeros(8, D, dtype=torch.bfloat16)
    db[:, 2] = 1  # every row far from both queries but rows 2, 3 and 5
    db[[2, 3, 5], 2] = 0
    db[[2, 5], 0] = 1  # rows 2 and 5 tie at query 0's best
    db[3, 1] = 1
    valid = torch.ones(8, dtype=torch.bool)
    if case == "all_invalid":
        valid[:] = False
    if case == "empty":
        db, valid = db[:0], valid[:0]
        d1 = d2 = torch.full((2,), 1e9)
        idx = torch.zeros(2, dtype=torch.int32)
    else:
        d1, d2, idx = matching.top2_match_plain(db, valid, q)
    idx = torch.where(d1 < 0.5e9, idx, -1).to(torch.int32)
    assert smoke._top2_mismatches((d1, d2, idx), db, valid, q, atol)[0] == 0
    bad = idx.clone()
    if case == "tie":
        assert idx.tolist() == [2, 3] and d1[0] == d2[0]
        bad[0] = 5
        expected = 0 if atol else 1
    else:
        bad[:] = 0
        expected = 2
    assert smoke._top2_mismatches((d1, d2, bad), db, valid, q, atol)[0] == expected
