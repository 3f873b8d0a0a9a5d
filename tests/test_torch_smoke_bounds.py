"""The work counts behind the radius kernels' bound in `chip_smoke.py`,
and the checks of its loop phase.

`radius_work` counts the least work of a radius match on given inputs:
the candidate pairs (row valid, keypoint valid, squared pixel distance
within the radius, computed in f32 as the kernel does), the rows and
keypoints that have one, and from them the floor's bytes and operations.
Here on hand-built inputs whose counts are known exactly; the script
itself needs a card, so it is loaded from its file and only these
functions run.

The loop phase's checks (`stress_ate_limits`, `recovery_attempts`,
`loop_failures`, `drift_ring`, `compare_folds`) are pinned the same way:
the ATE limit rule, at least one loop constraint, the launch
equalities, the keyframe and tracked-fraction bounds, and the card-vs-CPU
fold comparison with its 1e-3 tolerance and equal decisions.

So are the side phases' checks (`side_ate_limit`, `side_tracked_floor`,
`side_failures`: twice JAX's CPU ATE, at least 0.02 m on the RGB-D
worlds, JAX's tracked fraction less 0.05, the radius kernel once per
tracked frame and top-2 once per recovery attempt) and the outputs
phase's checkpoint-resume comparison (`resume_mismatches`: every leaf
equal to the last digit).
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


def test_stress_ate_limits_are_twice_jax_or_two_cm(smoke):
    lim = smoke.stress_ate_limits(dict(ate_raw_m=0.046, ate_smoothed_m=0.004,
                                       ate_backend_m=0.01))
    assert lim == pytest.approx(dict(ate_raw_m=0.092, ate_smoothed_m=0.02, ate_backend_m=0.02))
    default = smoke.stress_ate_limits()
    for k in ("ate_raw_m", "ate_smoothed_m", "ate_backend_m"):
        assert default[k] == pytest.approx(max(2 * smoke.JAX_STRESS[k], 0.02))


@pytest.mark.parametrize("nm, rec, attempts", [
    ([400, 10, 10, 10], [0, 0, 0, 0], 3),      # lost frames, no recovery: every one tries
    ([400, 10, 10, 10], [0, 1, 0, 0], 1),      # a recovery starts the 10-frame cooldown
    ([0, 50, 29, 30, 31], [0, 0, 0, 0, 0], 1),  # the first frame bootstraps; 30 is enough
    ([400] + [5] * 13, [0, 1] + [0] * 12, 3),  # frames 2-11 wait out the cooldown
])
def test_recovery_attempts_follow_the_cooldown(smoke, nm, rec, attempts):
    assert smoke.recovery_attempts(np.array(nm), np.array(rec, bool), 30, 10) == attempts


def _loop_result(smoke, **kw):
    lim = smoke.stress_ate_limits()
    res = dict(loop_constraints=1, ate_raw_m=lim["ate_raw_m"] - 1e-6, ate_smoothed_m=0.03,
               ate_backend_m=0.03, tracked_frac=0.99, keyframes=smoke.JAX_STRESS["keyframes"],
               radius_launches=895, track_frames=895, top2_launches=4, recovery_attempts=4,
               backend_identity=False)
    res.update(kw)
    return res


@pytest.mark.parametrize("change, needle", [
    (dict(), None),
    (dict(loop_constraints=0), "no loop constraint"),
    (dict(ate_raw_m=0.0923), "ate_raw_m"),
    (dict(ate_backend_m=float("inf")), "ate_backend_m"),
    (dict(tracked_frac=0.94), "tracked fraction"),
    (dict(keyframes=60), "keyframes"),
    (dict(keyframes=100), "keyframes"),
    (dict(radius_launches=894), "radius kernel"),
    (dict(top2_launches=5), "top-2 kernel"),
])
def test_loop_failures_name_each_broken_check(smoke, change, needle):
    fails = smoke.loop_failures(_loop_result(smoke, **change))
    if needle is None:
        assert fails == []
    else:
        assert len(fails) == 1 and needle in fails[0]
    # Without a reference run only the loop and launch checks remain.
    reference_free = needle in (None, "no loop constraint", "radius kernel", "top-2 kernel")
    assert smoke.loop_failures(_loop_result(smoke, **change), None) == (
        fails if reference_free else [])


def test_loop_backend_rule_binds_only_where_jax_rejected(smoke):
    """The backend must leave the trajectory bit-equal where JAX's backend
    rejected its pass; JAX's CPU run of s101_l1 accepted it."""
    moved = _loop_result(smoke, backend_identity=False)
    assert smoke.loop_failures(moved) == []
    rejected = dict(smoke.JAX_STRESS, backend_rejected=True)
    assert "backend" in smoke.loop_failures(moved, rejected)[0]
    assert smoke.loop_failures(_loop_result(smoke, backend_identity=True), rejected) == []


def _fold_states(smoke):
    """A small numpy state with a keyframe ring, and its drifted copy."""
    from vslam_tpu_torch.config import tiny_test_config
    from vslam_tpu_torch.core.state import init_state, to_numpy

    st = to_numpy(init_state(tiny_test_config(), device="cpu"))
    kfs = st.keyframes
    fid = np.arange(kfs.frame_id.shape[0], dtype=np.int32) * 5
    st = st._replace(keyframes=kfs._replace(frame_id=fid, valid=np.ones_like(kfs.valid)))
    return st, smoke.drift_ring(st, int(fid.max()) + 1)


def test_drift_ring_pushes_the_ring_and_the_live_pose(smoke):
    st, d = _fold_states(smoke)
    shift = np.linalg.norm(d.keyframes.t - st.keyframes.t, axis=-1)
    assert shift[0] == 0.0 and shift[-1] == pytest.approx(0.5, abs=1e-6)
    assert np.all(np.diff(shift) > 0)
    np.testing.assert_allclose(d.t - st.t, d.keyframes.t[-1] - st.keyframes.t[-1])


@pytest.mark.parametrize("case, bad", [
    ("equal", 0), ("within_tol", 0), ("over_tol", 1), ("solve_differs", 1),
    ("fold_differs", 1)])
def test_compare_folds_holds_decisions_and_tolerance(smoke, case, bad):
    before, _ = _fold_states(smoke)
    folded = before._replace(inrun_corrections=np.asarray(before.inrun_corrections + 1),
                             keyframes=before.keyframes._replace(t=before.keyframes.t + 0.2))
    card, cpu, s_card, s_cpu = folded, folded, 1, 1
    if case == "within_tol":
        cpu = folded._replace(keyframes=folded.keyframes._replace(t=folded.keyframes.t + 9e-4))
    if case == "over_tol":
        cpu = folded._replace(map=folded.map._replace(pos=folded.map.pos + 2e-3))
    if case == "solve_differs":
        s_cpu = 0
    if case == "fold_differs":
        cpu = before
        cpu = cpu._replace(keyframes=folded.keyframes)
    res = smoke.compare_folds(before, card, cpu, s_card, s_cpu)
    assert res["fold_mismatches"] == bad
    assert res["fold_atol"] == 1e-3 and res["fold_step_card"] == 1
    assert res["fold_ring_moved_m"] == pytest.approx(0.2)


@pytest.mark.parametrize("jax_ate, rgbd, limit", [
    (0.104643, False, 0.209286),   # mono: twice JAX, no floor
    (0.004, False, 0.008),         # a monocular run below 1 cm keeps twice JAX
    (0.011518, True, 0.023036),    # noise: twice JAX
    (0.006, True, 0.02),           # an RGB-D world below 1 cm: the 2 cm floor
])
def test_side_ate_limit_is_twice_jax_with_a_floor_for_rgbd(smoke, jax_ate, rgbd, limit):
    assert smoke.side_ate_limit(jax_ate, rgbd) == pytest.approx(limit)
    assert smoke.side_tracked_floor(0.9606) == pytest.approx(0.9106)


def test_side_limits_cover_every_side_world(smoke):
    assert set(smoke.SIDE_JAX) == set(smoke.SIDE_WORLDS)
    for name, spec in smoke.SIDE_WORLDS.items():
        assert spec["sim3"] == spec["zero_depth"]
        assert (not spec["depthnet"]) or spec["zero_depth"]


def _side_result(smoke, name="mono", **kw):
    jax_fig = smoke.SIDE_JAX[name]
    rgbd = not smoke.SIDE_WORLDS[name]["zero_depth"]
    res = dict(poses_finite=True, ate_m=smoke.side_ate_limit(jax_fig["ate_m"], rgbd) - 1e-6,
               tracked_frac=smoke.side_tracked_floor(jax_fig["tracked_frac"]),
               radius_launches=127, track_frames=127, top2_launches=3, recovery_attempts=3)
    res.update(kw)
    return smoke.side_failures(res, jax_fig, rgbd)


@pytest.mark.parametrize("name", ["mono", "mono_depth", "noise", "holdout_s40", "holdout_s41"])
@pytest.mark.parametrize("change, needle", [
    (dict(), None),
    (dict(poses_finite=False), "non-finite"),
    (dict(ate_m=float("inf")), "ATE"),
    (dict(tracked_frac=0.8), "tracked fraction"),
    (dict(radius_launches=126), "radius kernel"),
    (dict(top2_launches=0), "top-2 kernel"),
])
def test_side_failures_name_each_broken_check(smoke, name, change, needle):
    fails = _side_result(smoke, name, **change)
    if needle is None:
        assert fails == []
    else:
        assert len(fails) == 1 and needle in fails[0]


def test_side_ate_limit_binds_at_the_limit(smoke):
    lim = smoke.side_ate_limit(smoke.SIDE_JAX["noise"]["ate_m"], True)
    assert _side_result(smoke, "noise", ate_m=lim) == []
    assert "ATE" in _side_result(smoke, "noise", ate_m=lim + 1e-6)[0]


def test_resume_mismatches_find_any_leaf_that_differs(smoke):
    """Every leaf of two states, the nested EKF and map included, down to
    one bit of one element; dtype and shape count too."""
    from vslam_tpu_torch.config import tiny_test_config
    from vslam_tpu_torch.core.state import clone_tree, init_state

    st = init_state(tiny_test_config(), device="cpu")
    assert smoke.resume_mismatches(st, clone_tree(st)) == []
    other = clone_tree(st)
    other.map.pos[3, 1] = torch.nextafter(torch.tensor(0.0), torch.tensor(1.0))
    other.ekf.P[0, 0] += 1e-7
    assert smoke.resume_mismatches(st, other) == ["ekf.P", "map.pos"]
    assert smoke.resume_mismatches(st, st._replace(frame_idx=st.frame_idx.to(torch.int64))) == [
        "frame_idx"]
    assert smoke.resume_mismatches(st, st._replace(inrun_corrections=None)) == [
        "inrun_corrections"]


# ---------------------------------------------------------------------------
# The app phase's checks: ATE limits from the JAX app's CPU runs, the
# launch equalities, the files read back, the card-vs-CPU Poisson mesh
# and ORB comparisons, and that a failed check ends the script non-zero.
# ---------------------------------------------------------------------------

APP_RUNS = ["sp_rgbd", "cache_ba", "orb", "mono_midas", "live"]


def test_app_limits_cover_every_run(smoke):
    assert set(smoke.APP_JAX) == {"sp_rgbd", "cache_ba", "orb", "mono_midas", "live_seg0",
                                  "live_seg1"}
    for fig in smoke.APP_JAX.values():
        assert all(v is not None and v > 0 for v in fig.values())
    for run in APP_RUNS:
        limits = smoke.app_ate_limits(run)
        assert limits and all(v > 0 for v in limits.values())


@pytest.mark.parametrize("run, keys", [
    ("sp_rgbd", {"ate_raw_m", "ate_sim3_m"}),
    ("mono_midas", {"ate_sim3_m"}),
    ("live", {"ate_seg0_sim3_m", "ate_seg1_sim3_m"}),
])
def test_app_ate_limits_are_twice_jax_with_the_rgbd_floor(smoke, run, keys):
    fig = {k: dict(raw=0.004, sim3=0.03) for k in smoke.APP_JAX}
    limits = smoke.app_ate_limits(run, fig)
    assert set(limits) == keys
    for k, v in limits.items():
        if "sim3" in k:
            assert v == pytest.approx(0.06)
        else:
            assert v == pytest.approx(0.02)  # twice 0.004 is under the 2 cm floor
    mono = smoke.app_ate_limits("mono_midas", {**fig, "mono_midas": dict(raw=1, sim3=0.004)})
    assert mono == {"ate_sim3_m": pytest.approx(0.008)}  # no floor without depth


def _app_result(smoke, run="sp_rgbd", **kw):
    limits = smoke.app_ate_limits(run)
    res = {k: v - 1e-6 for k, v in limits.items()}
    res.update(poses_finite=True, tracked_frac=0.95, radius_launches=95, track_frames=95,
               top2_launches=2, recovery_attempts=2, radius_batched_launches=0,
               files={"estimated_trajectory.txt": True, "viewer.html": True})
    res.update(kw)
    return smoke.app_failures(res, limits, run != "mono_midas")


@pytest.mark.parametrize("run", APP_RUNS)
@pytest.mark.parametrize("change, needle", [
    (dict(), None),
    (dict(poses_finite=False), "non-finite"),
    (dict(tracked_frac=0.9), "tracked fraction"),
    (dict(radius_launches=94), "radius kernel"),
    (dict(top2_launches=1), "top-2 kernel"),
    (dict(radius_batched_launches=1), "batched"),
    (dict(files={"viewer.html": False}), "viewer.html"),
])
def test_app_failures_name_each_broken_check(smoke, run, change, needle):
    fails = _app_result(smoke, run, **change)
    if run == "mono_midas" and needle == "tracked fraction":
        needle = None  # the monocular run holds no tracked fraction
    if needle is None:
        assert fails == []
    else:
        assert len(fails) == 1 and needle in fails[0]


@pytest.mark.parametrize("run", APP_RUNS)
def test_app_ate_limit_binds_at_the_limit(smoke, run):
    for key, lim in smoke.app_ate_limits(run).items():
        assert _app_result(smoke, run, **{key: lim}) == []
        fails = _app_result(smoke, run, **{key: lim + 1e-6})
        assert len(fails) == 1 and key in fails[0]


def test_radius_launches_equal_tracked_frames(smoke):
    assert _app_result(smoke, radius_launches=95, track_frames=95) == []
    assert "95 tracked frames" in _app_result(smoke, radius_launches=96, track_frames=95)[0]


def _sphere_mesh(n=400, jitter=0.0, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v += rng.normal(0, jitter, v.shape) if jitter else 0.0
    faces = np.stack([np.arange(n - 2), np.arange(1, n - 1), np.arange(2, n)], -1)
    return v.astype(np.float32), faces.astype(np.int32)


def test_mesh_failures_hold_counts_and_distance(smoke):
    cell = 0.02
    a = _sphere_mesh()
    assert smoke.mesh_failures(a, a, cell) == ([], 0.0)
    near = (a[0] + np.float32(0.4 * smoke.MESH_DIST_FRAC * cell), a[1])
    fails, dist = smoke.mesh_failures(near, a, cell)
    assert fails == [] and 0 < dist <= smoke.MESH_DIST_FRAC * cell
    far = (a[0] + np.float32(smoke.MESH_DIST_FRAC * cell), a[1])
    fails, _ = smoke.mesh_failures(far, a, cell)
    assert len(fails) == 1 and "nearest-vertex distance" in fails[0]
    fewer = (a[0][:390], a[1][:390])  # 2.5% fewer vertices and faces
    fails, _ = smoke.mesh_failures(fewer, a, cell)
    assert "vertex count" in fails[0] and "face count" in fails[1]
    one_less = (a[0], a[1][:-1])  # within the 1% share
    assert smoke.mesh_failures(one_less, a, cell)[0] == []
    fails, dist = smoke.mesh_failures((a[0][:0], a[1][:0]), a, cell)
    assert "empty mesh" in fails and dist == float("inf")


def test_orb_mismatches_count_keypoints_and_bits(smoke):
    rng = np.random.default_rng(0)
    xy = torch.from_numpy(rng.uniform(0, 100, (2, 8, 2)).astype(np.float32))
    score = torch.rand(2, 8)
    valid = torch.ones(2, 8, dtype=torch.bool)
    desc = torch.from_numpy(np.sign(rng.normal(size=(2, 8, 256))).astype(np.float32))
    a = (xy, score, valid, desc)
    assert smoke.orb_mismatches(a, a) == (0, 0.0)
    d2 = desc.clone()
    d2[0, 0, :4] *= -1
    xy2 = xy.clone()
    xy2[1, 3, 0] += 1
    kp, bits = smoke.orb_mismatches((xy2, score, valid, d2), a)
    assert kp == 1 and bits == pytest.approx(4 / (2 * 8 * 256))


def test_a_failed_check_exits_non_zero(smoke, capsys):
    with pytest.raises(SystemExit) as e:
        smoke.fail("app phase: sp_rgbd: ATE")
    assert e.value.code == 1
    assert "FAIL: app phase" in capsys.readouterr().err


# ------------------------------------------------------------ train phase
#
# The train phase's comparators (`step_failures`, `eval_failures`,
# `loss_falls`, `render_failures`), each passing at its limit and failing
# just outside it.


def test_train_limits_are_pinned(smoke):
    assert smoke.TRAIN_LOSS_RTOL == 1e-4 and smoke.TRAIN_FLIP_SHARE == 0.01
    assert smoke.EVAL_SP_ATOL == {"repeatability": 0.01, "match_precision": 0.005}
    assert smoke.EVAL_DN_ATOL == {"abs_rel": 2e-5, "rmse_log": 2e-5, "delta_1.25": 2e-4}
    assert smoke.RENDER_MIN_LIT == 20_000 and smoke.RENDER_MIN_SPARSE == 100
    for atol, jax_fig in ((smoke.EVAL_SP_ATOL, smoke.EVAL_SP_JAX),
                          (smoke.EVAL_DN_ATOL, smoke.EVAL_DN_JAX)):
        assert set(atol) <= set(jax_fig)
    assert smoke.TRAIN_SP["batch"] == 16 and smoke.TRAIN_SP["mix_shapes"] == 0.25
    assert smoke.TRAIN_DN["batch"] == 8


def _step(loss, delta, det=None):
    losses = {"loss": loss} if det is None else {"loss": loss, "det": det}
    return {"losses": losses, "delta": np.asarray(delta, np.float64)}


def test_step_failures_hold_loss_and_flip_share(smoke):
    lr, n = 1e-3, 1000
    base = np.full(n, lr)
    cpu = _step(10.0, base, det=8.0)
    assert smoke.step_failures(_step(10.0, base, det=8.0), cpu, lr) == ([], 0.0)
    at = _step(10.0 * (1 + 0.999 * smoke.TRAIN_LOSS_RTOL), base, det=8.0)
    assert smoke.step_failures(at, cpu, lr)[0] == []
    out = _step(10.0 * (1 + 1.001 * smoke.TRAIN_LOSS_RTOL), base, det=8.0)
    fails, _ = smoke.step_failures(out, cpu, lr)
    assert len(fails) == 1 and fails[0].startswith("loss")
    k = int(smoke.TRAIN_FLIP_SHARE * n)
    flipped = base.copy()
    flipped[:k] = -lr  # a sign flip on exactly the allowed share
    fails, share = smoke.step_failures(_step(10.0, flipped, det=8.0), cpu, lr)
    assert fails == [] and share == pytest.approx(smoke.TRAIN_FLIP_SHARE)
    flipped[: k + 1] = -lr
    fails, share = smoke.step_failures(_step(10.0, flipped, det=8.0), cpu, lr)
    assert len(fails) == 1 and "updated apart" in fails[0]
    small = base + 0.49 * lr  # under half a learning rate apart: not a flip
    assert smoke.step_failures(_step(10.0, small, det=8.0), cpu, lr) == ([], 0.0)


@pytest.mark.parametrize("which", ["SP", "DN"])
def test_eval_failures_bind_at_each_distance(smoke, which):
    want = getattr(smoke, f"EVAL_{which}_JAX")
    atol = getattr(smoke, f"EVAL_{which}_ATOL")
    assert smoke.eval_failures(dict(want), want, atol) == []
    for k, a in atol.items():
        at = dict(want, **{k: want[k] + 0.999 * a})
        assert smoke.eval_failures(at, want, atol) == []
        out = dict(want, **{k: want[k] - 1.001 * a})
        fails = smoke.eval_failures(out, want, atol)
        assert len(fails) == 1 and fails[0].startswith(k)


def test_loss_falls_compares_first_and_last_scan(smoke):
    first, last, fell = smoke.loss_falls([5, 4, 3, 3, 2, 2], 2)
    assert (first, last, fell) == (4.5, 2.0, True)
    assert not smoke.loss_falls([2, 2, 3, 3], 2)[2]
    assert not smoke.loss_falls([2, 2, 2, 2], 2)[2]
    assert not smoke.loss_falls([2, 2, 1, float("nan")], 2)[2]


def _scene(lit, cyan):
    """A BGR frame with `lit` lit pixels, `cyan` of them the sparse map's."""
    im = np.zeros((768, 1024, 3), np.uint8)
    flat = im.reshape(-1, 3)
    flat[:lit] = (40, 200, 90)
    flat[:cyan] = (255, 255, 0)
    return im


def test_render_failures_count_and_blank(smoke):
    lit = _scene(smoke.RENDER_MIN_LIT, smoke.RENDER_MIN_SPARSE)
    assert smoke.render_stats(lit) == (smoke.RENDER_MIN_LIT, smoke.RENDER_MIN_SPARSE)
    assert smoke.render_failures(96, [lit] * 24) == []  # every = 4
    assert smoke.render_failures(8, [lit] * 8) == []  # every = 1
    assert smoke.render_failures(97, [lit] * 25) == []  # ceil(97 / 4)
    fails = smoke.render_failures(96, [lit] * 23)
    assert len(fails) == 1 and "23 scene frames" in fails[0]
    dim = _scene(smoke.RENDER_MIN_LIT - 1, smoke.RENDER_MIN_SPARSE)
    fails = smoke.render_failures(96, [lit] * 23 + [dim])
    assert len(fails) == 1 and fails[0].startswith("1 blank or unreadable frames")
    fails = smoke.render_failures(96, [lit] * 23 + [None])
    assert len(fails) == 1 and fails[0].startswith("1 blank or unreadable frames")
    nomap = _scene(smoke.RENDER_MIN_LIT, smoke.RENDER_MIN_SPARSE - 1)
    fails = smoke.render_failures(96, [lit] * 23 + [nomap])
    assert len(fails) == 1 and fails[0].startswith("1 frames without the sparse map")


def test_mesh_phase_limits_are_pinned(smoke):
    """The mesh phase: `run_batch`'s ATE limit is twice JAX's CPU figure,
    at least 0.02 m; the run arguments and bench sweep as stated."""
    assert smoke.RUN_BATCH_JAX == 0.020734
    assert smoke.run_batch_ate_limit() == pytest.approx(0.041468)
    assert smoke.run_batch_ate_limit(0.004) == 0.02
    assert smoke.RUN_BATCH_ARGS == ["--devices", "1", "--frames", "64", "--frame-step", "3"]
    assert smoke.BENCH_ARGS == ["--n", "16", "--b", "4", "--bs", "1,2,4"]
    assert (smoke.MESH_FRAMES, smoke.MESH_CHUNK, smoke.VMAP_FRAMES, smoke.VMAP_B) == (64, 32,
                                                                                  32, 2)


def test_tree_mismatches_compare_every_bit(smoke):
    """Equal trees give no mismatch; a sign of zero, one ulp, a NaN
    payload, a flag or a bf16 bit in any leaf is one."""
    from vslam_tpu_torch.core.state import FrameFeatures

    def tree():
        return FrameFeatures(xy=torch.zeros(4, 2), desc=torch.ones(4, 8, dtype=torch.bfloat16),
                             depth=torch.full((4,), float("nan")),
                             valid=torch.ones(4, dtype=torch.bool), timestamp=torch.tensor(1.0),
                             stationary=torch.tensor(False),
                             frame_id=torch.tensor(3, dtype=torch.int32))

    assert smoke.tree_mismatches(tree(), tree()) == []
    for i, edit in enumerate([
            lambda t: t._replace(xy=-t.xy),  # -0.0
            lambda t: t._replace(desc=(t.desc.float() + 2 ** -7).bfloat16()),
            lambda t: t._replace(depth=-t.depth),  # NaN sign bit
            lambda t: t._replace(valid=~t.valid),
            lambda t: t._replace(timestamp=torch.nextafter(t.timestamp, torch.tensor(2.0))),
            lambda t: t._replace(frame_id=t.frame_id + 1)]):
        assert smoke.tree_mismatches(edit(tree()), tree()) != [], i


def test_fma_check_rounds_once(smoke):
    """`rounding_mismatches` holds `ops.device.fma` / `fms` / `sqrt`
    against the f64 emulation: none on the CPU, and an unfused
    multiply-add or PyTorch's CPU float32 square root would be caught;
    the solves compared across devices are all there."""
    got = smoke.rounding_mismatches("cpu", n=1 << 16, m=256)
    assert set(got) == {"fma", "fms", "sqrt", "sincos", "atan2f", "eigh3x3", "svd3x3", "kabsch",
                        "eight_point", "dlt_pose", "cholesky_solve"}
    assert not any(got.values()), got
    from vslam_tpu_torch.ops import device

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(device, "fma", lambda a, b, c: a * b + c)
        mp.setattr(device, "fms", lambda a, b, c: c - a * b)
        mp.setattr(device, "sqrt", torch.sqrt)
        got = smoke.rounding_mismatches("cpu", n=1 << 16, m=256)
        assert got["fma"] > 0 and got["fms"] > 0 and got["sqrt"] > 0, got


@pytest.mark.parametrize("value,bad", [(1.5, False), (3, False), (0.0, True), (-2.0, True),
                                       (float("nan"), True), (float("inf"), True),
                                       (None, True)])
def test_figure_failures_need_finite_positive_figures(smoke, value, bad):
    """The attribution phase's rule: each time and activity count present,
    finite and positive; on the CPU (no card to count) activities are not
    held, times are."""
    figs = {"us_per_iter": {"row": 2.0}, "activities_per_iter": {"row": value}}
    got = smoke.figure_failures("app", figs)
    assert bool(got) == bad and (not bad or "activities_per_iter['row']" in got[0])
    assert smoke.figure_failures("app", figs, devices_counted=False) == []
    figs = {"us_per_iter": {"row": value}}
    assert bool(smoke.figure_failures("app", figs, devices_counted=False)) == bad
    assert smoke.figure_failures("app", {"us_per_iter": {}}) == ["app: no us_per_iter"]


def test_attribution_app_runs_in_its_own_process(smoke, capsys):
    """`run_app_process` runs an app's `run` in a process of its own and
    returns its result with that process's launch counts and profiler
    sessions (none on the CPU); an app that fails fails the run."""
    out = smoke.run_app_process("bench_conv_layers", ["--cpu", "--batch", "1", "--chunks", "1"])
    assert out["device"] == "cpu" and len(out["prefix_us_per_frame"]) == 10
    assert out["launches"] == {"radius_match": 0, "radius_match_batched": 0, "top2_match": 0}
    assert out["profiler_sessions"] == {"whole": 0, "lost": 0}
    assert "bench_conv_layers: thru conv1a" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        smoke.run_app_process("bench_no_such_app", ["--cpu"])


def test_attribution_phase_sizes_are_pinned(smoke):
    """The sizes the attribution phase runs the apps at, and the bisect
    at the main phase's chunk, so that its program C is the main run."""
    assert smoke.STEP_ARGS == ["--n", "16"]
    assert smoke.BISECT_ARGS == ["--frames", "64", "--chunk", "32", "--iters", "2"]
    assert smoke.FRONTEND_ARGS == smoke.CONV_ARGS == ["--batch", "8", "--chunks", "2"]
    assert (smoke.BISECT_FRAMES, smoke.BISECT_CHUNK) == (64, smoke.CHUNK)
