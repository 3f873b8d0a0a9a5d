"""The shared graph mechanism (`vslam_tpu_torch.ops.graphs`) on the CPU.

On CPU inputs nothing is captured: the tracking step's 3D-3D half of
`step.motion` (`core.tracking._rigid_motion`), its two `step.pose` halves
(`_pose_fusion`, `_pose_refinement`) and the epipolar RANSACs run their
eager code, and `ops.graphs.STATS` counts no graph. The graph key
separates every caller, and one caller under other static parameters;
the members of the batched step share one key per function, so on the
card they share one graph. The replays themselves are held against the
eager code on the card (`tests/test_torch_kernels_gpu.py`).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vslam_tpu_torch.config import SlamConfig, tiny_test_config
from vslam_tpu_torch.core import pipeline, tracking, tracking_batched
from vslam_tpu_torch.core.state import init_state, stack_trees
from vslam_tpu_torch.data import synthetic
from vslam_tpu_torch.ops import camera as cam
from vslam_tpu_torch.ops import graphs, prng
from vslam_tpu_torch.ops import ransac as rs
from vslam_tpu_torch.ops.linalg import f32_matmuls

torch.set_num_threads(2)

N_FRAMES = 6
HALVES = ("_pose_fusion", "_pose_refinement")


def _world(config, seed):
    c = config.camera
    seq = synthetic.make_sequence(
        N_FRAMES, max_keypoints=config.frontend.max_keypoints,
        desc_dim=config.frontend.descriptor_dim, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
        width=c.width, height=c.height, seed=seed, num_landmarks=900)
    return pipeline.features_from_synthetic(seq, device="cpu")


def _run(config, batched):
    """N_FRAMES frames of world 0 (or worlds 0-2 as batched members) on the
    CPU at `config`."""
    if batched:
        states = stack_trees([init_state(config, device="cpu")] * 3)
        worlds = stack_trees([_world(config, s) for s in range(3)])
        return tracking_batched.batched_tracking_scan(states, worlds, config)[1]
    return tracking.run_frames(init_state(config, device="cpu"), _world(config, 0),
                               list(range(N_FRAMES)), config)[1]


def _recorded(config, batched, monkeypatch):
    """(fn, statics, inputs) of every `graphs.call` of a run."""
    calls = []
    call = graphs.call

    def recording_call(fn, statics, inputs):
        calls.append((fn, statics, inputs))
        return call(fn, statics, inputs)

    monkeypatch.setattr(graphs, "call", recording_call)
    _run(config, batched)
    monkeypatch.setattr(graphs, "call", call)
    return calls


@pytest.mark.parametrize("batched", [False, True])
def test_pose_on_cpu_captures_no_graph(monkeypatch, batched):
    """CPU inputs run both pose halves eagerly, once per tracked frame:
    no capture, no replay, nothing counted."""
    config = tiny_test_config()
    ran = {}
    for name in HALVES:
        fn = getattr(tracking, name)

        def counting(*a, _fn=fn, _name=name):
            ran[_name] = ran.get(_name, 0) + 1
            return _fn(*a)

        monkeypatch.setattr(tracking, name, counting)
    monkeypatch.setattr(graphs, "_GRAPHS", {})
    graphs.reset_stats()
    tracking.reset_stats()
    outs = _run(config, batched)
    n = tracking.STATS["track_frames"]
    assert n == (N_FRAMES - 1) * (3 if batched else 1)
    assert bool(torch.all(outs.tracking_ok))
    assert ran == {name: n for name in HALVES}
    assert graphs.STATS == {} and graphs._GRAPHS == {}


@pytest.mark.parametrize("name", HALVES)
def test_pose_call_on_cpu_is_the_eager_code(monkeypatch, name):
    """`graphs.call` on the step's own CPU inputs returns the function's
    own outputs, bit for bit."""
    config = tiny_test_config()
    calls = [c for c in _recorded(config, False, monkeypatch) if c[0].__name__ == name]
    assert len(calls) == N_FRAMES - 1
    with f32_matmuls():
        for fn, statics, inputs in calls:
            got = graphs.call(fn, statics, inputs)
            want = fn(*inputs, *statics)
            assert len(got) == len(want)
            for x, y in zip(got, want):
                assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("batched", [False, True])
def test_rigid_motion_on_cpu_captures_no_graph(monkeypatch, batched):
    """CPU inputs run the 3D-3D half of `step.motion` eagerly, once per
    tracked member-frame: no capture, no replay, nothing counted."""
    config = tiny_test_config()
    ran = []
    fn = tracking._rigid_motion

    def counting(*a):
        ran.append(a[0].device)
        return fn(*a)

    monkeypatch.setattr(tracking, "_rigid_motion", counting)
    monkeypatch.setattr(graphs, "_GRAPHS", {})
    graphs.reset_stats()
    tracking.reset_stats()
    outs = _run(config, batched)
    assert len(ran) == tracking.STATS["track_frames"] == (N_FRAMES - 1) * (3 if batched else 1)
    assert set(ran) == {torch.device("cpu")}
    assert bool(torch.all(outs.tracking_ok)) and bool(torch.any(outs.used_3d3d))
    assert graphs.STATS == {} and graphs._GRAPHS == {}


def _eager_motion_3d3d(state, frame, config, m, uv_kf, uv_cur, gated, key):
    """The 3D-3D half of `step.motion` written out on the public RANSAC,
    `ops.ransac.ransac_kabsch_3d3d`, with the cap of the keyframe gap."""
    c, mc = config.camera, config.motion
    intr = (c.fx, c.fy, c.cx, c.cy)
    depth_cur = frame.depth[m.idx.long()]
    d_ok = ((state.kf_depth > c.depth_min) & (state.kf_depth < c.depth_max)
            & (depth_cur > c.depth_min) & (depth_cur < c.depth_max))
    p_kf = cam.backproject(uv_kf, state.kf_depth, *intr)
    p_cur = cam.backproject(uv_cur, depth_cur, *intr)
    gap = (frame.frame_id - state.kf_frame_id).to(p_kf.dtype)
    max_t = torch.clamp(gap * mc.r3d_max_translation_per_frame, min=mc.r3d_max_translation)
    R3, t3, res3 = rs.ransac_kabsch_3d3d(
        key, p_kf, p_cur, gated & d_ok, num_hypotheses=mc.r3d_iters,
        inlier_thresh=mc.r3d_inlier_thresh, max_translation=max_t,
        min_translation=mc.r3d_min_translation, min_inliers=config.frontend.min_inliers)
    return R3, t3, res3, p_kf, p_cur, d_ok


def _assert_equal_leaves(got, want):
    flat = [x for o in got for x in (o if isinstance(o, tuple) else (o,))]
    flat_want = [x for o in want for x in (o if isinstance(o, tuple) else (o,))]
    assert len(flat) == len(flat_want)
    for x, y in zip(flat, flat_want):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("batched", [False, True])
def test_motion_3d3d_is_the_public_ransac(monkeypatch, batched):
    """On the step's own CPU inputs, every tracked member-frame, the 3D-3D
    half gives the bits of the public RANSAC on the backprojected sets."""
    config = tiny_test_config()
    seen = []
    motion = tracking._motion_3d3d

    def checking(*a):
        got = motion(*a)
        _assert_equal_leaves(got, _eager_motion_3d3d(*a))
        seen.append(bool(got[2].ok))
        return got

    monkeypatch.setattr(tracking, "_motion_3d3d", checking)
    _run(config, batched)
    assert len(seen) == (N_FRAMES - 1) * (3 if batched else 1) and any(seen)


def _rigid_scene(config, t_norm, seed=0):
    """A keyframe's and a frame's matched keypoints with depth, the frame
    `t_norm` metres from the keyframe; the frame's keypoints permuted, so
    that the match indices gather. Returns (state, frame, m, uv_kf,
    uv_cur, gated) as `_motion_3d3d` takes them, keyframe id 10."""
    c = config.camera
    K = config.frontend.max_keypoints
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.0, 1.0, (K, 3)) + [0.0, 0.0, 3.0]
    t = rng.normal(size=3)
    X2 = X + t * (t_norm / np.linalg.norm(t))

    def pix(P):
        return np.stack([c.fx * P[:, 0] / P[:, 2] + c.cx, c.fy * P[:, 1] / P[:, 2] + c.cy], -1)

    perm = rng.permutation(K)
    depth = np.empty(K)
    depth[perm] = X2[:, 2]

    def f32(a):
        return torch.tensor(a, dtype=torch.float32)

    state = SimpleNamespace(kf_depth=f32(X[:, 2]), kf_frame_id=torch.tensor(10, dtype=torch.int32))
    frame = SimpleNamespace(depth=f32(depth), frame_id=None)
    m = SimpleNamespace(idx=torch.tensor(perm, dtype=torch.int32))
    return state, frame, m, f32(pix(X)), f32(pix(X2)), torch.tensor(rng.random(K) > 0.1)


def test_rigid_motion_cap_follows_the_keyframe_gap():
    """The translation cap is an input, not a constant: the same matches
    0.35 m apart fail under the 0.2 m cap two frames after the keyframe and
    pass ten frames after it (0.05 m a frame), as the public RANSAC does."""
    config = SlamConfig()
    state, frame, m, uv_kf, uv_cur, gated = _rigid_scene(config, 0.35)
    key = prng.prng_key(3)
    oks = []
    with f32_matmuls():
        for gap in (2, 10):
            frame.frame_id = state.kf_frame_id + gap
            got = tracking._motion_3d3d(state, frame, config, m, uv_kf, uv_cur, gated, key)
            _assert_equal_leaves(got, _eager_motion_3d3d(state, frame, config, m, uv_kf, uv_cur,
                                                         gated, key))
            oks.append(bool(got[2].ok))
    assert oks == [False, True]


@pytest.mark.parametrize("name", HALVES + ("_rigid_motion",))
def test_batched_members_share_one_key(monkeypatch, name):
    """Every member of the batched step calls a graphed function (a pose
    half, the 3D-3D half of `step.motion`) under the key of the solo step:
    one graph per function serves them all."""
    config = tiny_test_config()
    with f32_matmuls():
        solo = {graphs.graph_key(*c) for c in _recorded(config, False, monkeypatch)
                if c[0].__name__ == name}
        members = [graphs.graph_key(*c) for c in _recorded(config, True, monkeypatch)
                   if c[0].__name__ == name]
    assert len(members) == 3 * (N_FRAMES - 1)
    assert solo == set(members) and len(solo) == 1


@pytest.fixture(scope="module")
def caller_keys():
    """The graph key of each caller of `ops.graphs`, and of two callers
    under other statics, at the tiny configuration's shapes."""
    config = tiny_test_config()
    with pytest.MonkeyPatch.context() as mp, f32_matmuls():
        calls = {c[0].__name__: c for c in _recorded(config, False, mp)}
        rng = np.random.default_rng(0)
        K = config.frontend.max_keypoints
        uv1 = torch.tensor(rng.uniform(0, 100, (K, 2)), dtype=torch.float32)
        uv2 = uv1 + 1.0
        valid = torch.ones(K, dtype=torch.bool)
        u = rs.draw_minimal_sets(prng.prng_key(3), K, config.motion.fm_ransac_iters, 8)
        c = config.camera
        fusion, refinement = calls["_pose_fusion"], calls["_pose_refinement"]
        motion = calls["_rigid_motion"]
        intr, pc, mc, ec = refinement[1]
        return {
            "fgate": graphs.graph_key(rs._fundamental, (3.0, 8), (u, uv1, uv2, valid)),
            "essential": graphs.graph_key(rs._essential, (c.fx, c.fy, c.cx, c.cy, 1.0, 15, 8),
                                          (u, uv1, uv2, valid)),
            "fusion": graphs.graph_key(*fusion),
            "fusion_max_step": graphs.graph_key(
                fusion[0], (dataclasses.replace(config.ekf, max_step=0.2),), fusion[2]),
            "refinement": graphs.graph_key(*refinement),
            "refinement_kf_full": graphs.graph_key(
                refinement[0],
                (intr, dataclasses.replace(pc, kf_refine_full=not pc.kf_refine_full), mc, ec),
                refinement[2]),
            "motion": graphs.graph_key(*motion),
            "motion_no_cap": graphs.graph_key(motion[0], motion[1][:5] + (0.0,) + motion[1][6:],
                                              motion[2]),
        }


@pytest.mark.parametrize("pair", [
    ("fgate", "fusion"), ("essential", "fusion"), ("fgate", "refinement"),
    ("essential", "refinement"), ("fusion", "refinement"), ("fusion", "fusion_max_step"),
    ("refinement", "refinement_kf_full"), ("fusion", "fusion"), ("refinement", "refinement"),
    ("fgate", "motion"), ("essential", "motion"), ("fusion", "motion"),
    ("refinement", "motion"), ("motion", "motion_no_cap"), ("motion", "motion"),
])
def test_graph_key_separates_the_callers(caller_keys, pair):
    """The F-gate, the essential RANSAC, the 3D-3D half of `step.motion`
    and the two pose halves each get a graph of their own, and a caller
    under other statics another one."""
    a, b = pair
    assert (caller_keys[a] == caller_keys[b]) == (a == b)


def test_ransac_stats_keep_their_keys():
    """`ops.graphs.STATS` is the one graph counter: it counts the epipolar
    RANSACs under their device functions' names, each function apart, and
    its reset zeroes it; `ops.ransac` keeps no counter of its own."""
    graphs.reset_stats()
    graphs._count(rs._fundamental, "captures")
    graphs._count(rs._fundamental, "replays")
    graphs._count(rs._essential, "replays")
    assert graphs.STATS == {"_fundamental": {"captures": 1, "replays": 1},
                            "_essential": {"captures": 0, "replays": 1}}
    graphs.reset_stats()
    assert graphs.STATS == {}
    assert not hasattr(rs, "STATS") and not hasattr(rs, "reset_stats")
