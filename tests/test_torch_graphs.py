"""The shared graph mechanism (`vslam_tpu_torch.ops.graphs`) on the CPU.

On CPU inputs nothing is captured: the tracking step's two `step.pose`
halves (`core.tracking._pose_fusion`, `_pose_refinement`) and the
epipolar RANSACs run their eager code, and `ops.graphs.STATS` counts no
graph. The graph key separates every caller,
and one caller under other static parameters; the members of the batched
step share one key per half, so on the card they share one graph. The
replays themselves are held against the eager code on the card
(`tests/test_torch_kernels_gpu.py`).
"""

import dataclasses

import numpy as np
import pytest
import torch

from vslam_tpu_torch.config import tiny_test_config
from vslam_tpu_torch.core import pipeline, tracking, tracking_batched
from vslam_tpu_torch.core.state import init_state, stack_trees
from vslam_tpu_torch.data import synthetic
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


@pytest.mark.parametrize("name", HALVES)
def test_batched_members_share_one_key(monkeypatch, name):
    """Every member of the batched step calls a pose half under the key of
    the solo step: one graph per half serves them all."""
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
        }


@pytest.mark.parametrize("pair", [
    ("fgate", "fusion"), ("essential", "fusion"), ("fgate", "refinement"),
    ("essential", "refinement"), ("fusion", "refinement"), ("fusion", "fusion_max_step"),
    ("refinement", "refinement_kf_full"), ("fusion", "fusion"), ("refinement", "refinement"),
])
def test_graph_key_separates_the_callers(caller_keys, pair):
    """The F-gate, the essential RANSAC and the two pose halves each get a
    graph of their own, and a caller under other statics another one."""
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
