"""The span recorder of `utils.profiling` over the port's entry points
(`core.coupled.run_coupled`, `run_coupled_batched`) on the tiny
configuration, 8 frames of the seed-0 world (and seed 1 at B = 2) in
chunks of 4: every output, state leaf and dense-map leaf bit-equal with
the recorder on and off; the span tree (`entry` > `entry.copy`,
`frontend`, `track` > `step` > its blocks, `fuse`), with every block of
the step present and the frames adding up; the branch reads charged to
spans summing to `tracking.STATS["branch_reads"]`; and `pgo` under
`track` when a chunk accepts a loop."""

import collections

import numpy as np
import pytest
import torch

from vslam_tpu_torch.config import tiny_test_config
from vslam_tpu_torch.core import coupled
from vslam_tpu_torch.core import pipeline
from vslam_tpu_torch.core import tracking
from vslam_tpu_torch.core.state import init_state, stack_trees
from vslam_tpu_torch.data import synthetic
from vslam_tpu_torch.models import weights
from vslam_tpu_torch.ops import gridhash
from vslam_tpu_torch.parallel.mesh import replicate_state
from vslam_tpu_torch.utils import profiling

N_FRAMES, CHUNK = 8, 4
BLOCKS = {"step.bootstrap", "step.match", "step.motion", "step.map", "step.pose",
          "step.keyframe", "step.finish"}


@pytest.fixture(scope="module")
def model():
    return weights.load_superpoint(device="cpu")


@pytest.fixture
def recorder_off():
    profiling.stop_recording()
    yield
    profiling.stop_recording()


def _world(cfg, seed):
    c = cfg.camera
    d = synthetic.make_image_sequence(N_FRAMES, width=c.width, height=c.height, fx=c.fx,
                                      fy=c.fy, cx=c.cx, cy=c.cy, seed=seed, num_landmarks=500,
                                      radius=2.0)
    S = N_FRAMES // CHUNK
    return dict(gray=d["gray"].reshape(S, CHUNK, c.height, c.width),
                depth=d["depth_u16"].astype(np.int32).reshape(S, CHUNK, c.height, c.width),
                ts=d["timestamps"].astype(np.float32).reshape(S, CHUNK),
                fid=np.arange(N_FRAMES, dtype=np.int32).reshape(S, CHUNK),
                stat=np.zeros((S, CHUNK), bool))


def _run(cfg, model, batched):
    dense = gridhash.init_dense_map(cfg.dense.hash_capacity, cfg.dense.cloud_capacity,
                                    device="cpu")
    if not batched:
        x = {k: torch.from_numpy(v) for k, v in _world(cfg, 0).items()}
        return coupled.run_coupled(model, init_state(cfg, device="cpu"), dense, x["gray"],
                                   x["depth"], None, x["ts"], x["fid"], x["stat"], cfg,
                                   device="cpu")
    xs = [_world(cfg, s) for s in (0, 1)]
    x = {k: torch.from_numpy(np.stack([w[k] for w in xs], axis=2)) for k in xs[0]}
    return coupled.run_coupled_batched(model, replicate_state(cfg, 2, device="cpu"),
                                       stack_trees([dense] * 2), x["gray"], x["depth"], x["ts"],
                                       x["fid"], x["stat"], cfg, device="cpu")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [y for x in tree for y in _leaves(x)]


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_the_entry_records_its_span_tree_and_computes_the_same(batched, model, recorder_off):
    cfg = tiny_test_config()
    B = 2 if batched else 1
    off = _run(cfg, model, batched)
    tracking.reset_stats()
    with profiling.recording() as records:
        on = _run(cfg, model, batched)
    for a, b in zip(_leaves(off), _leaves(on), strict=True):
        assert torch.equal(a, b)

    assert sum(r.reads for r in records) == tracking.STATS["branch_reads"] > 0
    names = [r.name for r in records]
    by = collections.defaultdict(list)
    for r in records:
        by[r.name].append(r)
        assert r.t0_ns <= r.t1_ns and r.call == 0
    (entry,) = by["entry"]
    assert entry.parent == -1 and entry.frames == N_FRAMES * B
    parent = {n: {names[r.parent] for r in by[n]} for n in by if n != "entry"}
    assert parent["entry.copy"] == parent["frontend"] == parent["track"] == parent["fuse"] == {
        "entry"}
    assert parent["step"] == {"track"}
    assert set(by) - {"entry", "entry.copy", "frontend", "track", "fuse", "step"} == BLOCKS
    assert all(parent[n] == {"step"} for n in BLOCKS)
    for name in ("frontend", "track", "step"):
        assert sum(r.frames for r in by[name]) == N_FRAMES * B, name
    assert sum(r.frames for r in by["fuse"]) == N_FRAMES * B
    assert len(by["step"]) == N_FRAMES and len(by["step.bootstrap"]) == 1
    assert len(by["step.pose"]) == 2 * (N_FRAMES - 1)
    for name in ("step.match", "step.motion", "step.map"):
        assert len(by[name]) == N_FRAMES - 1, name
    # Batched: the members' `_finish` in the track body, the stacking in every step.
    assert len(by["step.finish"]) == (N_FRAMES - 1 if not batched else 2 * N_FRAMES - 1)
    assert [r.ids for r in by["track"]] == [list(range(4)), list(range(4, 8))] if not batched \
        else [r.ids for r in by["track"]] == [[[i, i] for i in range(4)],
                                             [[i, i] for i in range(4, 8)]]


def test_an_accepted_loop_records_pgo_under_track(model, monkeypatch, recorder_off):
    """As `test_torch_coupled.test_inrun_pgo_runs_after_an_accepted_loop`:
    a step that accepts every loop slot makes the first chunk run the
    in-run correction, whose span sits under that chunk's `track`."""
    step = tracking.tracking_step

    def step_accepting_a_loop(state, frame, config, key):
        st, out = step(state, frame, config, key)
        return st._replace(loops=st.loops._replace(valid=torch.ones_like(st.loops.valid))), out

    monkeypatch.setattr(tracking, "tracking_step", step_accepting_a_loop)
    calls = []
    fold = pipeline.inrun_pgo_correct
    monkeypatch.setattr(pipeline, "inrun_pgo_correct",
                        lambda st, config: calls.append(1) or fold(st, config))
    tracking.reset_stats()
    with profiling.recording() as records:
        _run(tiny_test_config(), model, False)
    (pgo,) = [r for r in records if r.name == "pgo"]
    track = records[pgo.parent]
    assert calls == [1] and track.name == "track" and track.ids == list(range(4))
    assert sum(r.reads for r in records) == tracking.STATS["branch_reads"]
