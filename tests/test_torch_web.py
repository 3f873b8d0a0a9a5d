"""The port's web viewer (`vslam_tpu_torch.viz.web`, `viz.viewer`)
against the JAX package's: for the same run (the port's tracking run of a
loopy feature-level world, so that loop edges are drawn) the page is the
same bytes, given the JAX exporter the run's numpy leaves; the HUD lines
and loop edges are equal."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from vslam_tpu.viz import viewer as j_viewer
from vslam_tpu.viz import web as j_web
from vslam_tpu_torch.config import LoopClosureConfig, tiny_test_config
from vslam_tpu_torch.core import pipeline as t_pl
from vslam_tpu_torch.core.state import to_numpy
from vslam_tpu_torch.data import synthetic as t_syn
from vslam_tpu_torch.viz import viewer as t_viewer
from vslam_tpu_torch.viz import web as t_web


@pytest.fixture(scope="module")
def run():
    cfg = dataclasses.replace(tiny_test_config(), loop=LoopClosureConfig(
        min_frame_gap=12, min_inliers=10, check_interval_kfs=2, max_jump=1.0, min_jump=-1.0,
        kf_stride=1, min_frames_between_accepts=0))
    c = cfg.camera
    seq = t_syn.make_sequence(num_frames=40, max_keypoints=cfg.frontend.max_keypoints,
                              desc_dim=cfg.frontend.descriptor_dim, fx=c.fx, fy=c.fy, cx=c.cx,
                              cy=c.cy, width=c.width, height=c.height, seed=5,
                              num_landmarks=1500, dt=0.1)
    result, _ = t_pl.run_synthetic(seq, cfg, device="cpu")
    rng = np.random.default_rng(0)
    dense = (rng.normal(size=(300, 3)).astype(np.float32),
             rng.integers(0, 256, (300, 3), dtype=np.uint8))
    return seq, result, dense


def _numpy_result(result):
    return SimpleNamespace(final_state=to_numpy(result.final_state),
                           outputs=to_numpy(result.outputs), t=result.t,
                           t_smoothed=result.t_smoothed, timestamps=result.timestamps)


def test_loop_edges_and_hud_equal_jax(run):
    _, result, _ = run
    st_np = to_numpy(result.final_state)
    edges_t = t_viewer.loop_edges_from_state(result.final_state)
    edges_j = j_viewer.loop_edges_from_state(st_np)
    assert len(edges_t) == len(edges_j) >= 1
    for (a, b), (c, d) in zip(edges_t, edges_j):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    outs = to_numpy(result.outputs)
    for i in range(result.t.shape[0]):
        assert t_viewer.hud_text(outs, i) == j_viewer.hud_text(outs, i)


@pytest.mark.parametrize("with_dense", [True, False])
def test_export_run_bytes_equal_jax(run, tmp_path, with_dense):
    seq, result, dense = run
    kw = dict(dense=dense if with_dense else None, gt_trajectory=seq.t, title="a run")
    pt, pj = tmp_path / "t.html", tmp_path / "j.html"
    t_web.export_run(result, str(pt), **kw)
    j_web.export_run(_numpy_result(result), str(pj), **kw)
    page = pt.read_text()
    assert page == pj.read_text()
    assert "<title>a run</title>" in page and '"loops"' in page and '"hud"' in page
