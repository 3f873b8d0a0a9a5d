"""The port's frame renders (`vslam_tpu_torch.viz.hud`, `viz.viewer`)
against the JAX package's, on the CPU.

- `hud` (pure numpy): bit for bit.
- `Viewer.build_scene` against the geometry the JAX `render_scene` hands
  to matplotlib, captured by a stub figure and axes: every line's points
  and every point set's coordinates and colours within 1e-6, colours by
  name through matplotlib's table, the same elevation, azimuth and follow
  limits, the same HUD lines, in every camera mode, with the dense cloud
  coloured by height (the viridis table) and by RGB, subsampled.
- `render_run` writes ceil(N / every) PNG frames that read back non-blank.
"""

import math
import os
from types import SimpleNamespace

import numpy as np
import pytest

import matplotlib.colors as mcolors

from vslam_tpu.viz import hud as j_hud
from vslam_tpu.viz import viewer as j_viewer
from vslam_tpu_torch.viz import hud as t_hud
from vslam_tpu_torch.viz import viewer as t_viewer


@pytest.mark.parametrize("float_gray", [False, True])
def test_hud_bitwise(float_gray):
    rng = np.random.default_rng(0)
    g1 = rng.integers(0, 256, (60, 80)).astype(np.uint8)
    g2 = rng.integers(0, 256, (60, 80)).astype(np.uint8)
    if float_gray:
        g1, g2 = g1 / 255.0, g2 / 255.0
    xy1 = rng.uniform(-3, [83, 63], (40, 2)).astype(np.float32)
    xy2 = rng.uniform(-3, [83, 63], (40, 2)).astype(np.float32)
    idx = rng.integers(0, 40, 40)
    raw = rng.random(40) > 0.3
    gated = raw & (rng.random(40) > 0.3)
    valid = rng.random(40) > 0.2
    np.testing.assert_array_equal(t_hud.annotate_frame(g1, xy1, valid, gated),
                                  j_hud.annotate_frame(g1, xy1, valid, gated))
    np.testing.assert_array_equal(t_hud.match_image(g1, g2, xy1, xy2, idx, raw, max_lines=7),
                                  j_hud.match_image(g1, g2, xy1, xy2, idx, raw, max_lines=7))
    np.testing.assert_array_equal(t_hud.before_after(g1, g2, xy1, xy2, idx, raw, gated),
                                  j_hud.before_after(g1, g2, xy1, xy2, idx, raw, gated))


class _Axes:
    def __init__(self):
        self.lines, self.points, self.view, self.limits = [], [], None, [None, None, None]

    def plot(self, x, y, z, color=None, lw=None, alpha=None):
        self.lines.append((np.stack([np.asarray(x), np.asarray(y), np.asarray(z)], -1),
                           mcolors.to_rgb(color), lw))

    def scatter(self, x, y, z, c=None, s=None, linewidths=None):
        cols = np.asarray(mcolors.to_rgb(c)) if isinstance(c, str) else np.asarray(c)
        self.points.append((np.stack([x, y, z], -1), cols, s))

    def view_init(self, elev, azim):
        self.view = (elev, azim)

    def set_xlim(self, a, b):
        self.limits[0] = (a, b)

    def set_ylim(self, a, b):
        self.limits[1] = (a, b)

    def set_zlim(self, a, b):
        self.limits[2] = (a, b)

    def set_facecolor(self, c):
        pass

    def set_axis_off(self):
        pass


class _Figure:
    def __init__(self):
        self.ax, self.texts = _Axes(), []
        self.patch = SimpleNamespace(set_facecolor=lambda c: None)

    def add_subplot(self, *a, **k):
        return self.ax

    def text(self, x, y, s, **k):
        self.texts.append(s)

    def tight_layout(self, pad=0):
        pass


def _scene_inputs(rng, n=30, dense_rgb=True, n_dense=500):
    traj = np.cumsum(rng.normal(0, 0.05, (n, 3)), 0).astype(np.float32)
    kf_R = np.stack([np.eye(3, dtype=np.float32)] * 3)
    dense = rng.normal(0, 2, (n_dense, 3)).astype(np.float32)
    return dict(
        trajectory=traj, cur_R=np.eye(3, dtype=np.float32), cur_t=traj[-1],
        kf_R=kf_R, kf_t=traj[[0, 10, 20]], dense_xyz=dense,
        dense_rgb=rng.integers(0, 256, (n_dense, 3)).astype(np.uint8) if dense_rgb else None,
        sparse_xyz=rng.normal(0, 2, (200, 3)).astype(np.float32), gt_trajectory=traj * 1.01,
        loop_edges=[(traj[0], traj[25])], hud_lines=["frame 29", "matches  12"])


@pytest.mark.parametrize("mode,follow,dense_rgb", [
    ("free", True, False), ("top", False, True), ("side", True, True), ("free", False, False)])
def test_scene_matches_jax_render_scene(mode, follow, dense_rgb, monkeypatch):
    rng = np.random.default_rng(1)
    cfg = dict(mode=mode, follow=follow, max_points_drawn=300)
    figs = []
    monkeypatch.setattr(j_viewer.plt, "figure", lambda **k: figs.append(_Figure()) or figs[-1])
    jv = j_viewer.Viewer(j_viewer.ViewerConfig(**cfg))
    tv = t_viewer.Viewer(t_viewer.ViewerConfig(**cfg))
    for step in range(2):  # the second frame moves the current frustum's EMA
        inputs = _scene_inputs(rng, dense_rgb=dense_rgb)
        jv.render_scene(**inputs)
        sc = tv.build_scene(**inputs)
        ax = figs[-1].ax
        assert len(ax.lines) == len(sc.lines) and len(ax.points) == len(sc.points)
        for (pj, cj, wj), (pt, ct, wt) in zip(ax.lines, sc.lines):
            np.testing.assert_allclose(pt, pj, atol=1e-6, rtol=0)
            np.testing.assert_allclose(ct, cj, atol=1e-6)
            assert wt == wj
        for (pj, cj, sj), (pt, ct, st) in zip(ax.points, sc.points):
            np.testing.assert_allclose(pt, pj, atol=1e-6, rtol=0)
            np.testing.assert_allclose(ct, cj, atol=1e-6, rtol=0)
            assert st == sj
        assert (sc.elev, sc.azim) == ax.view
        want_lim = tuple(ax.limits) if follow else None
        assert (sc.limits is None) == (want_lim is None)
        if follow:
            np.testing.assert_allclose(np.array(sc.limits), np.array(want_lim), atol=1e-6)
        assert list(sc.hud_lines) == figs[-1].texts


def test_viridis_table_is_matplotlibs():
    import matplotlib

    x = np.concatenate([np.linspace(0, 1, 1001), [0.0, 1.0, 0.5, 255.5 / 256]])
    np.testing.assert_array_equal(t_viewer.viridis(x), matplotlib.colormaps["viridis"](x))


def _fake_result(n=23):
    rng = np.random.default_rng(2)
    t = np.cumsum(rng.normal(0, 0.05, (n, 3)), 0).astype(np.float32)
    z = np.zeros(n)
    outputs = SimpleNamespace(num_matches=z + 40, num_inliers=z + 30, num_tracked=z + 20,
                              epi_before=z + 0.5, epi_after=z + 0.4, used_3d3d=z > -1,
                              is_keyframe=z > 0, tracking_ok=z > -1, bridged=z > 0,
                              recovered=z > 0)
    kv = np.zeros(8, bool)
    kv[:3] = True
    st = SimpleNamespace(
        keyframes=SimpleNamespace(valid=kv, R=np.stack([np.eye(3)] * 8), t=rng.normal(size=(8, 3))),
        map=SimpleNamespace(pos=rng.normal(0, 2, (50, 3)), valid=rng.random(50) > 0.3),
        loops=SimpleNamespace(kf_from=np.array([2]), kf_to=np.array([0]), valid=np.array([True])))
    return SimpleNamespace(R=np.stack([np.eye(3, dtype=np.float32)] * n), t=t, t_smoothed=t,
                           outputs=outputs, final_state=st)


def test_render_run_writes_its_frames(tmp_path):
    import cv2

    res = _fake_result()
    cfg = t_viewer.ViewerConfig(width=320, height=240)
    paths = t_viewer.render_run(res, str(tmp_path), every=5, config=cfg)
    assert len(paths) == math.ceil(23 / 5) == len(os.listdir(tmp_path))
    for p in paths:
        img = cv2.imread(p)
        assert img.shape == (240, 320, 3) and (img > 0).any(axis=-1).sum() > 50, p
