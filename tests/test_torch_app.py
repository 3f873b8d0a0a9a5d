"""The port's TUM app (`vslam_tpu_torch.apps.run_tum`) against the JAX
package's (`examples/run_tum.py`, run unchanged), on a 16-frame 160x120
room directory written by `write_tum_sequence` with its synthetic feature
cache, at the tiny configuration with SuperPoint's descriptor width
(D 256, so that the live run's SuperPoint features fit the state).

The JAX app builds `SlamConfig(rgbd=not args.mono)` inside `main`; the
test points `vslam_tpu.config.SlamConfig` at that configuration, and
runs both packages' SuperPoint in f32 (the live run extracts features;
bf16 would round differently in the two frameworks).

- Batch: the cache replayed at `--frame-step 2` (so the cache, keyed by
  dataset frame id 0-15, is reselected to 0, 2, ..., 14), with RTS and
  post-hoc PGO. Summary counts (frames, keyframes, map points) equal and
  the trajectories and ATE within 1e-5 m. (Before the port multiplied by
  the f32 reciprocal of a configuration constant as XLA does,
  `camera.backproject`'s `/ fx` rounded the 3D points one ulp away, one
  frame's 3D-3D RANSAC refit another inlier set and the runs ended 2.3e-4
  m apart; `tests/test_torch_geometry.py::test_constant_division_rounds_as_jit`.)
  The dense clouds hold the same points to within 1%.
- Live, `--restart-at 8`: two segments, each segment's trajectory within
  1e-4 m of JAX's (printed at 6 decimals), the same summary. The live run
  extracts its own features with each framework's f32 SuperPoint, and
  those differ: the convolutions sum in other orders, so in segment 0
  76 of 1,024 keypoint coordinates lie up to 1.5e-5 px apart and the
  descriptors up to 1.9e-7. From frame 4 on the RANSACs then refit on
  other points and segment 0 ends 6.1e-5 m apart (segment 1, 1e-6 m).
  The tracker is not the cause: on JAX's own live features of segment 0
  (recorded from JAX's run) it follows JAX's poses within 1e-5 m with
  every count equal (measured 3.1e-7 m).
- `--render` writes its PNG frames; without `--cpu` and without a card
  the app raises.
"""

import contextlib
import dataclasses
import functools
import io
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_config():
    from vslam_tpu.config import tiny_test_config

    t = tiny_test_config()
    return t.replace(frontend=dataclasses.replace(t.frontend, descriptor_dim=256))


def _port_config():
    from vslam_tpu_torch.config import tiny_test_config

    t = tiny_test_config()
    return t.replace(frontend=dataclasses.replace(t.frontend, descriptor_dim=256))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from vslam_tpu_torch.data import synthetic

    c = _port_config().camera
    seq = synthetic.make_room_sequence(num_frames=16, seed=0, max_keypoints=64, desc_dim=256,
                                       width=c.width, height=c.height, fx=c.fx, fy=c.fy,
                                       cx=c.cx, cy=c.cy)
    root = str(tmp_path_factory.mktemp("tum") / "room")
    synthetic.write_tum_sequence(root, seq, write_cache="sp.npz")
    return root


def _run_jax_app(argv):
    import vslam_tpu.config as j_config
    import vslam_tpu.models.superpoint as j_sp

    spec = importlib.util.spec_from_file_location("jax_run_tum",
                                                  os.path.join(ROOT, "examples", "run_tum.py"))
    app = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(app)
    cfg = _jax_config()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_config, "SlamConfig", lambda rgbd=True: cfg.replace(rgbd=rgbd))
        mp.setattr(j_sp, "SuperPoint", functools.partial(j_sp.SuperPoint,
                                                         compute_dtype=jnp.float32))
        mp.setattr(sys, "argv", ["run_tum.py"] + argv)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            app.main()
    return _summary(buf.getvalue())


def _run_port_app(argv):
    from vslam_tpu_torch.apps import run_tum
    from vslam_tpu_torch.models import weights

    load = weights.load_superpoint
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(weights, "load_superpoint",
                   lambda *a, **k: load(*a, **{**k, "compute_dtype": torch.float32}))
        args = run_tum.parse_args(argv)
        return run_tum.run(args, _port_config().replace(rgbd=not args.mono))


def _summary(out):
    import json

    line = [ln for ln in out.splitlines() if ln.startswith("[summary] ")][-1]
    return json.loads(line[len("[summary] "):])


@pytest.fixture(scope="module")
def batch_runs(dataset, tmp_path_factory):
    out = tmp_path_factory.mktemp("batch")
    common = [dataset, "--cache", os.path.join(dataset, "sp.npz"), "--frame-step", "2", "--cpu"]
    want = _run_jax_app(common + ["--out", str(out / "jax")])
    summary, results = _run_port_app(common + ["--out", str(out / "port")])
    return out, summary, results, want


@pytest.fixture(scope="module")
def live_runs(dataset, tmp_path_factory):
    """Both apps' live runs; records JAX's per-chunk features and step
    outputs and the state each of the port's chunks starts from."""
    import jax

    from vslam_tpu.core import frontend as j_fe
    from vslam_tpu.core import pipeline as j_pl
    from vslam_tpu_torch.core import pipeline as t_pl
    from vslam_tpu_torch.core import state as t_state

    rec = {"jax_feats": [], "jax_outs": [], "port_states": []}
    extract, j_track, t_track = j_fe.extract_sequence, j_pl.run_tracking, t_pl.run_tracking

    def j_extract_rec(*a, **k):
        feats = extract(*a, **k)
        rec["jax_feats"].append(jax.tree.map(np.asarray, feats))
        return feats

    def j_track_rec(*a, **k):
        res = j_track(*a, **k)
        rec["jax_outs"].append(jax.tree.map(np.asarray, res.outputs))
        return res

    def t_track_rec(feats, cfg, state=None, **k):
        rec["port_states"].append(t_state.clone_tree(state))
        return t_track(feats, cfg, state=state, **k)

    out = tmp_path_factory.mktemp("live")
    common = [dataset, "--frame-step", "1", "--cpu", "--live", "--restart-at", "8"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_fe, "extract_sequence", j_extract_rec)
        mp.setattr(j_pl, "run_tracking", j_track_rec)
        mp.setattr(t_pl, "run_tracking", t_track_rec)
        want = _run_jax_app(common + ["--out", str(out / "jax")])
        summary, results = _run_port_app(common + ["--out", str(out / "port")])
    return out, summary, results, want, rec


def _traj(path):
    return np.loadtxt(path)


def test_batch_app_matches_jax(batch_runs):
    out, summary, results, want = batch_runs
    for name in ("estimated_trajectory.txt", "estimated_trajectory_full.txt"):
        a, b = _traj(out / "jax" / name), _traj(out / "port" / name)
        assert a.shape == b.shape == (8, 8)
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_allclose(b[:, 1:4], a[:, 1:4], atol=1e-5, rtol=0)
    from vslam_tpu_torch.io import ply

    dj = ply.load_ply(str(out / "jax" / "dense_map.ply"))["points"]
    dp = ply.load_ply(str(out / "port" / "dense_map.ply"))["points"]
    assert abs(len(dp) - len(dj)) <= 0.01 * len(dj)
    assert summary["frames"] == 8 and summary["dense_points"] == len(dp)
    assert os.path.getsize(out / "port" / "viewer.html") > 10_000
    assert len(results) == 1 and results[0].t.shape == (8, 3)


def test_batch_summary_counts_equal_jax(batch_runs):
    _, summary, _, want = batch_runs
    for key in ("frames", "keyframes", "map_points"):
        assert summary[key] == want[key], key
    assert abs(summary["ate_rmse_m"] - want["ate_rmse_m"]) <= 1e-5


def test_live_app_matches_jax(live_runs):
    out, summary, results, want, _ = live_runs
    assert summary["segments"] == 2 and len(results) == 2 and summary["inrun_pgo"] == 0
    for key in ("mode", "frames", "segments", "keyframes", "dense_points"):
        assert summary[key] == want[key], key
    for seg in (0, 1):
        name = f"estimated_trajectory_seg{seg}.txt"
        a, b = _traj(out / "jax" / name), _traj(out / "port" / name)
        assert a.shape == b.shape == (8, 8)
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_allclose(b[:, 1:4], a[:, 1:4], atol=1e-4, rtol=0)
    assert summary["frames"] == 16 and summary["keyframes"] >= 1


def test_live_tracking_on_jax_features(live_runs):
    """The port's tracker on JAX's live features of segment 0 (its one
    chunk, frames 0-7), from the port's own initial state: every count
    and flag equal to JAX's step outputs, poses within 1e-5."""
    from vslam_tpu_torch.core import pipeline as t_pl
    from vslam_tpu_torch.core.state import FrameFeatures, to_numpy

    *_, rec = live_runs
    assert len(rec["jax_feats"]) == len(rec["jax_outs"]) == len(rec["port_states"]) == 2

    def leaf(v):
        v = np.asarray(v)
        if v.dtype.name == "bfloat16":
            return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(v))

    jf, oj = rec["jax_feats"][0], rec["jax_outs"][0]
    feats = FrameFeatures(*(leaf(getattr(jf, f)) for f in FrameFeatures._fields))
    ot = to_numpy(t_pl.run_tracking(feats, _port_config(), state=rec["port_states"][0],
                                    smooth=False, device="cpu").outputs)
    for f in type(oj)._fields:
        a, x = np.asarray(getattr(oj, f)), getattr(ot, f)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(x, a, err_msg=f)
    np.testing.assert_allclose(ot.t, oj.t, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ot.R, oj.R, atol=1e-5, rtol=0)


def test_render_and_missing_card_raise(dataset, tmp_path, monkeypatch):
    """`--render` writes ceil(N / every) scene frames (every = max(N // 20,
    1)), each read back non-blank and showing the sparse map, plus a HUD and an annotated frame per
    rendered frame after the first; without `--cpu` and a card the app
    raises before writing anything."""
    import cv2

    from vslam_tpu_torch.apps import run_tum

    out = tmp_path / "render"
    _run_port_app([dataset, "--cache", os.path.join(dataset, "sp.npz"), "--frame-step", "2",
                   "--cpu", "--render", "--out", str(out)])
    viz = out / "viz"
    n, every = 8, 1
    scenes = sorted(p for p in os.listdir(viz) if p.startswith("frame_"))
    assert len(scenes) == -(-n // every)
    for name in scenes:
        img = cv2.imread(str(viz / name))
        assert img.shape == (768, 1024, 3) and (img > 0).any(axis=-1).sum() > 100, name
        cyan = (img[..., 0] == 255) & (img[..., 1] == 255) & (img[..., 2] == 0)
        assert cyan.sum() >= 100, name  # the sparse map (BGR cyan; ~800 pixels here)
    for prefix in ("hud_", "annot_"):
        assert len([p for p in os.listdir(viz) if p.startswith(prefix)]) == n - 1
    empty = tmp_path / "nocard"
    empty.mkdir()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_tum.main([dataset, "--out", str(empty)])
    assert not os.listdir(empty)


# ---------------------------------------------------------------------------
# Slow CPU twins of the card smoke's app phase (`chip_smoke.py`, APP_JAX):
# the seed-0 room world, 96 frames at 640x480, written as a TUM directory
# with its synthetic cache; each mode of the smoke through the JAX app and
# the port's app at the default SlamConfig. Run with `-m slow -s`: prints
# JAX's ATE (which sets the smoke's limits) and the port's CPU ATE.
# ---------------------------------------------------------------------------

APP_MODES = {
    "sp_rgbd": [],
    "cache_ba": ["--cache", "{root}/sp_cache.npz", "--ba"],
    "orb": ["--orb"],
    "mono_midas": ["--mono", "--midas"],
    "live": ["--live", "--restart-at", "48"],
}


@pytest.fixture(scope="module")
def full_dataset(tmp_path_factory):
    from vslam_tpu_torch.data import synthetic

    seq = synthetic.make_room_sequence(num_frames=96, seed=0)
    root = str(tmp_path_factory.mktemp("full") / "room96")
    synthetic.write_tum_sequence(root, seq, write_cache="sp_cache.npz")
    return root


def _app_ates(out, root, live):
    from vslam_tpu_torch.data import tum
    from vslam_tpu_torch.eval import ate as ate_mod

    gt = tum.load_sequence(root).gt
    names = (["estimated_trajectory_seg0.txt", "estimated_trajectory_seg1.txt"] if live
             else ["estimated_trajectory.txt"])
    res = {}
    for n in names:
        tr = np.loadtxt(os.path.join(out, n))
        res[n] = dict(
            raw=float(ate_mod.compute_ate(tr[:, 0], tr[:, 1:4], gt[:, 0], gt[:, 1:4],
                                          with_scale=False).rmse),
            sim3=float(ate_mod.compute_ate(tr[:, 0], tr[:, 1:4], gt[:, 0], gt[:, 1:4]).rmse))
    return res


@pytest.mark.slow
@pytest.mark.parametrize("mode", list(APP_MODES))
def test_app_full_size_vs_jax(full_dataset, tmp_path, mode):
    import vslam_tpu.config as j_config

    from vslam_tpu_torch.apps import run_tum
    from vslam_tpu_torch.config import SlamConfig

    extra = [a.format(root=full_dataset) for a in APP_MODES[mode]]
    argv = [full_dataset, "--frame-step", "1", "--cpu"] + extra
    spec = importlib.util.spec_from_file_location("jax_run_tum",
                                                  os.path.join(ROOT, "examples", "run_tum.py"))
    app = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(app)
    assert j_config.SlamConfig().camera.width == 640
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["run_tum.py"] + argv + ["--out", str(tmp_path / "jax")])
        app.main()
    args = run_tum.parse_args(argv + ["--out", str(tmp_path / "port")])
    summary, _ = run_tum.run(args, SlamConfig(rgbd=not args.mono))
    live = mode == "live"
    ate_j = _app_ates(str(tmp_path / "jax"), full_dataset, live)
    ate_t = _app_ates(str(tmp_path / "port"), full_dataset, live)
    print(f"\nAPP_JAX[{mode}] = {ate_j}\nport CPU [{mode}] = {ate_t}\nport summary {summary}")
    for n in ate_j:
        assert np.isfinite(ate_t[n]["raw"]) and ate_t[n]["sim3"] <= max(2 * ate_j[n]["sim3"], 0.02)
