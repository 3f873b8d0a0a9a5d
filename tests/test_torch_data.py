"""The port's own copies of data the JAX package also makes: the config,
the initial state and its numpy round trip, the synthetic image
sequence (which feeds the port on the card, where there is no JAX) in
the training family v1 and the held-out family v2, the Kinect-model
sensor noise, the feature-level sequences (`make_sequence` with and
without depth, `make_room_sequence`), the Gaussian-spot render, the ATE
and RPE evaluation, and the stress world (closed circle with a pause and
a texture dropout, plus accelerometer rows).

Tolerance: config fields, the initial state, the rendered and noisy
frames, the feature-level observations and the ground truth are equal
bit for bit (the same numpy code on the same seed); ATE within 1e-6 m
(f32 Kabsch alignment in another order of summation); RPE (numpy on both
sides) equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from vslam_tpu import config as j_config
from vslam_tpu.core.state import init_state as j_init
from vslam_tpu.data import synthetic as j_syn
from vslam_tpu.eval import ate as j_ate
from vslam_tpu_torch import config as t_config
from vslam_tpu_torch.core import state as t_state
from vslam_tpu_torch.data import synthetic as t_syn
from vslam_tpu_torch.eval import ate as t_ate


@pytest.mark.parametrize("make", ["SlamConfig", "tiny_test_config"])
def test_config_copy_is_field_for_field(make):
    a = getattr(j_config, make)()
    b = getattr(t_config, make)()

    def fields(c):
        return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}

    fa, fb = fields(a), fields(b)
    assert fa.keys() == fb.keys()
    for name in fa:
        va, vb = fa[name], fb[name]
        if dataclasses.is_dataclass(va):
            assert fields(va) == fields(vb), name
        else:
            assert va == vb, name


def test_init_state_and_numpy_round_trip():
    cfg_j, cfg_t = j_config.tiny_test_config(), t_config.tiny_test_config()
    sj = jax.tree.map(np.asarray, j_init(cfg_j, gravity=np.array([0, -1.0, 0]),
                                         initial_height=0.25))
    st = t_state.init_state(cfg_t, gravity=[0, -1.0, 0], initial_height=0.25, device="cpu")
    assert st.kf_desc.dtype == torch.bfloat16 and st.map.desc.dtype == torch.bfloat16
    back = t_state.to_numpy(st)
    flat_j = jax.tree_util.tree_flatten_with_path(sj)[0]
    flat_t = jax.tree.leaves(back)
    assert len(flat_j) == len(flat_t)
    for (path, a), b in zip(flat_j, flat_t):
        a = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        assert a.dtype == b.dtype and a.shape == b.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(b, a)
    # JAX numpy leaves (bf16 included) -> port tensors -> numpy, bit for bit.
    again = t_state.to_numpy(t_state.from_numpy(sj, "cpu"))
    for a, b in zip(jax.tree.leaves(sj), jax.tree.leaves(again)):
        np.testing.assert_array_equal(b, a.view(np.uint16) if a.dtype.name == "bfloat16" else a)


def test_synthetic_sequence_bit_for_bit():
    c = t_config.tiny_test_config().camera
    kw = dict(width=c.width, height=c.height, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
              seed=0, num_landmarks=500, radius=2.0, with_rgb=True)
    a = j_syn.make_image_sequence(6, **kw)
    b = t_syn.make_image_sequence(6, **kw)
    for key in ("timestamps", "R", "t", "gray", "depth_u16", "rgb"):
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    for field in ("landmarks", "descriptors", "priority"):
        np.testing.assert_array_equal(getattr(b["world"], field), getattr(a["world"], field))


@pytest.mark.parametrize("kw", [dict(seed=101, loops=1.0),
                                dict(seed=202, loops=2.5, pause=(0.3, 0.02),
                                     dropout=(0.6, 0.01))])
def test_stress_sequence_bit_for_bit(kw):
    """The bench's two stress variants at a small size (48 frames, so that
    the pause and the dropout both fall inside): frames, ground truth,
    `moving` and the accelerometer rows (same `default_rng` draw order)
    equal bit for bit."""
    c = t_config.tiny_test_config().camera
    cam = dict(width=c.width, height=c.height, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
               num_landmarks=600)
    a = j_syn.make_stress_image_sequence(48, **cam, **kw)
    b = t_syn.make_stress_image_sequence(48, **cam, **kw)
    assert a["rgb"] is None and b["rgb"] is None
    for key in ("timestamps", "R", "t", "gray", "depth_u16", "accel", "moving"):
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
        np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    assert (~b["moving"]).any()
    ja = j_syn.make_stress_trajectory(48, **{k: v for k, v in kw.items() if k in ("loops", "pause")})
    tb = t_syn.make_stress_trajectory(48, **{k: v for k, v in kw.items() if k in ("loops", "pause")})
    for x, y in zip(ja, tb):
        np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("seed", [40, 41])
def test_holdout_family_and_noise_bit_for_bit(seed):
    """The held-out v2 worlds (structured textures, illumination field,
    vignette, per-frame gamma) of the smoke's holdout phase, at the tiny
    camera, then `apply_sensor_noise` on them."""
    c = t_config.tiny_test_config().camera
    kw = dict(width=c.width, height=c.height, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
              seed=seed, num_landmarks=800, radius=3.0, with_rgb=True, family="v2")
    a = j_syn.make_image_sequence(4, **kw)
    b = t_syn.make_image_sequence(4, **kw)
    for key in ("timestamps", "R", "t", "gray", "depth_u16", "rgb"):
        np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    assert not np.array_equal(b["gray"], t_syn.make_image_sequence(
        4, **{**kw, "family": "v1"})["gray"])
    na, nb = j_syn.apply_sensor_noise(a, seed=0), t_syn.apply_sensor_noise(b, seed=0)
    for key in ("gray", "depth_u16"):
        assert na[key].dtype == nb[key].dtype
        np.testing.assert_array_equal(nb[key], na[key], err_msg=key)
    assert (nb["depth_u16"] == 0).mean() > (b["depth_u16"] == 0).mean()
    assert nb["t"] is b["t"] and not np.array_equal(nb["gray"], b["gray"])


@pytest.mark.parametrize("rgbd", [True, False])
def test_feature_sequences_bit_for_bit(rgbd):
    fields = ("timestamps", "R", "t", "kp_xy", "kp_desc", "kp_depth", "kp_valid",
              "kp_landmark", "accel")
    a = j_syn.make_sequence(12, max_keypoints=64, desc_dim=32, seed=3, num_landmarks=900,
                            rgbd=rgbd)
    b = t_syn.make_sequence(12, max_keypoints=64, desc_dim=32, seed=3, num_landmarks=900,
                            rgbd=rgbd)
    for f in fields:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    assert b.kp_valid.any() and (b.kp_depth.any() == rgbd)
    a = j_syn.make_room_sequence(6, seed=2, max_keypoints=64, num_landmarks=700)
    b = t_syn.make_room_sequence(6, seed=2, max_keypoints=64, num_landmarks=700)
    for f in fields:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    ga = j_syn.render_gray(a.world, a.R[3], a.t[3], a.fx, a.fy, a.cx, a.cy, a.width, a.height)
    gb = t_syn.render_gray(b.world, b.R[3], b.t[3], b.fx, b.fy, b.cx, b.cy, b.width, b.height)
    np.testing.assert_array_equal(gb, ga)


def test_synthetic_full_width_frame():
    """One frame at the default 640x480 with the main path's 6000-landmark
    world (the port's renderer feeds the card at this size)."""
    c = t_config.SlamConfig().camera
    kw = dict(width=c.width, height=c.height, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
              seed=0, num_landmarks=6000, radius=3.0, with_rgb=False)
    a = j_syn.make_image_sequence(1, **kw)
    b = t_syn.make_image_sequence(1, **kw)
    np.testing.assert_array_equal(b["gray"], a["gray"])
    np.testing.assert_array_equal(b["depth_u16"], a["depth_u16"])


def test_ate(rng):
    ts = np.arange(50) * 0.1
    gt = np.cumsum(rng.normal(0, 0.05, (50, 3)), 0)
    est = gt * 1.1 + rng.normal(0, 0.01, (50, 3)) + np.array([0.2, 0.0, -0.1])
    ts_est = ts + rng.uniform(-0.01, 0.01, 50)
    for with_scale in (True, False):
        a = j_ate.compute_ate(ts_est, est, ts, gt, with_scale=with_scale)
        b = t_ate.compute_ate(ts_est, est, ts, gt, with_scale=with_scale)
        assert a.num_pairs == b.num_pairs
        np.testing.assert_allclose(b.rmse, a.rmse, atol=1e-6)
        np.testing.assert_allclose(b.scale, a.scale, atol=1e-6)
    ie_a, ig_a = j_ate.associate(ts_est, ts)
    ie_b, ig_b = t_ate.associate(ts_est, ts)
    np.testing.assert_array_equal(ie_b, ie_a)
    np.testing.assert_array_equal(ig_b, ig_a)


@pytest.mark.parametrize("delta", [1, 5])
def test_rpe(rng, delta):
    ts = np.arange(60) * 0.1
    gt = np.cumsum(rng.normal(0, 0.05, (60, 3)), 0)
    est = gt + np.cumsum(rng.normal(0, 0.01, (60, 3)), 0)
    ts_est = ts + rng.uniform(-0.01, 0.01, 60)
    a = j_ate.compute_rpe(ts_est, est, ts, gt, delta=delta)
    b = t_ate.compute_rpe(ts_est, est, ts, gt, delta=delta)
    assert b == a and b.num_pairs == 60 - delta
    assert t_ate.compute_rpe(ts[:3], est[:3], ts, gt, delta=2).num_pairs == 0
