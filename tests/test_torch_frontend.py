"""SuperPoint frontend of the port (`vslam_tpu_torch.models`,
`ops.nms`, `core.frontend`) against the JAX package, with the committed
checkpoint `vslam_tpu/models/checkpoints/superpoint_synth.npz`, on frames
of the tiny configuration (160x120) rendered by the JAX package.

Tolerances:
- f32 compute in both packages: `semi`/`desc` within atol 1e-4, rtol 1e-5
  (f32 convolutions summing up to 2304 products in another order, on
  logits up to ~160).
- bf16 compute (what the main path runs): the two frameworks round at
  other places (XLA on the CPU keeps excess f32 precision between fused
  bf16 ops; the port rounds after every convolution, as cuDNN does), so
  outputs differ by a few bf16 steps: held to 1% of the largest magnitude
  at worst and 0.1% on average, and at least 90% of the keypoints of one
  package lie within 0.5 px of a keypoint of the other.
- `extract_keypoints` on the same `semi`/`desc`: `xy`/`valid` equal,
  scores (softmax probabilities: exp and division round differently in
  the two frameworks) and descriptors within 1e-6.
- `sample_depth_at_keypoints`: equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vslam_tpu.config import tiny_test_config as j_tiny
from vslam_tpu.core import frontend as j_fe
from vslam_tpu.data import synthetic as j_syn
from vslam_tpu.models import superpoint as j_sp
from vslam_tpu.models import weights as j_w
from vslam_tpu.ops import nms as j_nms
from vslam_tpu_torch.config import tiny_test_config
from vslam_tpu_torch.core import frontend as t_fe
from vslam_tpu_torch.models import superpoint as t_sp
from vslam_tpu_torch.models import weights as t_w
from vslam_tpu_torch.ops import nms as t_nms


@pytest.fixture(scope="module")
def frames():
    c = j_tiny().camera
    d = j_syn.make_image_sequence(
        4, width=c.width, height=c.height, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
        seed=0, num_landmarks=500, radius=2.0, with_rgb=False,
    )
    return d


@pytest.fixture(scope="module")
def params():
    return j_w.superpoint_params_from_npz(t_w.TRAINED_SP_NPZ)


def _images(d):
    return (d["gray"].astype(np.float32) / 255.0)[..., None]


def _run_both(params, d, jdt, tdt):
    img = _images(d)
    semi_j, desc_j = jax.jit(lambda p, x: j_sp.SuperPoint(compute_dtype=jdt).apply(p, x))(
        params, jnp.asarray(img))
    model = t_w.load_superpoint(device="cpu", compute_dtype=tdt)
    with torch.no_grad():
        semi_t, desc_t = model(torch.from_numpy(img))
    return np.asarray(semi_j), np.asarray(desc_j), semi_t.numpy(), desc_t.numpy()


def test_weights_match_the_flax_tree(params):
    flat = t_w.load_flax_npz(t_w.TRAINED_SP_NPZ)
    sd = t_w.superpoint_state_dict_from_flax(flat)
    for layer, leaves in params["params"].items():
        k = np.asarray(leaves["kernel"])
        np.testing.assert_array_equal(sd[f"{layer}.weight"].numpy(), k.transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd[f"{layer}.bias"].numpy(), np.asarray(leaves["bias"]))


def test_superpoint_f32(params, frames):
    sj, dj, st, dt = _run_both(params, frames, jnp.float32, torch.float32)
    assert st.shape == sj.shape == (4, 15, 20, 65) and dt.shape == dj.shape == (4, 15, 20, 256)
    np.testing.assert_allclose(st, sj, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(dt, dj, atol=1e-4, rtol=1e-5)


def test_superpoint_bf16(params, frames):
    sj, dj, st, dt = _run_both(params, frames, jnp.bfloat16, torch.bfloat16)
    for a, b in ((sj, st), (dj, dt)):
        err = np.abs(a - b)
        scale = np.abs(a).max()
        assert err.max() <= 0.01 * scale, (err.max(), scale)
        assert err.mean() <= 1e-3 * scale, (err.mean(), scale)
    fc = tiny_test_config().frontend
    kw = dict(max_keypoints=fc.max_keypoints, radius=fc.sp_nms_radius,
              conf=fc.sp_confidence_threshold)
    kj, _ = j_nms.extract_keypoints(jnp.asarray(sj), jnp.asarray(dj), **kw)
    kt, _ = t_nms.extract_keypoints(torch.from_numpy(st), torch.from_numpy(dt), **kw)
    for b in range(4):
        xj = np.asarray(kj.xy[b])[np.asarray(kj.valid[b])]
        xt = kt.xy[b].numpy()[kt.valid[b].numpy()]
        near = np.linalg.norm(xj[:, None] - xt[None], axis=-1).min(axis=1) < 0.5
        assert near.mean() >= 0.9, near.mean()


def test_extract_keypoints_same_inputs(params, frames):
    sj, dj, _, _ = _run_both(params, frames, jnp.float32, torch.float32)
    fc = tiny_test_config().frontend
    for K in (fc.max_keypoints, 400):
        kw = dict(max_keypoints=K, radius=fc.sp_nms_radius, conf=fc.sp_confidence_threshold)
        kj, desc_j = j_nms.extract_keypoints(jnp.asarray(sj), jnp.asarray(dj), **kw)
        kt, desc_t = t_nms.extract_keypoints(torch.from_numpy(sj), torch.from_numpy(dj), **kw)
        np.testing.assert_array_equal(kt.valid.numpy(), np.asarray(kj.valid))
        np.testing.assert_array_equal(kt.xy.numpy(), np.asarray(kj.xy))
        np.testing.assert_allclose(kt.score.numpy(), np.asarray(kj.score), atol=1e-6)
        np.testing.assert_allclose(desc_t.numpy(), np.asarray(desc_j), atol=1e-6)
    heat_j = np.asarray(j_nms.decode_heatmap(jnp.asarray(sj)))
    heat_t = t_nms.decode_heatmap(torch.from_numpy(sj)).numpy()
    np.testing.assert_allclose(heat_t, heat_j, atol=1e-6)


def test_nms_ties_keep_the_lowest_index():
    """A plateau of equal scores keeps exactly its first pixel, and equal
    scores leave top-k lowest index first, as `lax.top_k` does."""
    heat = np.zeros((1, 32, 40), np.float32)
    heat[0, 5:8, 5:8] = 0.5      # plateau
    heat[0, 20, 30] = heat[0, 20, 10] = heat[0, 25, 2] = 0.25  # equal, far apart
    kj = j_nms.topk_keypoints(j_nms.nms_local_max(jnp.asarray(heat), 4, 0.005), 8)
    kt = t_nms.topk_keypoints(t_nms.nms_local_max(torch.from_numpy(heat), 4, 0.005), 8)
    np.testing.assert_array_equal(kt.xy.numpy(), np.asarray(kj.xy))
    np.testing.assert_array_equal(kt.valid.numpy(), np.asarray(kj.valid))
    assert kt.valid.sum() == 4 and tuple(kt.xy[0, 0].tolist()) == (5.0, 5.0)


def test_sample_depth_at_keypoints(rng):
    depth = rng.uniform(0.3, 5.0, (3, 48, 64)).astype(np.float32)
    xy = rng.uniform(-2, 66, (3, 50, 2)).astype(np.float32)
    xy[:, :10] = np.round(xy[:, :10]) + 0.5  # exact halves: round half to even
    want = np.asarray(j_fe.sample_depth_at_keypoints(jnp.asarray(depth), jnp.asarray(xy)))
    got = t_fe.sample_depth_at_keypoints(torch.from_numpy(depth), torch.from_numpy(xy)).numpy()
    np.testing.assert_array_equal(got, want)


def test_frontend_features_vs_jax(params, frames):
    """The port's chunk frontend (uint8 gray + uint16 depth -> FrameFeatures)
    against the JAX package's `coupled._frontend_chunk` + keypoint depth,
    both in f32 compute so that the keypoints coincide."""
    from vslam_tpu.core import coupled as j_coupled

    cfg_j, cfg_t = j_tiny(), tiny_test_config()
    gray, dep = frames["gray"], frames["depth_u16"]
    model_j = j_sp.SuperPoint(compute_dtype=jnp.float32)
    kps, desc_j = jax.jit(lambda p, g: j_coupled._frontend_chunk(p, model_j, g, cfg_j))(
        params, jnp.asarray(gray))
    # Jitted, as `run_coupled`'s chunk program converts the depth
    # (`vslam_tpu/core/coupled.py:111`): XLA multiplies by 1/depth_scale.
    kpd_j = jax.jit(lambda d, xy: j_fe.sample_depth_at_keypoints(
        d.astype(jnp.float32) / cfg_j.camera.depth_scale, xy))(jnp.asarray(dep), kps.xy)
    model_t = t_w.load_superpoint(device="cpu", compute_dtype=torch.float32)
    n = len(gray)
    ff = t_fe.frontend_features(
        model_t, torch.from_numpy(gray), torch.from_numpy(dep.astype(np.int32)),
        torch.zeros(n), torch.arange(n, dtype=torch.int32), torch.zeros(n, dtype=torch.bool),
        cfg_t,
    )
    assert ff.desc.shape == (n, cfg_t.frontend.max_keypoints, cfg_t.frontend.descriptor_dim)
    np.testing.assert_array_equal(ff.valid.numpy(), np.asarray(kps.valid))
    np.testing.assert_allclose(ff.xy.numpy(), np.asarray(kps.xy), atol=1e-4)
    np.testing.assert_allclose(ff.desc.numpy(), np.asarray(desc_j), atol=1e-4)
    np.testing.assert_array_equal(ff.depth.numpy(), np.asarray(kpd_j))


# ---------------------------------------------------------------------------
# The app's frontend: SuperPointFrontend on float frames, extract_sequence
# with its replay cache. Both packages in f32 compute (the JAX frontend's
# model swapped for an f32 one before its first call), so keypoints
# coincide: `valid` equal, `xy` and descriptors within 1e-4 (as above).
# ---------------------------------------------------------------------------


def _frontends(params):
    fj = j_fe.SuperPointFrontend(j_tiny(), params=params)
    fj.model = j_sp.SuperPoint(compute_dtype=jnp.float32)
    ft = t_fe.SuperPointFrontend(
        tiny_test_config(), model=t_w.load_superpoint(device="cpu", compute_dtype=torch.float32),
        device="cpu")
    return fj, ft


def _float_gray(frames):
    """What the app feeds: the mean of the decoded RGB over 255, f32."""
    rgb = np.stack([frames["gray"]] * 3, -1)
    return np.mean(rgb, axis=-1).astype(np.float32) / 255.0


def _assert_features_close(got, want):
    gxy, gsc, gva, gde = (np.asarray(a) for a in got)
    wxy, wsc, wva, wde = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gva, wva)
    np.testing.assert_allclose(gxy, wxy, atol=1e-4)
    np.testing.assert_allclose(gsc, wsc, atol=1e-4)
    np.testing.assert_allclose(gde, wde, atol=1e-4)


@pytest.mark.parametrize("as_uint8", [False, True])
def test_superpoint_frontend_extract(params, frames, as_uint8):
    """Float frames in [0, 1] (what the app feeds) and uint8 frames (the
    host `> 1.5` test divides them by 255) give the JAX frontend's
    features."""
    fj, ft = _frontends(params)
    g = frames["gray"] if as_uint8 else _float_gray(frames)
    _assert_features_close(ft.extract(g), fj.extract(g))


def test_pad_to_multiple_matches_jax():
    x = np.random.default_rng(0).random((2, 13, 21, 1)).astype(np.float32)
    want, hw = j_sp.pad_to_multiple(jnp.asarray(x))
    got, hw_t = t_sp.pad_to_multiple(torch.from_numpy(x))
    assert hw == hw_t == (13, 21)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cache", ["sp.npz", "sp.bin"])
def test_extract_sequence_cache_and_reselect(params, frames, tmp_path, cache):
    """Extraction written to a cache keyed by dataset frame id, replayed,
    and reselected by frame id at another frame step; the port's against
    the JAX package's, and the port's replay against its own extraction."""
    fj, ft = _frontends(params)
    g = _float_gray(frames)
    depth = frames["depth_u16"].astype(np.float32) / 5000.0
    ts = np.arange(len(g)) * 0.1
    ids = np.arange(len(g)) * 2  # the frames of a --frame-step 2 run
    pj, pt = str(tmp_path / ("j_" + cache)), str(tmp_path / ("t_" + cache))
    want = j_fe.extract_sequence(fj, g, depth, ts, batch=3, cache_path=pj, frame_indices=ids)
    got = t_fe.extract_sequence(ft, g, depth, ts, batch=3, cache_path=pt, frame_indices=ids)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.xy.numpy(), np.asarray(want.xy), atol=1e-4)
    np.testing.assert_allclose(got.desc.numpy(), np.asarray(want.desc), atol=1e-4)
    assert got.desc.shape[-1] == 256  # SuperPoint's own width, as the JAX frontend returns
    np.testing.assert_array_equal(got.frame_id.numpy(), np.arange(len(g)))
    np.testing.assert_array_equal(got.timestamp.numpy(), ts.astype(np.float32))
    assert not got.stationary.numpy().any()

    # Replaying the port's cache gives back what was extracted: all of it
    # from the npz; from SPCF the valid rows (invalid rows come back zero),
    # cut to the config's D on the way in.
    rep = t_fe.extract_sequence(ft, g, depth, ts, cache_path=pt, frame_indices=ids)
    D = rep.desc.shape[-1]
    v = got.valid.numpy() if cache.endswith(".bin") else np.ones(got.valid.shape, bool)
    np.testing.assert_array_equal(rep.valid.numpy(), got.valid.numpy())
    np.testing.assert_array_equal(rep.xy.numpy()[v], got.xy.numpy()[v])
    np.testing.assert_array_equal(rep.desc.numpy()[v], got.desc.numpy()[..., :D][v])
    np.testing.assert_array_equal(rep.depth.numpy()[v], got.depth.numpy()[v])
    rep_j = j_fe.extract_sequence(fj, g, depth, ts, cache_path=pt, frame_indices=ids)
    np.testing.assert_array_equal(rep.xy.numpy(), np.asarray(rep_j.xy))
    np.testing.assert_array_equal(rep.depth.numpy(), np.asarray(rep_j.depth))

    # A --frame-step 4 run (every other cached frame) reselects by id.
    sub = t_fe.extract_sequence(ft, g[::2], depth[::2], ts[::2], cache_path=pt,
                                frame_indices=ids[::2])
    np.testing.assert_array_equal(sub.xy.numpy(), rep.xy.numpy()[::2])
    np.testing.assert_array_equal(sub.desc.numpy(), rep.desc.numpy()[::2])

    with pytest.raises(ValueError, match="pass frame_indices"):
        t_fe.extract_sequence(ft, g[::2], depth[::2], ts[::2], cache_path=pt)
    with pytest.raises(ValueError, match="not present in feature cache"):
        t_fe.extract_sequence(ft, g[:2], depth[:2], ts[:2], cache_path=pt,
                              frame_indices=np.array([0, 1]))


def test_make_frontend_kinds():
    assert isinstance(t_fe.make_frontend(tiny_test_config(), kind="orb", device="cpu"),
                      t_fe.OrbFrontend)
    sp = t_fe.make_frontend(tiny_test_config(), device="cpu")
    assert isinstance(sp, t_fe.SuperPointFrontend)
    assert sp.weight_source == t_w.TRAINED_SP_NPZ
