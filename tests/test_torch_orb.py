"""The port's ORB frontend (`vslam_tpu_torch.ops.orb`, `ops.resize`,
`core.frontend.OrbFrontend`) against the JAX package's, on frames
rendered by the JAX package.

Tolerances:
- `resize_bilinear` against `jax.image.resize(..., "bilinear")`: 1e-6 at
  the sizes the paths use (the 640x480 pyramid, MiDaS's 256x256 and
  back). The weights are JAX's own, bit for bit, except where XLA's CPU
  code rounds a sample position twice instead of once (it contracts
  (i + 0.5) * s - 0.5 into an FMA for most sizes; of those tried, not
  for an output axis of 80): at the tiny test pyramid's 107x80 level and
  at 64 -> 80 that moves a weight by up to 2.7e-6, held at 3e-6. The taps
  sum in another order than XLA's einsum.
- `fast_score`: equal. `brief_descriptors` on the same angles: equal.
- `orientation`: the moments are summed as XLA sums them inside
  `detect_orb` (one FMA per term, row by row), and a standalone JAX call
  fuses otherwise: within 1e-5 rad.
- `detect_orb` and `OrbFrontend.extract`: keypoints, validity and order
  equal, scores within 1e-6. The first level's descriptors are equal.
  On the resized levels, pixels of a flat (uint8-quantized) region come
  out of the two resizes a rounding apart, so a BRIEF test between two
  such pixels may go either way: at least 99% of the bits are equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vslam_tpu.config import tiny_test_config as j_tiny
from vslam_tpu.core import frontend as j_fe
from vslam_tpu.data import synthetic as j_syn
from vslam_tpu.ops import orb as j_orb
from vslam_tpu_torch.config import tiny_test_config
from vslam_tpu_torch.core import frontend as t_fe
from vslam_tpu_torch.ops import orb as t_orb
from vslam_tpu_torch.ops.resize import resize_bilinear


@pytest.fixture(scope="module")
def gray():
    """Three 128x96 frames of the seed-0 world, in [0, 1] (uint8-quantized)."""
    W, H = 128, 96
    d = j_syn.make_image_sequence(3, width=W, height=H, fx=0.8 * W, fy=0.8 * W,
                                  cx=W / 2 - 0.5, cy=H / 2 - 0.5, seed=0, num_landmarks=1500,
                                  radius=2.0, with_rgb=False)
    return d["gray"].astype(np.float32) / 255.0


def _pyramid_sizes(H, W, levels, factor=1.2):
    out, s = [], 1.0
    for _ in range(levels - 1):
        s *= factor
        out.append((int(round(H / s)), int(round(W / s))))
    return out


@pytest.mark.parametrize("src, dst, atol", [
    *[((480, 640), hw, 1e-6) for hw in _pyramid_sizes(480, 640, 8)],
    ((480, 640), (256, 256), 1e-6),  # MiDaS input
    ((256, 256), (480, 640), 1e-6),  # MiDaS output
    ((96, 128), (80, 107), 3e-6),  # the tiny pyramid (see the module docstring)
    ((96, 128), (67, 89), 1e-6),
    ((64, 64), (96, 80), 3e-6),  # growing (an output axis of 80: see above)
    ((64, 64), (256, 256), 1e-6),
])
def test_resize_matches_jax(src, dst, atol):
    rng = np.random.default_rng(src[0] + dst[0])
    x = rng.random((2, *src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3), method="bilinear"))
    got = resize_bilinear(torch.from_numpy(x), dst, dims=(1, 2)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_fast_score_equal(gray):
    want = np.asarray(jax.vmap(j_orb.fast_score)(jnp.asarray(gray)))
    got = t_orb.fast_score(torch.from_numpy(gray)).numpy()
    assert (want > 0).sum() > 50
    np.testing.assert_array_equal(got, want)


def test_orientation_and_brief(gray):
    xy = np.asarray(jax.vmap(lambda im: j_orb.detect_orb(im, max_keypoints=64, num_levels=1))(
        jnp.asarray(gray))[0])
    ang_j = np.asarray(jax.vmap(j_orb.orientation)(jnp.asarray(gray), jnp.asarray(xy)))
    ang_t = t_orb.orientation(torch.from_numpy(gray), torch.from_numpy(xy)).numpy()
    np.testing.assert_allclose(ang_t, ang_j, atol=1e-5, rtol=0)
    want = np.asarray(jax.vmap(j_orb.brief_descriptors)(
        jnp.asarray(gray), jnp.asarray(xy), jnp.asarray(ang_j)))
    got = t_orb.brief_descriptors(torch.from_numpy(gray), torch.from_numpy(xy),
                                  torch.from_numpy(ang_j)).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {-1 / 16, 1 / 16}


def _check_orb(got, want, first_level_equal):
    gxy, gsc, gva, gde = got
    wxy, wsc, wva, wde = want
    np.testing.assert_array_equal(gva, wva)
    np.testing.assert_array_equal(gxy, wxy)
    np.testing.assert_allclose(gsc, wsc, atol=1e-6, rtol=0)
    agree = np.mean(gde == wde)
    if first_level_equal:
        np.testing.assert_array_equal(gde, wde)
    assert agree >= 0.99, agree
    return agree


@pytest.mark.parametrize("levels", [1, 3])
def test_detect_orb_matches_jax(gray, levels):
    want = [np.asarray(a) for a in jax.vmap(
        lambda im: j_orb.detect_orb(im, max_keypoints=64, num_levels=levels))(jnp.asarray(gray))]
    got = [a.numpy() for a in t_orb.detect_orb(torch.from_numpy(gray), max_keypoints=64,
                                                num_levels=levels)]
    # 3 levels of max(64 // 3, 16) keypoints: 63 rows
    assert got[3].shape == (3, 64 if levels == 1 else 63, 256) and got[2].sum() > 100
    _check_orb(got, want, first_level_equal=levels == 1)


def test_orb_frontend_extract(gray):
    """`OrbFrontend.extract` on uint8 frames (the `> 1.5` rescale on the
    host), descriptors cut to the tiny config's D = 64 and renormalised."""
    u8 = np.round(gray * 255).astype(np.uint8)
    want = [np.asarray(a) for a in j_fe.OrbFrontend(j_tiny(), num_levels=3).extract(u8)]
    got = [a.numpy() for a in t_fe.OrbFrontend(tiny_test_config(), num_levels=3,
                                                device="cpu").extract(u8)]
    assert got[3].shape == (3, 63, 64)
    np.testing.assert_allclose(np.linalg.norm(got[3], axis=-1), 1.0, atol=1e-6)
    _check_orb(got, want, first_level_equal=False)


def test_orb_parity_config():
    cfg = t_fe.orb_parity_config(tiny_test_config())
    want = j_fe.orb_parity_config(j_tiny())
    assert cfg.frontend.max_keypoints == want.frontend.max_keypoints == 3000
    assert cfg.frontend.l2_ratio_threshold == want.frontend.l2_ratio_threshold
    assert cfg.frontend.l2_max_distance == want.frontend.l2_max_distance
