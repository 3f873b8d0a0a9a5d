"""The port's DepthNet (`vslam_tpu_torch.models.depthnet`) and its weight
loader against the JAX package's Flax module, on the same numpy inputs.

Tolerance: both run seven bf16 layers and an f32 head. The convolutions
accumulate in another order (XLA's and oneDNN's), so a bf16 rounding of
an activation can land one bf16 step apart and carry into later layers.
Log depth is held within 2e-3 on random-init parameters carried across
(measured 3.5e-4 on outputs of about 0.15) and within 3e-3 on the
committed checkpoint at 480x640 (measured on two rendered frames of the
seed-0 world: 1.7e-3 at 3 of 9,600 cells, the rest below 1e-3, on
outputs of about 2, i.e. 7 m); the keypoint depths DepthNet fills in
are held to the same relative tolerance. The 2x2 mean of the input is
summed in XLA's order and is exact. The weight mapping (HWIO -> OIHW) and the
SAME padding (Flax pads a 3x3 stride-2 conv on an even input by (0, 1))
are exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vslam_tpu.models import depthnet as j_dn
from vslam_tpu.models import weights as j_w
from vslam_tpu_torch.data import synthetic as t_syn
from vslam_tpu_torch.models import depthnet as t_dn
from vslam_tpu_torch.models import weights as t_w

RANDOM_ATOL = 2e-3
CHECKPOINT_ATOL = 3e-3


def _random_pair(seed, height, width):
    params = j_dn.init_params(jax.random.PRNGKey(seed), height=height, width=width)
    model = t_dn.DepthNet(device="cpu")
    model.load_state_dict(t_w.depthnet_state_dict_from_flax(params["params"]))
    return params, model.eval()


@pytest.fixture(scope="module")
def checkpoint():
    return j_w.depthnet_params_from_npz(t_w.TRAINED_DN_NPZ), t_w.load_depthnet(device="cpu")


def test_weights_match_the_flax_tree(checkpoint):
    params, model = checkpoint
    sd = model.state_dict()
    assert set(sd) == {f"{n}.{leaf}" for n, *_ in t_dn.LAYERS for leaf in ("weight", "bias")}
    for name, cin, cout, stride in t_dn.LAYERS:
        k = np.asarray(params["params"][name]["kernel"])
        assert k.shape == (3, 3, cin, cout)
        np.testing.assert_array_equal(sd[f"{name}.weight"].numpy(), k.transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd[f"{name}.bias"].numpy(),
                                      np.asarray(params["params"][name]["bias"]))
        assert getattr(model, name).stride == (stride, stride)


def test_load_depthnet_raises_without_a_checkpoint(tmp_path):
    """No random-init stand-in: a random net is no depth capability."""
    with pytest.raises(FileNotFoundError):
        t_w.load_depthnet(str(tmp_path / "missing.npz"), device="cpu")


@pytest.mark.parametrize("size, stride, pads", [(16, 2, (0, 1)), (15, 2, (1, 1)),
                                                (8, 1, (1, 1))])
def test_same_padding_is_xla_s(size, stride, pads):
    assert t_dn._same_pads(size, stride) == pads


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_random_init_vs_flax(seed):
    """96x160 net input, random-init parameters carried across."""
    params, model = _random_pair(seed, 96, 160)
    x = np.random.default_rng(seed).random((2, 96, 160, 1)).astype(np.float32)
    want = np.asarray(j_dn.DepthNet().apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 24, 40) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=RANDOM_ATOL, rtol=0)


def test_forward_rejects_other_sizes():
    _, model = _random_pair(0, 96, 160)
    with pytest.raises(ValueError):
        model(torch.zeros(1, 40, 64, 1))


def test_predict_log_depth_tiny_camera_padded():
    """The tiny camera's 120x160 frames: the net's 60x80 input is edge-
    padded to 64x80 and the output cropped back to 15x20 cells."""
    params, model = _random_pair(2, 64, 80)
    gray = np.random.default_rng(2).integers(0, 256, (3, 120, 160)).astype(np.uint8)
    want = np.asarray(j_dn.predict_log_depth(params, jnp.asarray(gray)))
    got = t_dn.predict_log_depth(model, torch.from_numpy(gray)).numpy()
    assert got.shape == want.shape == (3, 15, 20)
    np.testing.assert_allclose(got, want, atol=RANDOM_ATOL, rtol=0)


def test_predict_log_depth_checkpoint_full_size(checkpoint):
    """The committed checkpoint on two rendered 480x640 frames of the
    seed-0 world, then the keypoint depths it fills in."""
    params, model = checkpoint
    d = t_syn.make_image_sequence(2, seed=0, num_landmarks=6000, radius=3.0, with_rgb=False)
    want = np.asarray(j_dn.predict_log_depth(params, jnp.asarray(d["gray"])))
    got = t_dn.predict_log_depth(model, torch.from_numpy(d["gray"]))
    assert got.shape == want.shape == (2, 60, 80)
    np.testing.assert_allclose(got.numpy(), want, atol=CHECKPOINT_ATOL, rtol=0)
    assert 0.0 < float(np.exp(want).min()) and float(np.exp(want).max()) < 20.0

    kp = np.random.default_rng(3).uniform([-2, -2], [642, 482], (2, 50, 2)).astype(np.float32)
    dj = np.asarray(j_dn.sample_log_depth_at_keypoints(jnp.asarray(want), jnp.asarray(kp)))
    dt = t_dn.sample_log_depth_at_keypoints(torch.from_numpy(want), torch.from_numpy(kp))
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-6, atol=0)
    dt2 = t_dn.sample_log_depth_at_keypoints(got, torch.from_numpy(kp))
    np.testing.assert_allclose(dt2.numpy(), dj, rtol=CHECKPOINT_ATOL * 1.01, atol=0)
