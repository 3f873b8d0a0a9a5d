"""The port's MiDaS v2.1-small (`vslam_tpu_torch.models.midas`, the MiDaS
half of `models.weights`) against the JAX package's Flax model, with
random-init Flax parameters carried across by `midas_state_dict_from_flax`
(no MiDaS checkpoint is in the repository).

The BatchNorm statistics are jittered away from their init (all-ones
variance), so that the epsilon and the statistics matter. Everything runs
in f32 (the Flax model's `compute_dtype=float32`).

Tolerances (f32 convolutions summing in other orders):
- the encoder taps and a fusion block: within 1e-4 of the largest
  magnitude (relative);
- each block alone (`MBConvLite` at expand 1 and 6, stride 1 and 2, the
  residual included; `ResidualConvUnit`; `FeatureFusionBlock` without a
  skip): within 1e-5 of the largest magnitude (3.3e-7 measured on the
  `MBConvLite` cases);
- the whole net at 64x64: within 2e-5 of the largest output magnitude
  (1.2e-4 on outputs up to ~30 measured);
- `estimate_depth` (resize in, net, resize out, min-max): within 1e-4;
- `_upsample2` (`F.interpolate`, align_corners=True) against JAX's: within 4e-6
  (the sample positions come from `jnp.linspace` on one side and an
  index times (n_in - 1) / (n_out - 1) on the other: 1.8e-6 measured on
  values up to ~2);
- the `.pth` round trip: the converted state dict equal, leaf for leaf.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vslam_tpu.models import midas as j_midas
from vslam_tpu_torch.models import midas as t_midas
from vslam_tpu_torch.models import weights as t_w


@pytest.fixture(scope="module")
def variables():
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: j_midas.init_params(k, size=64))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)

    def jitter(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = jitter(v)
            else:
                v = v + rng.normal(0, 0.05, v.shape).astype(v.dtype)
                out[k] = np.abs(v) + 0.5 if k == "var" else v
        return out

    return jitter({k: dict(v) for k, v in params.items()})


@pytest.fixture(scope="module")
def model(variables):
    return t_midas.MidasSmall(t_w.midas_state_dict_from_flax(variables),
                              compute_dtype=torch.float32, device="cpu")


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def test_param_shapes_cover_the_flax_tree(variables):
    sd = t_w.midas_state_dict_from_flax(variables)
    assert set(sd) == set(t_midas.PARAM_SHAPES)
    for k, v in sd.items():
        assert tuple(v.shape) == t_midas.PARAM_SHAPES[k], k
    n_flax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(variables))
    assert sum(v.numel() for v in sd.values()) == n_flax


def test_encoder_taps(variables, model):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    enc = j_midas.EfficientNetLite3(dtype=jnp.float32)
    want = enc.apply({"params": variables["params"]["encoder"],
                      "batch_stats": variables["batch_stats"]["encoder"]}, jnp.asarray(x))
    with torch.no_grad():
        got = model.pretrained(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w, c in zip(got, want, (32, 48, 136, 384)):
        w = np.asarray(w)
        assert w.shape[-1] == c
        _close(g.permute(0, 2, 3, 1).numpy(), w, 1e-4)


def test_fusion_block(variables, model):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 8, 8, 128)).astype(np.float32)
    skip = rng.normal(size=(1, 8, 8, 128)).astype(np.float32)
    blk = j_midas.FeatureFusionBlock(128, 64)
    want = np.asarray(blk.apply({"params": variables["params"]["refine2"]}, jnp.asarray(x),
                                jnp.asarray(skip)))
    with torch.no_grad():
        got = model.scratch.refinenet2(torch.from_numpy(x).permute(0, 3, 1, 2),
                                       torch.from_numpy(skip).permute(0, 3, 1, 2))
    assert want.shape == (1, 16, 16, 64)
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-4)


@pytest.mark.parametrize("hw", [(4, 4), (5, 7)])
def test_upsample2_is_align_corners(hw):
    x = np.random.default_rng(4).normal(size=(2, *hw, 3)).astype(np.float32)
    want = np.asarray(j_midas._upsample2(jnp.asarray(x)))
    got = t_midas._upsample2(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=4e-6, rtol=0)


def test_whole_net_matches_flax(variables, model):
    img = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: j_midas.MidasSmall(compute_dtype=jnp.float32)
                              .apply(v, x))(variables, jnp.asarray(img)))
    with torch.no_grad():
        got = model(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2, 64, 64)
    _close(got, want, 2e-5)
    with pytest.raises(ValueError, match="multiple of 32"):
        model(torch.zeros(1, 48, 40, 3))


def test_estimate_depth_matches_jax(variables, model):
    img = np.random.default_rng(6).uniform(0, 1, (2, 48, 80, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: j_midas.estimate_depth(
        v, x, model=j_midas.MidasSmall(compute_dtype=jnp.float32), size=64))(
            variables, jnp.asarray(img)))
    got = t_midas.estimate_depth(model, torch.from_numpy(img), size=64).numpy()
    assert got.shape == (2, 48, 80) and got.min() == 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_pth_round_trip_through_load_or_init(tmp_path, variables):
    """A state dict with the public checkpoint's key names, the BatchNorm
    counters and the unused `refinenet4.resConfUnit1` that real files
    carry, saved with torch.save and found by `load_or_init_midas`."""
    sd = t_w.midas_state_dict_from_flax(variables)
    extra = dict(sd)
    for k in [k for k in sd if k.endswith(".running_mean")]:
        extra[k.replace(".running_mean", ".num_batches_tracked")] = torch.tensor(0)
    c = sd["scratch.refinenet4.resConfUnit2.conv1.weight"]
    for u in ("conv1", "conv2"):
        extra[f"scratch.refinenet4.resConfUnit1.{u}.weight"] = torch.randn_like(c)
        extra[f"scratch.refinenet4.resConfUnit1.{u}.bias"] = torch.zeros(c.shape[0])
    torch.save(extra, tmp_path / "midas_v21_small_256.pt")
    model, src = t_w.load_or_init_midas(search_dirs=(str(tmp_path),), device="cpu",
                                        compute_dtype=torch.float32)
    assert src.endswith("midas_v21_small_256.pt")
    for k, v in sd.items():
        assert torch.equal(model.p(k), v), k
    empty, src = t_w.load_or_init_midas(search_dirs=(str(tmp_path / "none"),), device="cpu")
    assert src == "random-init"
    again, _ = t_w.load_or_init_midas(search_dirs=(), device="cpu")
    for k in t_midas.PARAM_SHAPES:
        assert torch.equal(empty.p(k), again.p(k))


# Flax MBConvLite names -> timm's (the port's), by expansion.
_MB_NAMES = {1: {"dw_conv": "conv_dw", "bn1": "bn1", "project_conv": "conv_pw", "bn2": "bn2"},
             6: {"expand_conv": "conv_pw", "bn0": "bn1", "dw_conv": "conv_dw", "bn1": "bn2",
                 "project_conv": "conv_pwl", "bn2": "bn3"}}


def _mbconv_state_dict(params, stats, expand):
    sd = {}
    for src, dst in _MB_NAMES[expand].items():
        if src in stats:
            for a, b in (("weight", params[src]["scale"]), ("bias", params[src]["bias"]),
                         ("running_mean", stats[src]["mean"]), ("running_var", stats[src]["var"])):
                sd[f"{dst}.{a}"] = torch.from_numpy(np.array(b, np.float32))
        else:
            sd[f"{dst}.weight"] = torch.from_numpy(
                np.array(np.asarray(params[src]["kernel"], np.float32).transpose(3, 2, 0, 1)))
    return sd


@pytest.mark.parametrize("expand,stride,kernel,cin,cout", [
    (1, 1, 3, 16, 16), (1, 2, 5, 16, 24), (6, 1, 5, 24, 24), (6, 2, 3, 16, 24)])
def test_mbconv_lite_matches_flax(expand, stride, kernel, cin, cout):
    """One block against the Flax module (f32), the BatchNorm statistics
    jittered; stride 1 with equal channels takes the residual."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 12, 10, cin)).astype(np.float32)
    blk = j_midas.MBConvLite(cout, expand, kernel, stride, dtype=jnp.float32)
    v = jax.tree_util.tree_map(np.asarray, blk.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    stats = {k: {"mean": rng.normal(0, 0.1, s["mean"].shape).astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)}
             for k, s in v["batch_stats"].items()}
    params = {k: ({"scale": rng.uniform(0.5, 1.5, p["scale"].shape).astype(np.float32),
                   "bias": rng.normal(0, 0.1, p["bias"].shape).astype(np.float32)}
                  if k in stats else p) for k, p in v["params"].items()}
    want = np.asarray(blk.apply({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    ours = t_midas.MBConvLite(cin, cout, expand, kernel, stride)
    ours.load_state_dict(_mbconv_state_dict(params, stats, expand))
    with torch.no_grad():
        got = ours(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, -(-12 // stride), -(-10 // stride), cout)
    _close(got, want, 1e-5)


def test_residual_conv_unit(variables, model):
    x = np.random.default_rng(8).normal(size=(1, 6, 5, 128)).astype(np.float32)
    want = np.asarray(j_midas.ResidualConvUnit(128).apply(
        {"params": variables["params"]["refine2"]["rcu1"]}, jnp.asarray(x)))
    with torch.no_grad():
        got = model.scratch.refinenet2.resConfUnit1(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-5)


def test_fusion_block_without_skip(variables, model):
    """The top level (refinenet4): no skip input, so no rcu1."""
    x = np.random.default_rng(9).normal(size=(1, 2, 3, 512)).astype(np.float32)
    want = np.asarray(j_midas.FeatureFusionBlock(512, 256).apply(
        {"params": variables["params"]["refine4"]}, jnp.asarray(x)))
    assert not hasattr(model.scratch.refinenet4, "resConfUnit1")
    with torch.no_grad():
        got = model.scratch.refinenet4(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert want.shape == (1, 4, 6, 256)
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-5)
