"""The port's random init, checkpoint writers and loaders
(`vslam_tpu_torch.models.{superpoint,depthnet,weights}`) against the JAX
package's, on the CPU.

- `init_params`: Flax's `lecun_normal` drawn from a `torch.Generator`; it
  cannot equal Flax's bits, so each layer's kernel std is held within 10%
  of Flax's init of the same layer, biases zero.
- Both forwards carry gradients (the trainers call them directly).
- `save_superpoint_npz` / `save_depthnet_npz` write the JAX package's
  format: the committed checkpoint read by the port and written back is
  equal to it byte for byte in every array (f16 storage); a port-written
  file read by the JAX package's reader gives the JAX model outputs within
  1e-3 of the port's (bf16 compute in both).
- `superpoint_params_from_pth` on a MagicLeap-layout state dict built from
  Flax parameters: the same tensors as the Flax conversion, and as the JAX
  package's own `.pth` reader.
- `load_or_init_superpoint` falls back to random init, and
  `load_or_init_depthnet` raises, when no checkpoint is found.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vslam_tpu.models import depthnet as j_dn
from vslam_tpu.models import superpoint as j_sp
from vslam_tpu.models import weights as j_w
from vslam_tpu_torch.models import depthnet as t_dn
from vslam_tpu_torch.models import superpoint as t_sp
from vslam_tpu_torch.models import weights as t_w


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _layer_stds(sd):
    return {k[: -len(".weight")]: float(v.std()) for k, v in sd.items() if k.endswith(".weight")}


@pytest.mark.parametrize("net", ["superpoint", "depthnet"])
def test_init_matches_flax_statistics(net):
    if net == "superpoint":
        flax = j_sp.init_params(jax.random.PRNGKey(0), height=16, width=16)["params"]
        ours = t_sp.init_params(generator=torch.Generator().manual_seed(0))
        want = t_w.superpoint_state_dict_from_flax(flax)
    else:
        flax = j_dn.init_params(jax.random.PRNGKey(0), height=16, width=16)["params"]
        ours = t_dn.init_params(generator=torch.Generator().manual_seed(0))
        want = t_w.depthnet_state_dict_from_flax(flax)
    assert ours.keys() == want.keys()
    for k in ours:
        assert ours[k].shape == want[k].shape and ours[k].dtype == torch.float32, k
        if k.endswith(".bias"):
            assert not ours[k].any() and not want[k].any(), k
    so, sw = _layer_stds(ours), _layer_stds(want)
    for k in so:
        assert abs(so[k] / sw[k] - 1.0) <= 0.10, (k, so[k], sw[k])
    # the truncation at two standard deviations
    for k, v in ours.items():
        if k.endswith(".weight"):
            fan_in = v.shape[1] * v.shape[2] * v.shape[3]
            assert float(v.abs().max()) <= 2.0 * (1.0 / fan_in) ** 0.5 / 0.87962566103423978 + 1e-6
    again = (t_sp if net == "superpoint" else t_dn).init_params(
        generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(again[k], ours[k]) for k in ours)


def test_forwards_carry_gradients():
    x = torch.rand(2, 32, 32, 1)
    sp = t_sp.SuperPoint(device="cpu")
    sp.load_state_dict(t_sp.init_params(seed=1))
    semi, desc = sp(x)
    (semi.square().mean() + desc.square().mean()).backward()
    dn = t_dn.DepthNet(device="cpu")
    dn.load_state_dict(t_dn.init_params(seed=1))
    dn(x).square().mean().backward()
    for model in (sp, dn):
        for name, p in model.named_parameters():
            assert p.grad is not None and bool(p.grad.abs().sum() > 0), name


@pytest.mark.parametrize("net", ["superpoint", "depthnet"])
def test_npz_round_trip_is_bitwise(net, tmp_path):
    src = t_w.TRAINED_SP_NPZ if net == "superpoint" else t_w.TRAINED_DN_NPZ
    read = getattr(t_w, f"{net}_params_from_npz")
    write = getattr(t_w, f"save_{net}_npz")
    out = str(tmp_path / "rt.npz")
    write(out, read(src))
    with np.load(src) as a, np.load(out) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float16
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_port_written_npz_read_by_jax(tmp_path):
    x = np.random.default_rng(0).random((1, 32, 48, 1)).astype(np.float32)
    sp = t_sp.SuperPoint(device="cpu")
    sp.load_state_dict(t_sp.init_params(seed=3))
    path = str(tmp_path / "sp.npz")
    t_w.save_superpoint_npz(path, sp)
    sj, dj = j_sp.SuperPoint().apply(j_w.superpoint_params_from_npz(path), jnp.asarray(x))
    with torch.no_grad():
        st, dt = t_w.load_superpoint(path, device="cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-3, rtol=0)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-3, rtol=0)
    dn = t_dn.DepthNet(device="cpu")
    dn.load_state_dict(t_dn.init_params(seed=3))
    path = str(tmp_path / "dn.npz")
    t_w.save_depthnet_npz(path, dn)
    oj = j_dn.DepthNet().apply(j_w.depthnet_params_from_npz(path), jnp.asarray(x))
    with torch.no_grad():
        ot = t_w.load_depthnet(path, device="cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-3, rtol=0)


def test_superpoint_pth_converter(tmp_path):
    flax = j_sp.init_params(jax.random.PRNGKey(4), height=16, width=16)["params"]
    sd = t_w.superpoint_state_dict_from_flax(flax)
    path = str(tmp_path / "superpoint_v1.pth")
    torch.save({k: v.clone() for k, v in sd.items()}, path)
    got = t_w.superpoint_params_from_pth(path)
    assert got.keys() == sd.keys()
    for k in sd:
        assert torch.equal(got[k], sd[k]), k
    via_jax = t_w.superpoint_state_dict_from_flax(
        jax.tree.map(np.asarray, j_w.superpoint_params_from_pth(path)["params"]))
    for k in sd:
        assert torch.equal(via_jax[k], got[k]), k
    model, src = t_w.load_or_init_superpoint(search_dirs=(str(tmp_path),), device="cpu")
    assert src == path
    assert all(torch.equal(model.state_dict()[k], sd[k]) for k in sd)


def test_load_or_init_fallbacks(tmp_path, monkeypatch):
    model, src = t_w.load_or_init_superpoint(search_dirs=(str(tmp_path),), device="cpu")
    assert src.endswith("superpoint_synth.npz") and not model.training
    model, src = t_w.load_or_init_depthnet(search_dirs=(str(tmp_path),), device="cpu")
    assert src.endswith("depthnet_synth.npz")
    monkeypatch.setattr(t_w, "_CKPT", str(tmp_path / "none"))
    model, src = t_w.load_or_init_superpoint(search_dirs=(str(tmp_path),), device="cpu", seed=2)
    assert src == "random-init"
    want = t_sp.init_params(seed=2)
    assert all(torch.equal(model.state_dict()[k], want[k]) for k in want)
    with pytest.raises(FileNotFoundError):
        t_w.load_or_init_depthnet(search_dirs=(str(tmp_path),), device="cpu")


def test_no_default_output_points_into_the_jax_package():
    """The port's writers and apps never default to the JAX package's
    committed checkpoint directory."""
    from vslam_tpu_torch.apps import train_depthnet, train_superpoint

    jax_dir = os.path.dirname(t_w.TRAINED_SP_NPZ)
    for mod in (train_superpoint, train_depthnet):
        assert not os.path.abspath(mod.DEFAULT_OUT).startswith(jax_dir)
        assert mod.DEFAULT_OUT.startswith("out_torch")
