"""Depth Anything V2 Small as the depth network of `mono_da2s518`: the
registry finds `networks/da2_small.py`, its FLOPs are the published
widths' count, and its plain reference agrees with the port at toy size
on the CPU (seeded random weights in a bf16 checkpoint, the resize's
lower bound at 42 on 42x56 frames)."""

import os

import pytest
import torch

from slam_bench import da2_flops, registry, run

CPU = torch.device("cpu")
CONFIG = registry.load_json(os.path.join(registry.HERE, "configs", "mono_da2s518.json"))


def test_the_registry_finds_the_network():
    nets = registry.networks(CONFIG)
    assert set(nets) == {"features", "depth"}
    assert nets["depth"].ROLE == "depth" and nets["depth"].__name__.endswith("da2_small")
    assert nets["depth"].flops_per_frame(CONFIG) == pytest.approx(167.465e9, rel=1e-5)
    assert run.model_flops_per_frame(CONFIG) == pytest.approx(
        run.model_flops_per_frame(dict(CONFIG, networks={"features": "superpoint"}))
        + da2_flops.flops_per_frame(480, 640), rel=1e-12)
    parts = da2_flops.parts(480, 640)
    assert parts["attention"] == 12 * 4 * 1814 ** 2 * 384


def test_reference_depth_agrees_with_the_port_at_toy_size(tmp_path):
    from vslam_tpu_torch.models import depth_anything as da
    from vslam_tpu_torch.models import weights

    m = da.DepthAnythingV2(device="cpu", input_size=42)
    m.load_state_dict(da.init_params(seed=3))
    path = str(tmp_path / "da2.npz")
    weights.save_depth_anything_npz(path, m)
    config = dict(CONFIG, da2_small=path, da2_small_input_size=42)
    net = registry.networks(config)["depth"]
    model, params = net.load(config, CPU), net.reference(config, CPU)
    assert model.compute_dtype == torch.bfloat16 and model.input_size == 42
    g = torch.Generator().manual_seed(0)
    gray = torch.randint(0, 256, (2, 42, 56), dtype=torch.uint8, generator=g)
    xy = torch.rand(2, 40, 2, generator=g) * torch.tensor([55.0, 41.0])
    got = model.keypoint_depth(gray, xy)
    with torch.no_grad():
        want = net.reference_depth_at(params, gray, xy)
    assert got.shape == want.shape == (2, 40)
    assert float((got.log() - want.log()).abs().max()) < 5e-4
