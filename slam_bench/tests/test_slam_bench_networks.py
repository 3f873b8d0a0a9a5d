"""The networks a configuration names (`networks/<name>.py`): each
resolves and serves its role, the FLOPs behind `frame_mfu` are the ones
the harness counted before the seam, a name with no module fails before
anything is rendered, and a new depth network comes in as files alone."""

import copy
import os
import shutil

import pytest
import torch

from slam_bench import check, registry, run, study
from slam_bench.frozen import flops, generator

BENCH = registry.benchmark()
CONFIGS = {c["name"]: registry.load_json(os.path.join(registry.ROOT, c["file"]))
           for c in BENCH["configs"]}
CPU = torch.device("cpu")

TOY = '''"""A toy depth network: log depth is an offset plus the 4x4 mean of
the net's input (gray at half resolution), one cell per 8 pixels."""

import torch
import torch.nn.functional as F

from slam_bench.reference import frontend as ref_fe

ROLE = "depth"


class ToyDepth(torch.nn.Module):
    compute_dtype = torch.float32

    def __init__(self, offset):
        super().__init__()
        self.offset = offset

    def forward(self, image):
        return self.offset + F.avg_pool2d(image.permute(0, 3, 1, 2), 4)[:, 0]


def load(config, device):
    return ToyDepth(config["toydepth_offset"]).to(device)


def reference(config, device):
    return {"offset": config["toydepth_offset"]}


def reference_depth_at(params, gray_u8, xy, quant=None):
    N, H, W = gray_u8.shape
    g = (gray_u8.float() / 255.0).reshape(N, H // 2, 2, W // 2, 2).mean(dim=(2, 4))
    return ref_fe.depth_at(params["offset"] + F.avg_pool2d(g[:, None], 4)[:, 0], xy)


def flops_per_frame(config):
    c = config["slam"]["camera"]
    return float(c["height"] * c["width"] // 4)
'''


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_configuration_names_networks_that_resolve(name):
    nets = registry.networks(CONFIGS[name])
    assert set(nets) == set(CONFIGS[name]["networks"]) and "features" in nets
    for role, net in nets.items():
        assert net.ROLE == role
        for fn in ("load", "reference", "flops_per_frame", registry.ROLES[role]):
            assert callable(getattr(net, fn)), (name, role, fn)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_model_flops_are_the_ones_counted_before_the_seam(name):
    config = CONFIGS[name]
    s = config["slam"]
    c, fc, m = s["camera"], s["frontend"], s["map"]
    f = flops.superpoint_flops_per_frame(c["height"], c["width"])
    f += flops.tracking_flops_per_frame(fc["max_keypoints"], fc["descriptor_dim"],
                                        m["map_capacity"])
    if config.get("depthnet"):
        f += flops.depthnet_flops_per_frame(c["height"] // 2, c["width"] // 2)
    assert run.model_flops_per_frame(config) == f


@pytest.mark.parametrize("networks, error, text", [
    ({"features": "superpoint", "depth": "nosuchnet"}, FileNotFoundError,
     "networks/nosuchnet.py"),
    ({"features": "nosuchnet"}, FileNotFoundError, "networks/nosuchnet.py"),
    ({"features": "superpoint", "depth": "superpoint"}, ValueError, "'depth' role"),
    ({"depth": "depthnet"}, ValueError, "no features network"),
])
def test_a_network_that_does_not_resolve_fails_before_rendering(networks, error, text,
                                                                 monkeypatch, tiny_spec):
    from slam_bench.system import System

    def render(*args, **kwargs):
        raise AssertionError("rendered before the networks resolved")

    monkeypatch.setattr(generator, "make_worlds", render)
    spec = tiny_spec("mono_dn640.offline", frames=8)
    spec["config"]["networks"] = networks
    with pytest.raises(error, match=text):
        System(spec["config"], spec["traffic"], device=CPU, workers=1)


def test_a_new_depth_network_comes_in_as_files_alone(tmp_path, monkeypatch, tiny_spec):
    for f in os.listdir(registry.NETWORKS):
        if f.endswith(".py"):
            shutil.copy(os.path.join(registry.NETWORKS, f), tmp_path / f)
    (tmp_path / "toydepth.py").write_text(TOY)
    monkeypatch.setattr(registry, "NETWORKS", str(tmp_path))
    spec = tiny_spec("mono_dn640.offline", frames=8)
    config = spec["config"]
    config["networks"] = {"features": "superpoint", "depth": "toydepth"}
    config["toydepth_offset"] = 0.5

    numbers, system = study.one_sequence(spec, 0, CPU, workers=1)
    assert type(system.depth_model).__name__ == "ToyDepth"
    # Monocular: every keypoint's depth is the toy's, checked against the
    # toy's own reference at the program's keypoints.
    assert 0 <= numbers["depth_gap"] < 1e-5 and numbers["kp_miss"] < 0.05, numbers

    wrong = copy.deepcopy(config)
    wrong["toydepth_offset"] = 0.7
    gray = system.gray[:, 0]
    feats = check.reference_features(gray, config, CPU, None)
    assert check.frontend_numbers(feats, gray, wrong, CPU)["depth_gap"] == pytest.approx(0.2)

    c = config["slam"]["camera"]
    base = dict(config, networks={"features": "superpoint"})
    assert run.model_flops_per_frame(config) == (run.model_flops_per_frame(base)
                                                 + c["height"] * c["width"] // 4)
