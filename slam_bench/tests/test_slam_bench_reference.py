"""The plain reference: independent of the program, and equal to the
program's own float32 paths on the CPU; its fp8 control fails the
frontend's limits."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from slam_bench import check, registry
from slam_bench.reference import frontend as ref_fe
from slam_bench.reference import fusion as ref_fu
from slam_bench.reference import trajectory as ref_tr

REF = os.path.join(registry.HERE, "reference")
SP = os.path.join(registry.ROOT, "vslam_tpu/models/checkpoints/superpoint_synth.npz")
DN = os.path.join(registry.ROOT, "vslam_tpu/models/checkpoints/depthnet_synth.npz")


def _frames(n=3):
    from slam_bench.frozen import generator

    w = generator.make_worlds([0], n, (120.0, 120.0, 79.5, 59.5, 160, 120), num_landmarks=600)
    return w


def test_reference_imports_nothing_of_the_program():
    for f in os.listdir(REF):
        if f.endswith(".py"):
            tree = ast.parse(open(os.path.join(REF, f)).read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for n in names:
                    assert n.split(".")[0] in {"numpy", "torch", "__future__"}, (f, n)
    code = ("import sys; import slam_bench.reference.frontend, slam_bench.reference.fusion, "
            "slam_bench.reference.trajectory; print(sorted({m.split('.')[0] for m in "
            "sys.modules} & {'vslam_tpu_torch', 'vslam_tpu', 'jax', 'jaxlib', 'flax', 'optax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_superpoint_equals_the_ports_float32_path():
    from vslam_tpu_torch.models import weights
    from vslam_tpu_torch.ops import camera, nms

    gray = torch.from_numpy(_frames()["gray"][0])
    model = weights.load_superpoint(SP, device="cpu", compute_dtype=torch.float32)
    with torch.no_grad():
        semi, desc = model(camera.unit_gray(gray)[..., None])
    kps, pdesc = nms.extract_keypoints(semi, desc, max_keypoints=64, radius=4, conf=0.005)
    xy, valid, rdesc = ref_fe.superpoint(ref_fe.load_checkpoint(SP, "cpu"), gray, 64, 4, 0.005)
    # The same keypoints (the order of near-equal scores may differ) and
    # descriptors.
    misses, total, gap = check.keypoint_gaps(kps.xy, kps.valid, pdesc, xy, valid, rdesc)
    assert misses == 0 and total == 2 * int(valid.sum()) > 100 and gap < 1e-4


def test_depthnet_equals_the_ports_float32_path():
    from vslam_tpu_torch.models import depthnet, weights

    gray = torch.from_numpy(_frames()["gray"][0])
    model = weights.load_depthnet(DN, device="cpu", compute_dtype=torch.float32)
    want = depthnet.predict_log_depth(model, gray)
    got = ref_fe.depthnet_log_depth(ref_fe.load_checkpoint(DN, "cpu"), gray)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    xy = torch.rand(3, 20, 2) * torch.tensor([159.0, 119.0])
    torch.testing.assert_close(ref_fe.depth_at(got, xy),
                               depthnet.sample_log_depth_at_keypoints(want, xy),
                               atol=1e-4, rtol=1e-4)


def test_fusion_equals_the_ports_bit_for_bit():
    from slam_bench.system import slam_config
    from vslam_tpu_torch.core import coupled
    from vslam_tpu_torch.ops import gridhash

    spec = registry.cell("rgbd_sp640.offline")
    cfg = spec["config"]
    cfg["slam"]["camera"].update(width=160, height=120, fx=120.0, fy=120.0, cx=79.5, cy=59.5)
    cfg["slam"]["dense"].update(hash_capacity=1 << 10, cloud_capacity=900)
    w = _frames(6)
    R, t, depth = w["R"][0], w["t"][0] + np.float32(0.013), w["depth_u16"][0]
    dense = gridhash.init_dense_map(1 << 10, 900, device="cpu")
    dense = coupled.fuse_chunk(dense, torch.from_numpy(depth.astype(np.int32)), None,
                               torch.from_numpy(R), torch.from_numpy(t), slam_config(cfg), 6)
    s = cfg["slam"]
    ref = ref_fu.fused_cloud(depth, R, t, s["camera"], s["dense"])
    n = int(dense.cloud_count)
    assert n == len(ref) > 200  # a 1,024-slot table: collisions drop points
    assert ref_fu.cloud_diff(dense.cloud_xyz[:n].numpy(), ref) == 0


@pytest.mark.parametrize("with_scale", [False, True])
def test_trajectory_error_is_the_ports(with_scale):
    from vslam_tpu_torch.eval import ate

    rng = np.random.default_rng(1)
    gt = rng.normal(size=(50, 3))
    est = 0.7 * gt @ np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]).T + rng.normal(0, 0.01,
                                                                                  (50, 3))
    ts = np.arange(50) * 0.1
    want = ate.compute_ate(ts, est, ts, gt, with_scale=with_scale).rmse
    got = ref_tr.ate_rmse(ref_tr.aligned_errors(est, gt, with_scale))
    assert got == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("cell", ["rgbd_sp640.offline", "mono_dn640.offline"])
def test_the_fp8_control_fails_the_frontend_limits(cell, tiny_spec):
    spec = tiny_spec(cell)
    gray = torch.from_numpy(_frames(8)["gray"][0])
    feats = check.reference_features(gray, spec["config"], torch.device("cpu"),
                                     ref_fe.fp8_quant)
    numbers = check.frontend_numbers(feats, gray, spec["config"], torch.device("cpu"))
    frontend = {k: v for k, v in spec["limits"].items() if k in numbers}
    assert not check.judge(numbers, frontend), json.dumps(numbers)
