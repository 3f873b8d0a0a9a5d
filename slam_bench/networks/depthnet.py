"""DepthNet, the repo's own monocular depth network (8 convs, log depth
at 1/8 of the camera's resolution from gray at half of it): the port's
module, the plain f32 reference of `reference/frontend.py` and its
FLOPs."""

from __future__ import annotations

import os

from slam_bench.frozen import flops
from slam_bench.reference import frontend as ref_fe
from slam_bench.registry import ROOT

ROLE = "depth"


def load(config: dict, device):
    """The checkpoint `config["depthnet"]` in `config["depthnet_dtype"]`."""
    import torch

    from vslam_tpu_torch.models import weights

    return weights.load_depthnet(os.path.join(ROOT, config["depthnet"]), device=device,
                                 compute_dtype=getattr(torch, config["depthnet_dtype"]))


def reference(config: dict, device) -> dict:
    return ref_fe.load_checkpoint(os.path.join(ROOT, config["depthnet"]), device)


def reference_depth_at(params, gray_u8, xy, quant=None):
    return ref_fe.depth_at(ref_fe.depthnet_log_depth(params, gray_u8, quant), xy)


def flops_per_frame(config: dict) -> float:
    """At the net's input: half the camera's height and width."""
    c = config["slam"]["camera"]
    return flops.depthnet_flops_per_frame(c["height"] // 2, c["width"] // 2)
