"""SuperPoint-v1 (DeTone et al., arXiv:1712.07629), the frontend's
keypoint and descriptor network: the port's bf16 module, the plain f32
reference of `reference/frontend.py` and its FLOPs."""

from __future__ import annotations

import os

from slam_bench.frozen import flops
from slam_bench.reference import frontend as ref_fe
from slam_bench.registry import ROOT

ROLE = "features"


def load(config: dict, device):
    """The checkpoint `config["superpoint"]` in `config["superpoint_dtype"]`."""
    import torch

    from vslam_tpu_torch.models import weights

    return weights.load_superpoint(os.path.join(ROOT, config["superpoint"]), device=device,
                                   compute_dtype=getattr(torch, config["superpoint_dtype"]))


def reference(config: dict, device) -> dict:
    return ref_fe.load_checkpoint(os.path.join(ROOT, config["superpoint"]), device)


def reference_features(params, gray_u8, frontend_cfg: dict, quant=None):
    return ref_fe.superpoint(params, gray_u8, frontend_cfg["max_keypoints"],
                             frontend_cfg["sp_nms_radius"],
                             frontend_cfg["sp_confidence_threshold"], quant)


def flops_per_frame(config: dict) -> float:
    c = config["slam"]["camera"]
    return flops.superpoint_flops_per_frame(c["height"], c["width"])
