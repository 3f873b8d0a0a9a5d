"""Depth Anything V2 Small, metric (Yang et al., arXiv:2406.09414; a
DINOv2 ViT-S/14 encoder and a DPT head, `max_depth` 20): the port's
module, the plain f32 reference of `reference/depth_anything.py` and its
FLOPs (`da2_flops.py`). The network's input size is the configuration's
`da2_small_input_size` (518, the published lower bound)."""

from __future__ import annotations

import os

from slam_bench import da2_flops
from slam_bench.reference import depth_anything as ref_da
from slam_bench.registry import ROOT

ROLE = "depth"


def load(config: dict, device):
    """The checkpoint `config["da2_small"]` in `config["da2_small_dtype"]`."""
    import torch

    from vslam_tpu_torch.models import weights

    return weights.load_depth_anything(os.path.join(ROOT, config["da2_small"]), device=device,
                                       compute_dtype=getattr(torch, config["da2_small_dtype"]),
                                       input_size=config["da2_small_input_size"])


def reference(config: dict, device) -> dict:
    params = ref_da.load_checkpoint(os.path.join(ROOT, config["da2_small"]), device)
    params["input_size"] = config["da2_small_input_size"]
    return params


def reference_depth_at(params, gray_u8, xy, quant=None):
    return ref_da.depth_at(params, gray_u8, xy, quant, params["input_size"])


def flops_per_frame(config: dict) -> float:
    c = config["slam"]["camera"]
    return da2_flops.flops_per_frame(c["height"], c["width"], config["da2_small_input_size"])
