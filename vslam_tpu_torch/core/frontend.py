"""SuperPoint frontend over frame chunks + keypoint depth.

Ports `vslam_tpu/core/frontend.py:150` (`sample_depth_at_keypoints`) and
the frontend half of `vslam_tpu/core/coupled.py:42-64` and `:108-115`
(the DepthNet fill of keypoints without sensor depth).
"""

from __future__ import annotations

import torch

from vslam_tpu_torch.core.state import FrameFeatures
from vslam_tpu_torch.models import depthnet
from vslam_tpu_torch.ops import nms


def sample_depth_at_keypoints(depth_maps, kp_xy):
    """Nearest-pixel depth per keypoint: depth_maps (B, H, W) meters,
    kp_xy (B, K, 2) -> (B, K). Rounds half to even, as jnp.round does."""
    B, H, W = depth_maps.shape
    u = torch.clamp(torch.round(kp_xy[..., 0]).to(torch.int64), 0, W - 1)
    v = torch.clamp(torch.round(kp_xy[..., 1]).to(torch.int64), 0, H - 1)
    return torch.gather(depth_maps.reshape(B, H * W), 1, v * W + u)


def extract_chunk(model, gray_u8, config):
    """(C, H, W) uint8 -> (Keypoints, descriptors (C, K, D)): the whole
    SuperPoint frontend. Small-descriptor configs truncate and
    renormalize, as the JAX package does."""
    fc = config.frontend
    images = (gray_u8.to(torch.float32) / 255.0)[..., None]
    with torch.no_grad():
        semi, desc_c = model(images)
    kps, desc = nms.extract_keypoints(
        semi, desc_c, max_keypoints=fc.max_keypoints,
        radius=fc.sp_nms_radius, conf=fc.sp_confidence_threshold,
    )
    if desc.shape[-1] != fc.descriptor_dim:
        desc = desc[..., : fc.descriptor_dim]
        desc = desc / torch.clamp(torch.sqrt(torch.sum(desc * desc, -1, keepdim=True)), min=1e-8)
    return kps, desc


def predicted_keypoint_depth(depth_model, gray_u8, kp_xy):
    """DepthNet's metric depth (C, K) at the keypoints of a chunk."""
    return depthnet.sample_log_depth_at_keypoints(
        depthnet.predict_log_depth(depth_model, gray_u8), kp_xy)


def frontend_features(model, gray_u8, depth_u16, timestamps, frame_ids, stationary,
                      config, depth_model=None) -> FrameFeatures:
    """One chunk of frames -> stacked FrameFeatures (C leading). With a
    `depth_model` (`models.depthnet.DepthNet`), a keypoint whose sensor
    depth is not above `camera.depth_min` takes DepthNet's depth."""
    kps, desc = extract_chunk(model, gray_u8, config)
    depth_m = depth_u16.to(torch.float32) / config.camera.depth_scale
    kpd = sample_depth_at_keypoints(depth_m, kps.xy)
    if depth_model is not None:
        kpd_pred = predicted_keypoint_depth(depth_model, gray_u8, kps.xy)
        kpd = torch.where(kpd > config.camera.depth_min, kpd, kpd_pred)
    return FrameFeatures(
        xy=kps.xy, desc=desc, depth=kpd, valid=kps.valid,
        timestamp=timestamps, stationary=stationary, frame_id=frame_ids,
    )
