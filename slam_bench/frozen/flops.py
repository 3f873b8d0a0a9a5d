"""Model FLOPs per frame from shapes: a frozen copy.

Copied from `vslam_tpu_torch/utils/flops.py` at commit a3a4213
(`superpoint_flops_per_frame`, `depthnet_flops_per_frame`,
`tracking_flops_per_frame`). FLOPs = 2 * MACs of the convolutions and
the tracking step's dominant matmuls; elementwise work is left out.
"""

from __future__ import annotations


def superpoint_flops_per_frame(height: int, width: int) -> float:
    """SuperPoint-v1: 3x3 convs at full/half/quarter/eighth resolution and
    the two heads (2 * k*k*Cin * Cout * H_l * W_l each)."""
    H, W = height, width
    layers = [
        (1, 64, 3, H, W), (64, 64, 3, H, W),
        (64, 64, 3, H // 2, W // 2), (64, 64, 3, H // 2, W // 2),
        (64, 128, 3, H // 4, W // 4), (128, 128, 3, H // 4, W // 4),
        (128, 128, 3, H // 8, W // 8), (128, 128, 3, H // 8, W // 8),
        (128, 256, 3, H // 8, W // 8), (256, 65, 1, H // 8, W // 8),
        (128, 256, 3, H // 8, W // 8), (256, 256, 1, H // 8, W // 8),
    ]
    return float(sum(2 * ci * co * k * k * hl * wl for ci, co, k, hl, wl in layers))


def tracking_flops_per_frame(max_keypoints: int, descriptor_dim: int, map_capacity: int) -> float:
    """Keyframe descriptor matching (K x K x D) and the local-map radius
    match with its pixel-distance products (M x K x (D + 2))."""
    K, D, M = max_keypoints, descriptor_dim, map_capacity
    return float(2.0 * K * K * D + 2.0 * M * K * D + 2.0 * M * K * 2)


def depthnet_flops_per_frame(height: int, width: int) -> float:
    """DepthNet at an input of height x width (half the camera's)."""
    H, W = height, width
    layers = [
        (1, 24, H // 2, W // 2), (24, 48, H // 4, W // 4), (48, 96, H // 8, W // 8),
        (96, 128, H // 16, W // 16), (128, 128, H // 16, W // 16),
        (128 + 96, 96, H // 8, W // 8), (96 + 48, 64, H // 4, W // 4), (64, 1, H // 4, W // 4),
    ]
    return float(sum(2 * ci * co * 9 * hl * wl for ci, co, hl, wl in layers))
