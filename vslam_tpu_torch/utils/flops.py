"""Analytic FLOP models for achieved-TFLOP/s reporting.

Port of `vslam_tpu/utils/flops.py`: FLOPs = 2 * MACs for convolutions and
matmuls, elementwise work ignored (< 1% of the totals). Numbers are per
frame. A SuperPoint training step counts 3x the forward (the forward plus
a backward of twice its cost) for each of the step's two views
(`superpoint_train_step_flops`).
"""

from __future__ import annotations


def superpoint_flops_per_frame(height: int, width: int) -> float:
    """SuperPoint-v1 backbone + heads (`models/superpoint.py`): 3x3 convs
    at full/half/quarter/eighth resolution + two 1x1 head convs.

    conv FLOPs = 2 * k*k*Cin * Cout * H_l * W_l.
    """
    H, W = height, width
    layers = [
        # (Cin, Cout, k, H_l, W_l)
        (1, 64, 3, H, W),               # conv1a
        (64, 64, 3, H, W),              # conv1b
        (64, 64, 3, H // 2, W // 2),    # conv2a
        (64, 64, 3, H // 2, W // 2),    # conv2b
        (64, 128, 3, H // 4, W // 4),   # conv3a
        (128, 128, 3, H // 4, W // 4),  # conv3b
        (128, 128, 3, H // 8, W // 8),  # conv4a
        (128, 128, 3, H // 8, W // 8),  # conv4b
        (128, 256, 3, H // 8, W // 8),  # convPa
        (256, 65, 1, H // 8, W // 8),   # convPb
        (128, 256, 3, H // 8, W // 8),  # convDa
        (256, 256, 1, H // 8, W // 8),  # convDb
    ]
    return float(sum(2 * ci * co * k * k * hl * wl for ci, co, k, hl, wl in layers))


def tracking_flops_per_frame(max_keypoints: int, descriptor_dim: int, map_capacity: int) -> float:
    """Dominant matmuls of one tracking step (`core/tracking.py`): KF
    descriptor matching (K x K x D) and the local-map radius matching +
    pixel-distance products (M x K x (D + 2)). RANSAC solves and the rare
    branches are excluded."""
    K, D, M = max_keypoints, descriptor_dim, map_capacity
    knn = 2.0 * K * K * D
    local_map = 2.0 * M * K * D + 2.0 * M * K * 2
    return float(knn + local_map)


def superpoint_train_step_flops(batch: int, height: int, width: int) -> float:
    """One SuperPoint training step: forward + backward (2x the forward)
    on both views (image and warped) of `batch` images."""
    return 3.0 * superpoint_flops_per_frame(height, width) * 2 * batch


def depthnet_flops_per_frame(height: int, width: int) -> float:
    """DepthNet (`models/depthnet.py`) at an input of height x width: four
    stride-2 3x3 convs, the middle conv, two upsample convs on the
    concatenated skips and the head, each at its output resolution."""
    H, W = height, width
    layers = [
        (1, 24, H // 2, W // 2), (24, 48, H // 4, W // 4), (48, 96, H // 8, W // 8),
        (96, 128, H // 16, W // 16), (128, 128, H // 16, W // 16),
        (128 + 96, 96, H // 8, W // 8), (96 + 48, 64, H // 4, W // 4), (64, 1, H // 4, W // 4),
    ]
    return float(sum(2 * ci * co * 9 * hl * wl for ci, co, hl, wl in layers))


def depthnet_train_step_flops(batch: int, height: int, width: int) -> float:
    """One DepthNet training step: forward + backward (2x) on `batch`."""
    return 3.0 * depthnet_flops_per_frame(height, width) * batch


def describe() -> str:
    return (
        "FLOPs=2*MACs; frontend = SuperPoint conv stack at layer "
        "resolutions; tracking = KF KNN matmul + local-map descriptor/"
        "pixel matmuls (rare branches excluded, counts reported); a "
        "training step = 3x forward per view"
    )
