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


def depth_anything_flops_per_frame(height: int, width: int) -> float:
    """Depth Anything V2 Small (`models/depth_anything.py`) at its input
    of height x width (multiples of 14): the patch embedding, each of the
    12 blocks' linear layers (24 N C^2, C 384) and attention (4 N^2 C), N
    tokens with the cls token, and the DPT head's convolutions (64
    features; projections to 48, 96, 192, 384) at their resolutions."""
    width_c, blocks, features, out_channels = 384, 12, 64, (48, 96, 192, 384)
    gh, gw = height // 14, width // 14
    n, c = gh * gw + 1, width_c
    enc = 2.0 * 3 * 14 * 14 * c * gh * gw + blocks * (24.0 * n * c * c + 4.0 * n * n * c)
    c0, c1, c2, c3 = out_channels
    sizes = [(gh * 4, gw * 4), (gh * 2, gw * 2), (gh, gw), ((gh + 1) // 2, (gw + 1) // 2)]
    px = [a * b for a, b in sizes]
    head = 2.0 * c * sum(out_channels) * gh * gw  # the 1x1 projections
    head += 2.0 * (c0 * c0 * 16 + c1 * c1 * 4) * gh * gw + 2.0 * c3 * c3 * 9 * px[3]
    head += sum(2.0 * 9 * ci * features * p for ci, p in zip(out_channels, px))  # layerN_rn
    rcu = 2 * 2.0 * 9 * features * features  # two 3x3 convs a pixel
    head += rcu * px[3] + 2.0 * features * features * px[2]  # refinenet4
    head += 2 * rcu * px[2] + 2.0 * features * features * px[1]  # refinenet3
    head += 2 * rcu * px[1] + 2.0 * features * features * px[0]  # refinenet2
    head += 2 * rcu * px[0] + 2.0 * features * features * 4 * px[0]  # refinenet1
    head += 2.0 * 9 * features * (features // 2) * 4 * px[0]  # output_conv1
    head += (2.0 * 9 * (features // 2) * 32 + 2.0 * 32) * height * width  # output_conv2
    return float(enc + head)


def describe() -> str:
    return (
        "FLOPs=2*MACs; frontend = SuperPoint conv stack at layer "
        "resolutions; tracking = KF KNN matmul + local-map descriptor/"
        "pixel matmuls (rare branches excluded, counts reported); a "
        "training step = 3x forward per view"
    )
