"""Small monocular depth network trained on the synthetic RGB-D worlds.

Port of `vslam_tpu/models/depthnet.py`: a U-shaped encoder-decoder that
takes gray at half camera resolution and predicts log metric depth at a
quarter of its input, 1/8 of the camera's resolution. Four stride-2
stages (24, 48, 96, 128 channels), a 128-channel middle conv and two
upsample stages that concatenate the encoder's skip ([upsampled, skip],
224 and 144 input channels), then an f32 head.

The public call keeps the JAX package's NHWC layout: gray (B, H, W, 1)
in [0, 1], H and W multiples of 16 -> log depth (B, H/4, W/4) f32.

Numerics, as the Flax module computes them:
- the seven bf16 layers round the convolution output to bf16 and then
  add the bf16 bias (as the port's SuperPoint does);
- Flax's SAME padding of a 3x3 stride-2 conv on an even input pads
  (0, 1) per spatial axis, not (1, 1); the pads are computed as XLA does;
- the head runs in f32 with TF32 off (`ops.linalg.f32_matmuls`), as the
  JAX package computes it in full f32.
The convolutions go to `torch.nn.functional.conv2d` (cuDNN on the card),
as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vslam_tpu_torch.models.superpoint import init_state_dict
from vslam_tpu_torch.ops.camera import bilinear_sample_batched, unit_gray
from vslam_tpu_torch.ops.linalg import f32_matmuls

# Full-camera-resolution pixels per predicted-depth cell: the net eats
# gray downsampled 2x and predicts at 1/4 of its input.
DOWNSAMPLE = 2
OUT_STRIDE = DOWNSAMPLE * 4  # 8 full-res pixels per output cell

# (name, in channels, out channels, stride)
LAYERS = (
    ("down1", 1, 24, 2), ("down2", 24, 48, 2), ("down3", 48, 96, 2),
    ("down4", 96, 128, 2), ("mid", 128, 128, 1),
    ("up3", 128 + 96, 96, 1), ("up2", 96 + 48, 64, 1), ("head", 64, 1, 1),
)


def _same_pads(size: int, stride: int, k: int = 3):
    """XLA's SAME padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _up2(x):
    """2x nearest-neighbour upsample of NCHW."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class DepthNet(nn.Module):
    """Gray (B, H, W, 1) in [0, 1] -> log metric depth (B, H/4, W/4)."""

    def __init__(self, compute_dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.compute_dtype = compute_dtype
        for name, cin, cout, stride in LAYERS:
            setattr(self, name, nn.Conv2d(cin, cout, 3, stride=stride, device=device))

    def _conv(self, x, name, dtype):
        conv = getattr(self, name)
        s = conv.stride[0]
        ph, pw = _same_pads(x.shape[2], s), _same_pads(x.shape[3], s)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        y = F.conv2d(x, conv.weight.to(dtype), None, stride=s)
        return y + conv.bias.to(dtype)[None, :, None, None]

    def forward(self, image):
        B, H, W, _ = image.shape
        if H % 16 or W % 16:
            raise ValueError(f"DepthNet input must be a multiple of 16, got {H}x{W}")
        dt = self.compute_dtype
        x = image.permute(0, 3, 1, 2).to(dt)
        c1 = F.relu(self._conv(x, "down1", dt))
        c2 = F.relu(self._conv(c1, "down2", dt))
        c3 = F.relu(self._conv(c2, "down3", dt))
        c4 = F.relu(self._conv(c3, "down4", dt))
        c4 = F.relu(self._conv(c4, "mid", dt))
        u3 = F.relu(self._conv(torch.cat([_up2(c4), c3], dim=1), "up3", dt))
        u2 = F.relu(self._conv(torch.cat([_up2(u3), c2], dim=1), "up2", dt))
        with f32_matmuls():
            out = self._conv(u2.float(), "head", torch.float32)
        return out[:, 0]

    def keypoint_depth(self, gray_u8, kp_xy):
        """Metric depth (C, K) at the full-resolution keypoints kp_xy of
        frames gray_u8 (C, H, W) uint8 (`keypoint_depth`)."""
        return keypoint_depth(self, gray_u8, kp_xy)


def predict_log_depth(model: DepthNet, gray_u8):
    """(C, H, W) uint8 full-resolution gray -> (C, ceil(H/8), ceil(W/8))
    log depth: a 2x2 mean in f32 (summed in XLA's order, row by row), edge
    padding to the net's multiple of 16 (cropped back after), then the
    net."""
    C, H, W = gray_u8.shape
    Hh, Wh = H // 2, W // 2
    g = unit_gray(gray_u8[:, : Hh * 2, : Wh * 2])
    g = g.reshape(C, Hh, 2, Wh, 2)
    g = (((g[:, :, 0, :, 0] + g[:, :, 0, :, 1]) + g[:, :, 1, :, 0]) + g[:, :, 1, :, 1]) / 4.0
    Hp, Wp = -(-Hh // 16) * 16, -(-Wh // 16) * 16
    g = g[:, None]
    if (Hp, Wp) != (Hh, Wh):
        g = F.pad(g, (0, Wp - Wh, 0, Hp - Hh), mode="replicate")
    with torch.no_grad():
        out = model(g.permute(0, 2, 3, 1))
    return out[:, : -(-Hh // 4), : -(-Wh // 4)]


def sample_log_depth_at_keypoints(log_depth, kp_xy):
    """Metric depth (C, K) at full-resolution keypoint pixels kp_xy
    (C, K, 2): bilinear samples of the log-depth maps (C, Hs, Ws), whose
    cell centres sit at full-res pixel (i + 0.5) * OUT_STRIDE - 0.5,
    exponentiated."""
    uv = (kp_xy + 0.5) / OUT_STRIDE - 0.5
    return torch.exp(bilinear_sample_batched(log_depth, uv))


def keypoint_depth(model, gray_u8, kp_xy):
    """`predict_log_depth`, then `sample_log_depth_at_keypoints`: metric
    depth (C, K) at the full-resolution keypoints kp_xy (C, K, 2)."""
    return sample_log_depth_at_keypoints(predict_log_depth(model, gray_u8), kp_xy)


def init_params(generator=None, seed: int = 11) -> dict:
    """Deterministic random DepthNet parameters (the trainer's starting
    point; no pipeline uses a random DepthNet): `lecun_normal` kernels and
    zero biases as Flax initialises them, from `generator` or a generator
    seeded with `seed`. A state dict for `DepthNet.load_state_dict`."""
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    return init_state_dict([(name, cin, cout, 3) for name, cin, cout, _ in LAYERS], generator)
