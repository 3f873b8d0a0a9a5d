"""SuperPoint keypoint detector + descriptor network as an `nn.Module`.

Port of `vslam_tpu/models/superpoint.py`: the public SuperPoint-v1 VGG
backbone (64, 64, 64, 64, 128, 128, 128, 128 with 2x2 max-pools after
layers 2, 4, 6), detector head 256 -> 65 and descriptor head 256 -> 256.
Internally NCHW; the public call keeps the JAX package's NHWC layout:
image (B, H, W, 1) in [0, 1] -> semi (B, H/8, W/8, 65) logits and
desc_coarse (B, H/8, W/8, 256), both f32.

Compute runs in `compute_dtype` (bf16 by default, as the Flax module).
Each convolution adds its bias after the convolution output is rounded
to the compute dtype, as Flax does. The convolutions go to
`torch.nn.functional.conv2d` (cuDNN on the card), as the JAX package
leaves them to XLA. The forward carries gradients (the trainer,
`models.train_superpoint`, calls it directly); the frontend wraps its
inference in `torch.no_grad`.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

CELL = 8

LAYERS = (
    ("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3),
    ("conv2a", 64, 64, 3), ("conv2b", 64, 64, 3),
    ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3),
    ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3),
    ("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
    ("convDa", 128, 256, 3), ("convDb", 256, 256, 1),
)


class SuperPoint(nn.Module):
    """VGG backbone + detector/descriptor heads."""

    def __init__(self, compute_dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.compute_dtype = compute_dtype
        for name, cin, cout, k in LAYERS:
            conv = nn.Conv2d(cin, cout, k, padding=k // 2, device=device)
            setattr(self, name, conv)

    def _conv(self, x, name):
        conv = getattr(self, name)
        dt = self.compute_dtype
        y = F.conv2d(x, conv.weight.to(dt), None, padding=conv.padding)
        return y + conv.bias.to(dt)[None, :, None, None]

    def forward(self, image):
        """image (B, H, W, 1) float in [0, 1], H and W multiples of 8."""
        x = image.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = F.relu(self._conv(x, "conv1a"))
        x = F.relu(self._conv(x, "conv1b"))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(self._conv(x, "conv2a"))
        x = F.relu(self._conv(x, "conv2b"))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(self._conv(x, "conv3a"))
        x = F.relu(self._conv(x, "conv3b"))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(self._conv(x, "conv4a"))
        x = F.relu(self._conv(x, "conv4b"))
        semi = self._conv(F.relu(self._conv(x, "convPa")), "convPb")
        desc = self._conv(F.relu(self._conv(x, "convDa")), "convDb")
        return (semi.permute(0, 2, 3, 1).float().contiguous(),
                desc.permute(0, 2, 3, 1).float().contiguous())


def lecun_normal_(weight, generator):
    """Flax's default kernel init, `lecun_normal`, on an OIHW weight:
    a normal truncated at two standard deviations, scaled so that its
    variance is 1 / fan_in (fan_in = I * H * W)."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    # 0.8796...: the std of a standard normal truncated to [-2, 2].
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return weight


def init_state_dict(shapes, generator) -> dict:
    """Random parameters for conv layers `shapes` ((name, cin, cout, k)
    rows): `lecun_normal` kernels and zero biases, f32 on the CPU, drawn
    from `generator` (a seeded `torch.Generator`) in row order."""
    sd = {}
    for name, cin, cout, k in shapes:
        sd[f"{name}.weight"] = lecun_normal_(torch.empty(cout, cin, k, k), generator)
        sd[f"{name}.bias"] = torch.zeros(cout)
    return sd


def init_params(generator=None, seed: int = 0) -> dict:
    """Deterministic random SuperPoint parameters (the stand-in when no
    checkpoint exists; the trainer's starting point): a state dict for
    `SuperPoint.load_state_dict`, from `generator` or a generator seeded
    with `seed`. Flax's init draws other bits; the layer statistics match
    (`tests/test_torch_train_superpoint.py`)."""
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    return init_state_dict(LAYERS, generator)


def pad_to_multiple(image, multiple=CELL):
    """Pad H, W of (..., H, W, C) up to a multiple of 8 with zeros (the
    reference pads the same way, `FeatureExtractor.cpp:90-105`). Returns
    (padded, (H, W) original)."""
    H, W = image.shape[-3], image.shape[-2]
    Hp = (H + multiple - 1) // multiple * multiple
    Wp = (W + multiple - 1) // multiple * multiple
    return F.pad(image, (0, 0, 0, Wp - W, 0, Hp - H)), (H, W)
