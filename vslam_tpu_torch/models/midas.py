"""MiDaS v2.1-small monocular relative-depth network as an `nn.Module`.

Port of `vslam_tpu/models/midas.py`. The reference runs
`midas_v21_small_256.onnx` (`src/DepthEstimator.cpp:15-112`): resize to
256x256, ImageNet-normalize, run, resize back, min-max normalize to
[0, 1] relative inverse depth.

Architecture (the public checkpoint's `MidasNet_small(features=64,
expand=True)` over timm `tf_efficientnet_lite3`): an EfficientNet-Lite3
encoder (width 1.2 / depth 1.4, no squeeze-excite, ReLU6, fixed 32-channel
stem) tapped at strides 4/8/16/32 with channels (32, 48, 136, 384);
scratch 3x3 convs to (64, 128, 256, 512); residual feature-fusion blocks
whose 1x1 out_convs halve channels level to level (refinenet1 keeps 64);
head 64->32 -> 2x -> 32 -> 1. Output stride exactly 1.

The parameters carry the checkpoint's own state-dict names
(`pretrained.layer1.0.weight`, `scratch.refinenet4.out_conv.bias`, ...;
`PARAM_SHAPES`), so a `.pth` loads as it is (`models.weights`). What the
Flax module and timm agree on, and the tests pin:
- TF-SAME padding: a stride-2 conv pads its extra row and column at the
  bottom and right;
- BatchNorm in inference mode with epsilon 1e-3 (timm's TF default);
- ReLU6 after the stem, the expansion and the depthwise conv, none after
  the projection; the residual only where stride is 1 and channels match;
- the decoder's 2x upsampling is bilinear with align_corners=True.
The encoder computes in `compute_dtype` (bf16 by default, as the Flax
module), the decoder and head in f32. The convolutions go to
`torch.nn.functional.conv2d` (cuDNN on the card), as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from vslam_tpu_torch.ops.linalg import f32_matmuls
from vslam_tpu_torch.ops.resize import resize_bilinear

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-3


def _round_filters(filters, multiplier=1.2, divisor=8):
    f = filters * multiplier
    new = max(divisor, int(f + divisor / 2) // divisor * divisor)
    if new < 0.9 * f:
        new += divisor
    return int(new)


def _round_repeats(repeats, multiplier=1.4):
    return int(math.ceil(multiplier * repeats))


# EfficientNet-B0 block args: (expand, kernel, stride, out_ch, repeats)
_B0_BLOCKS = [
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
]
# timm stage Sequentials holding each B0 stage in the checkpoint.
STAGE_PREFIX = {
    0: "pretrained.layer1.3", 1: "pretrained.layer1.4", 2: "pretrained.layer2.0",
    3: "pretrained.layer3.0", 4: "pretrained.layer3.1", 5: "pretrained.layer4.0",
    6: "pretrained.layer4.1",
}


def encoder_blocks():
    """[(stage, block, prefix, expand, kernel, stride, ch_in, ch_out)] of
    the Lite3 encoder, in order (first and last stage depths unscaled)."""
    out, ch = [], 32
    for si, (e, k, s, c, r) in enumerate(_B0_BLOCKS):
        cout = _round_filters(c)
        reps = r if si in (0, len(_B0_BLOCKS) - 1) else _round_repeats(r)
        for bi in range(reps):
            out.append((si, bi, f"{STAGE_PREFIX[si]}.{bi}", e, k, s if bi == 0 else 1, ch, cout))
            ch = cout
    return out


def _param_shapes(features=64):
    shapes = {}

    def bn(prefix, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{prefix}.{leaf}"] = (c,)

    def conv(key, cout, cin, k, bias=False):
        shapes[key + ".weight"] = (cout, cin, k, k)
        if bias:
            shapes[key + ".bias"] = (cout,)

    conv("pretrained.layer1.0", 32, 3, 3)
    bn("pretrained.layer1.1", 32)
    taps = {}
    stride = 2
    for si, bi, tp, e, k, st, cin, cout in encoder_blocks():
        if st == 2 and stride in (4, 8, 16):
            taps[stride] = cin
        mid = cin * e
        if e == 1:
            shapes[tp + ".conv_dw.weight"] = (mid, 1, k, k)
            bn(tp + ".bn1", mid)
            conv(tp + ".conv_pw", cout, mid, 1)
            bn(tp + ".bn2", cout)
        else:
            conv(tp + ".conv_pw", mid, cin, 1)
            bn(tp + ".bn1", mid)
            shapes[tp + ".conv_dw.weight"] = (mid, 1, k, k)
            bn(tp + ".bn2", mid)
            conv(tp + ".conv_pwl", cout, mid, 1)
            bn(tp + ".bn3", cout)
        stride *= st
    taps[32] = cout
    chs = [features, features * 2, features * 4, features * 8]
    for i, s in enumerate((4, 8, 16, 32)):
        conv(f"scratch.layer{i + 1}_rn", chs[i], taps[s], 3)
    for i in range(1, 5):
        ch, out = chs[i - 1], chs[i - 1] if i == 1 else chs[i - 1] // 2
        tp = f"scratch.refinenet{i}"
        units = ("resConfUnit2",) if i == 4 else ("resConfUnit1", "resConfUnit2")
        for u in units:
            conv(f"{tp}.{u}.conv1", ch, ch, 3, bias=True)
            conv(f"{tp}.{u}.conv2", ch, ch, 3, bias=True)
        conv(f"{tp}.out_conv", out, ch, 1, bias=True)
    conv("scratch.output_conv.0", features // 2, features, 3, bias=True)
    conv("scratch.output_conv.2", 32, features // 2, 3, bias=True)
    conv("scratch.output_conv.4", 1, 32, 1, bias=True)
    return shapes


PARAM_SHAPES = _param_shapes()


def _same_pad(x, k, s):
    """TF/XLA SAME padding of NCHW for a k x k conv at stride s."""
    H, W = x.shape[-2:]

    def tot(n):
        return max((-(-n // s) - 1) * s + k - n, 0)

    th, tw = tot(H), tot(W)
    return F.pad(x, (tw // 2, tw - tw // 2, th // 2, th - th // 2))


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


class MidasSmall(nn.Module):
    """MiDaS v2.1-small: image (B, H, W, 3) in [0, 1], H and W multiples
    of 32 -> (B, H, W) relative inverse depth (unnormalized)."""

    def __init__(self, state_dict, compute_dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        missing = sorted(set(PARAM_SHAPES) - set(state_dict))
        if missing:
            raise KeyError(f"MiDaS state dict lacks {missing[:4]} ...")
        self.compute_dtype = compute_dtype
        for key in PARAM_SHAPES:
            v = torch.as_tensor(state_dict[key], dtype=torch.float32)
            if tuple(v.shape) != PARAM_SHAPES[key]:
                raise ValueError(f"{key}: shape {tuple(v.shape)}, want {PARAM_SHAPES[key]}")
            self.register_buffer(key.replace(".", "__"), v.to(device))

    def p(self, key):
        return getattr(self, key.replace(".", "__"))

    def _conv(self, x, key, stride=1, groups=1, bias=False):
        w = self.p(key + ".weight").to(x.dtype)
        x = _same_pad(x, w.shape[-1], stride)
        b = self.p(key + ".bias").to(x.dtype) if bias else None
        return F.conv2d(x, w, b, stride=stride, groups=groups)

    def _bn(self, x, prefix):
        dt = x.dtype
        return F.batch_norm(x, self.p(prefix + ".running_mean").to(dt),
                            self.p(prefix + ".running_var").to(dt),
                            self.p(prefix + ".weight").to(dt), self.p(prefix + ".bias").to(dt),
                            eps=BN_EPS)

    def _encoder(self, x):
        x = _relu6(self._bn(self._conv(x, "pretrained.layer1.0", stride=2), "pretrained.layer1.1"))
        taps = {}
        stride = 2
        for si, bi, tp, e, k, st, cin, cout in encoder_blocks():
            if st == 2 and stride in (4, 8, 16):
                taps[stride] = x
            inp = x
            if e == 1:
                x = _relu6(self._bn(self._conv(x, tp + ".conv_dw", st, groups=x.shape[1]),
                                    tp + ".bn1"))
                x = self._bn(self._conv(x, tp + ".conv_pw"), tp + ".bn2")
            else:
                x = _relu6(self._bn(self._conv(x, tp + ".conv_pw"), tp + ".bn1"))
                x = _relu6(self._bn(self._conv(x, tp + ".conv_dw", st, groups=x.shape[1]),
                                    tp + ".bn2"))
                x = self._bn(self._conv(x, tp + ".conv_pwl"), tp + ".bn3")
            if st == 1 and cin == cout:
                x = x + inp
            stride *= st
        taps[32] = x
        return [taps[s].float() for s in (4, 8, 16, 32)]

    def _rcu(self, x, tp):
        r = self._conv(F.relu(x), tp + ".conv1", bias=True)
        return x + self._conv(F.relu(r), tp + ".conv2", bias=True)

    def _fuse(self, x, tp, skip=None):
        if skip is not None:
            x = x + self._rcu(skip, tp + ".resConfUnit1")
        x = self._rcu(x, tp + ".resConfUnit2")
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        return self._conv(x, tp + ".out_conv", bias=True)

    def forward(self, image):
        B, H, W, _ = image.shape
        if H % 32 or W % 32:
            raise ValueError(f"MiDaS input must be a multiple of 32, got {H}x{W}")
        mean = torch.tensor(IMAGENET_MEAN, dtype=image.dtype, device=image.device)
        std = torch.tensor(IMAGENET_STD, dtype=image.dtype, device=image.device)
        x = ((image - mean) / std).permute(0, 3, 1, 2).to(self.compute_dtype)
        l1, l2, l3, l4 = self._encoder(x)
        with f32_matmuls():
            r = [self._conv(l, f"scratch.layer{i + 1}_rn") for i, l in enumerate((l1, l2, l3, l4))]
            p4 = self._fuse(r[3], "scratch.refinenet4")
            p3 = self._fuse(p4, "scratch.refinenet3", r[2])
            p2 = self._fuse(p3, "scratch.refinenet2", r[1])
            p1 = self._fuse(p2, "scratch.refinenet1", r[0])
            h = self._conv(p1, "scratch.output_conv.0", bias=True)
            h = F.interpolate(h, scale_factor=2, mode="bilinear", align_corners=True)
            h = F.relu(self._conv(h, "scratch.output_conv.2", bias=True))
            h = F.relu(self._conv(h, "scratch.output_conv.4", bias=True))
        return h[:, 0]


def random_state_dict(seed: int = 7) -> dict:
    """Deterministic random-init parameters (no checkpoint): He-normal
    convolutions, zero biases, identity BatchNorm statistics."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for key, shape in PARAM_SHAPES.items():
        leaf = key.rsplit(".", 1)[1]
        if leaf == "weight" and len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            sd[key] = torch.randn(shape, generator=g) * math.sqrt(2.0 / fan_in)
        elif leaf in ("weight", "running_var"):
            sd[key] = torch.ones(shape)
        else:
            sd[key] = torch.zeros(shape)
    return sd


def estimate_depth(model: MidasSmall, image, size=256):
    """Reference-parity wrapper (`DepthEstimator.cpp:35-112`): image
    (B, H, W, 3) in [0, 1] -> resize to size x size (`ops.resize`, as
    `jax.image.resize`), run, resize back, min-max normalize each image
    to [0, 1]."""
    B, H, W, _ = image.shape
    x = resize_bilinear(image, (size, size), dims=(1, 2))
    with torch.no_grad():
        inv = model(x)
    inv = resize_bilinear(inv, (H, W), dims=(1, 2))
    lo = torch.amin(inv, dim=(1, 2), keepdim=True)
    hi = torch.amax(inv, dim=(1, 2), keepdim=True)
    return (inv - lo) / torch.clamp(hi - lo, min=1e-6)
