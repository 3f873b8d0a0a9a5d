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

The blocks are `nn.Module`s under the JAX names (`MBConvLite`,
`EfficientNetLite3`, `ResidualConvUnit`, `FeatureFusionBlock`), laid out
as the checkpoint's hierarchy (`pretrained` is the timm encoder,
`scratch` the decoder), so the parameters carry the checkpoint's own
state-dict names (`pretrained.layer1.0.weight`,
`scratch.refinenet4.out_conv.bias`, ...; `PARAM_SHAPES`) and a `.pth`
loads as it is (`models.weights`). What the
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

from vslam_tpu_torch.models.superpoint import lecun_normal_
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


class _Conv(nn.Module):
    """A k x k convolution of NCHW with TF-SAME padding, computed in the
    input's dtype (the weights are cast to it)."""

    def __init__(self, cin, cout, k, stride=1, groups=1, bias=False):
        super().__init__()
        self.stride, self.groups = stride, groups
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        x = _same_pad(x, w.shape[-1], self.stride)
        return F.conv2d(x, w, b, stride=self.stride, groups=self.groups)


class _BatchNorm(nn.Module):
    """Inference-mode BatchNorm (epsilon `BN_EPS`) in the input's dtype,
    without the training counter that `nn.BatchNorm2d` keeps."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        dt = x.dtype
        return F.batch_norm(x, self.running_mean.to(dt), self.running_var.to(dt),
                            self.weight.to(dt), self.bias.to(dt), eps=BN_EPS)


class MBConvLite(nn.Module):
    """Mobile inverted bottleneck, lite flavour (no squeeze-excite, ReLU6)
    on NCHW, in the input's dtype. Named as timm names it: with expand 1
    a `DepthwiseSeparableConv` (conv_dw, bn1, conv_pw, bn2), else an
    `InvertedResidual` (conv_pw, bn1, conv_dw, bn2, conv_pwl, bn3). ReLU6
    after the expansion and the depthwise conv, none after the
    projection; the residual where stride is 1 and channels match."""

    def __init__(self, cin, cout, expand, kernel, stride):
        super().__init__()
        mid = cin * expand
        self.expand, self.residual = expand, stride == 1 and cin == cout
        if expand == 1:
            self.conv_dw = _Conv(mid, mid, kernel, stride, groups=mid)
            self.bn1 = _BatchNorm(mid)
            self.conv_pw = _Conv(mid, cout, 1)
            self.bn2 = _BatchNorm(cout)
        else:
            self.conv_pw = _Conv(cin, mid, 1)
            self.bn1 = _BatchNorm(mid)
            self.conv_dw = _Conv(mid, mid, kernel, stride, groups=mid)
            self.bn2 = _BatchNorm(mid)
            self.conv_pwl = _Conv(mid, cout, 1)
            self.bn3 = _BatchNorm(cout)

    def forward(self, x):
        inp = x
        if self.expand == 1:
            x = _relu6(self.bn1(self.conv_dw(x)))
            x = self.bn2(self.conv_pw(x))
        else:
            x = _relu6(self.bn1(self.conv_pw(x)))
            x = _relu6(self.bn2(self.conv_dw(x)))
            x = self.bn3(self.conv_pwl(x))
        return x + inp if self.residual else x


class EfficientNetLite3(nn.Module):
    """The Lite3 encoder: (B, 3, H, W) -> its stride-4/8/16/32 feature
    maps (32, 48, 136, 384 channels) in f32, computed in `compute_dtype`.
    Laid out as timm's stage Sequentials inside the checkpoint
    (`layer1` = [conv_stem, bn1, act1, blocks0, blocks1], `layer2` =
    [blocks2], `layer3` = [blocks3, blocks4], `layer4` = [blocks5,
    blocks6]), so its parameters carry the checkpoint's names."""

    def __init__(self, compute_dtype=torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        stages = [nn.ModuleList() for _ in _B0_BLOCKS]
        for si, bi, tp, e, k, st, cin, cout in encoder_blocks():
            stages[si].append(MBConvLite(cin, cout, e, k, st))
        self.layer1 = nn.ModuleList([_Conv(3, 32, 3, stride=2), _BatchNorm(32), nn.Identity(),
                                     stages[0], stages[1]])
        self.layer2 = nn.ModuleList([stages[2]])
        self.layer3 = nn.ModuleList([stages[3], stages[4]])
        self.layer4 = nn.ModuleList([stages[5], stages[6]])

    def forward(self, x):
        x = x.to(self.compute_dtype)
        x = _relu6(self.layer1[1](self.layer1[0](x)))
        blocks = [b for stage in (*self.layer1[3:], *self.layer2, *self.layer3, *self.layer4)
                  for b in stage]
        taps, stride = {}, 2
        for (si, bi, tp, e, k, st, cin, cout), block in zip(encoder_blocks(), blocks):
            if st == 2 and stride in (4, 8, 16):
                taps[stride] = x
            x = block(x)
            stride *= st
        taps[32] = x
        return [taps[s].float() for s in (4, 8, 16, 32)]


def _upsample2(x):
    """2x bilinear upsampling of NCHW with align_corners=True, the
    `Interpolate` of the MiDaS decoder."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class ResidualConvUnit(nn.Module):
    """`ResidualConvUnit_custom` (MiDaS blocks.py): relu-conv-relu-conv
    plus the input."""

    def __init__(self, ch):
        super().__init__()
        self.conv1 = _Conv(ch, ch, 3, bias=True)
        self.conv2 = _Conv(ch, ch, 3, bias=True)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """`FeatureFusionBlock_custom`: x + rcu1(skip) -> rcu2 -> 2x upsample
    -> 1x1 out_conv (to `out_ch`: half the channels with expand=True).
    Without `skip` (the top level) there is no rcu1."""

    def __init__(self, ch, out_ch, skip=True):
        super().__init__()
        if skip:
            self.resConfUnit1 = ResidualConvUnit(ch)
        self.resConfUnit2 = ResidualConvUnit(ch)
        self.out_conv = _Conv(ch, out_ch, 1, bias=True)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        return self.out_conv(_upsample2(self.resConfUnit2(x)))


class _Scratch(nn.Module):
    """The checkpoint's `scratch`: the 3x3 level convs, the four fusion
    blocks and the head (`output_conv` indices 1 and 3 are its upsample
    and ReLU, which hold no weights)."""

    def __init__(self, taps, features):
        super().__init__()
        chs = [features, features * 2, features * 4, features * 8]
        for i in range(4):
            setattr(self, f"layer{i + 1}_rn", _Conv(taps[i], chs[i], 3))
        for i in range(4):
            out = chs[i] if i == 0 else chs[i] // 2  # refinenet1 keeps its channels
            setattr(self, f"refinenet{i + 1}", FeatureFusionBlock(chs[i], out, skip=i < 3))
        self.output_conv = nn.ModuleList([
            _Conv(features, features // 2, 3, bias=True), nn.Identity(),
            _Conv(features // 2, 32, 3, bias=True), nn.Identity(),
            _Conv(32, 1, 1, bias=True)])


class MidasSmall(nn.Module):
    """MiDaS v2.1-small: image (B, H, W, 3) in [0, 1], H and W multiples
    of 32 -> (B, H, W) relative inverse depth (unnormalized). Built from
    `state_dict` (the checkpoint's names, `PARAM_SHAPES`; other keys are
    ignored) on `device`; the encoder computes in `compute_dtype`, the
    decoder and head in f32 without TF32."""

    def __init__(self, state_dict, compute_dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        missing = sorted(set(PARAM_SHAPES) - set(state_dict))
        if missing:
            raise KeyError(f"MiDaS state dict lacks {missing[:4]} ...")
        sd = {}
        for key, shape in PARAM_SHAPES.items():
            sd[key] = torch.as_tensor(state_dict[key], dtype=torch.float32)
            if tuple(sd[key].shape) != shape:
                raise ValueError(f"{key}: shape {tuple(sd[key].shape)}, want {shape}")
        self.pretrained = EfficientNetLite3(compute_dtype)
        self.scratch = _Scratch((32, 48, 136, 384), features=64)
        self.load_state_dict(sd)
        self.requires_grad_(False)
        self.to(device)

    @property
    def compute_dtype(self):
        return self.pretrained.compute_dtype

    def p(self, key):
        """The parameter or statistic stored under checkpoint key `key`."""
        return self.state_dict()[key]

    def forward(self, image):
        B, H, W, _ = image.shape
        if H % 32 or W % 32:
            raise ValueError(f"MiDaS input must be a multiple of 32, got {H}x{W}")
        mean = torch.tensor(IMAGENET_MEAN, dtype=image.dtype, device=image.device)
        std = torch.tensor(IMAGENET_STD, dtype=image.dtype, device=image.device)
        levels = self.pretrained(((image - mean) / std).permute(0, 3, 1, 2))
        sc = self.scratch
        with f32_matmuls():
            r1, r2, r3, r4 = (getattr(sc, f"layer{i + 1}_rn")(l) for i, l in enumerate(levels))
            p = sc.refinenet4(r4)
            p = sc.refinenet3(p, r3)
            p = sc.refinenet2(p, r2)
            p = sc.refinenet1(p, r1)
            h = _upsample2(sc.output_conv[0](p))
            h = F.relu(sc.output_conv[2](h))
            h = F.relu(sc.output_conv[4](h))
        return h[:, 0]


def init_params(generator=None, seed: int = 7, size: int = 256) -> dict:
    """Deterministic random MiDaS parameters (the stand-in when no
    checkpoint exists), drawn as Flax's `init` draws them: `lecun_normal`
    kernels (a normal truncated at two standard deviations, variance 1 /
    fan_in; a depthwise kernel's fan_in is k * k, Flax reading it from
    the HWIO shape (k, k, 1, C)), zero conv biases, BatchNorm scale 1,
    bias 0, mean 0, variance 1. From `generator` or a `torch.Generator`
    seeded with `seed`; Flax's bits differ, the layer statistics match
    (`tests/test_torch_weights.py`). `size`, the side of the square input
    Flax's init traces, shapes no parameter; it must be a multiple of 32."""
    if size % 32:
        raise ValueError(f"MiDaS input must be a multiple of 32, got {size}")
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    sd = {}
    for key, shape in PARAM_SHAPES.items():
        leaf = key.rsplit(".", 1)[1]
        if leaf == "weight" and len(shape) == 4:
            sd[key] = lecun_normal_(torch.empty(shape), generator)
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
