"""Depth Anything V2 Small, metric (Yang et al., arXiv:2406.09414): a
DINOv2 ViT-S/14 encoder and a DPT head, the monocular depth network of a
configuration that fills keypoint depth from a foundation ViT.

Written from the published `metric_depth/depth_anything_v2/dpt.py` and
`dinov2.py` (model config `vits`, `max_depth` 20, the Hypersim indoor
model), at the published widths:
- encoder: 14x14 patches to width 384, a cls token and a learned 37x37
  position embedding (interpolated bicubically to the input's grid with
  the published 0.1 offset), 12 pre-norm blocks (6 heads of 64, qkv
  bias, MLP 1536 with exact GELU, LayerNorm eps 1e-6, LayerScale on
  both residual branches) and a final LayerNorm;
- DPT head: the patch tokens of blocks 2, 5, 8 and 11, each after the
  final norm, projected 1x1 to 48, 96, 192, 384 channels and resized by
  a 4x4/4 and a 2x2/2 transposed conv, identity and a 3x3/2 conv; 3x3
  `layerN_rn` convs to 64 features; four fusion blocks (two residual
  conv units, a bilinear resize with align_corners=True, a 1x1
  out_conv); `output_conv1` 64 -> 32, a bilinear resize to the patch
  grid x 14, `output_conv2` (3x3 32 -> 32, ReLU, 1x1 32 -> 1, Sigmoid),
  times `max_depth`.
The parameters carry the published checkpoint's names (`PARAM_SHAPES`),
so a public `depth_anything_v2_metric_hypersim_vits.pth` state dict loads
as it is (`models.weights.load_depth_anything`).

Input: gray replicated to three channels, the published transform's
keep-aspect, lower-bound resize to a multiple of 14 (`input_shape`:
480x640 -> 518x686, 37x49 patches, 1,814 tokens with the cls token),
torch's bicubic (as two f32 matrix products) in place of
`cv2.INTER_CUBIC`, and ImageNet's mean and std.

Numerics: the encoder computes its matmuls in `compute_dtype` (bf16 by
default) on an f32 residual stream (LayerScale and the residual add
in one f32 `addcmul`), with LayerNorm in f32 and attention
through `torch.nn.functional.scaled_dot_product_attention` (softmax
accumulated in f32); the head's convolutions run in `compute_dtype`, its
last 1x1 conv (TF32 off), the Sigmoid and the scale to metres in f32.

Keypoint depth (`keypoint_depth`) is what the published `infer_image`
gives at a keypoint's pixel: the map resized back to the camera's size
(bilinear, align_corners=True), read at the pixel `sample_depth_at_
keypoints` rounds the keypoint to, computed at the keypoints alone
without building the full-resolution map. No host read, no sync.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vslam_tpu_torch.ops.camera import unit_gray
from vslam_tpu_torch.ops.linalg import f32_matmuls
from vslam_tpu_torch.utils import profiling

PATCH = 14
WIDTH = 384
DEPTH = 12
HEADS = 6
MLP = 4 * WIDTH
LN_EPS = 1e-6
TAPS = (2, 5, 8, 11)
FEATURES = 64
OUT_CHANNELS = (48, 96, 192, 384)
HEAD_FEATURES = 32
POS_GRID = 37  # the 518x518 pretraining grid
INPUT_SIZE = 518
INTERPOLATE_OFFSET = 0.1
MAX_DEPTH = 20.0
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def input_shape(height: int, width: int, size: int = INPUT_SIZE, multiple: int = PATCH):
    """The published `Resize(size, size, keep_aspect_ratio=True,
    ensure_multiple_of=14, resize_method="lower_bound")`: the smallest
    aspect-kept scale at which both sides reach `size`, each side then
    rounded to a multiple of 14 (up where rounding falls below `size`)."""
    scale = max(size / height, size / width)

    def fit(x):
        y = int(np.round(x / multiple) * multiple)
        return y if y >= size else int(math.ceil(x / multiple) * multiple)

    return fit(scale * height), fit(scale * width)


class LayerScale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class Attention(nn.Module):
    def __init__(self):
        super().__init__()
        self.qkv = nn.Linear(WIDTH, 3 * WIDTH)
        self.proj = nn.Linear(WIDTH, WIDTH)


class Mlp(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(WIDTH, MLP)
        self.fc2 = nn.Linear(MLP, WIDTH)


class Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.norm1 = nn.LayerNorm(WIDTH, eps=LN_EPS)
        self.attn = Attention()
        self.ls1 = LayerScale(WIDTH)
        self.norm2 = nn.LayerNorm(WIDTH, eps=LN_EPS)
        self.mlp = Mlp()
        self.ls2 = LayerScale(WIDTH)


class PatchEmbed(nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = nn.Conv2d(3, WIDTH, PATCH, stride=PATCH)


class DinoVisionTransformer(nn.Module):
    """The parameters of DINOv2 ViT-S/14 under the published names
    (`mask_token` is the checkpoint's, unused at inference)."""

    def __init__(self):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, WIDTH))
        self.pos_embed = nn.Parameter(torch.zeros(1, POS_GRID * POS_GRID + 1, WIDTH))
        self.mask_token = nn.Parameter(torch.zeros(1, WIDTH))
        self.patch_embed = PatchEmbed()
        self.blocks = nn.ModuleList(Block() for _ in range(DEPTH))
        self.norm = nn.LayerNorm(WIDTH, eps=LN_EPS)


class ResidualConvUnit(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(FEATURES, FEATURES, 3, padding=1)
        self.conv2 = nn.Conv2d(FEATURES, FEATURES, 3, padding=1)


class FeatureFusionBlock(nn.Module):
    """`resConfUnit1` of `refinenet4` is the checkpoint's, unused (the
    deepest block has no skip)."""

    def __init__(self):
        super().__init__()
        self.out_conv = nn.Conv2d(FEATURES, FEATURES, 1)
        self.resConfUnit1 = ResidualConvUnit()
        self.resConfUnit2 = ResidualConvUnit()


class Scratch(nn.Module):
    def __init__(self):
        super().__init__()
        for i, c in enumerate(OUT_CHANNELS, 1):
            setattr(self, f"layer{i}_rn", nn.Conv2d(c, FEATURES, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock())
        self.output_conv1 = nn.Conv2d(FEATURES, FEATURES // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(FEATURES // 2, HEAD_FEATURES, 3, padding=1), nn.ReLU(),
            nn.Conv2d(HEAD_FEATURES, 1, 1), nn.Sigmoid())


class DPTHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.projects = nn.ModuleList(nn.Conv2d(WIDTH, c, 1) for c in OUT_CHANNELS)
        c0, c1, _, c3 = OUT_CHANNELS
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(c0, c0, 4, stride=4), nn.ConvTranspose2d(c1, c1, 2, stride=2),
            nn.Identity(), nn.Conv2d(c3, c3, 3, stride=2, padding=1)])
        self.scratch = Scratch()


def pos_grid_matrices(side: int, gh: int, gw: int):
    """The (gh, side) and (gw, side) bicubic matrices of the published
    position-embedding resize: scale factors (g + 0.1) / side."""
    return (bicubic_matrix(side, gh, (gh + INTERPOLATE_OFFSET) / side),
            bicubic_matrix(side, gw, (gw + INTERPOLATE_OFFSET) / side))


def interpolate_pos_encoding(pos_embed, gh: int, gw: int, mats=None):
    """The published `interpolate_pos_encoding` for a gh x gw patch grid:
    the 37x37 table resized bicubically (align_corners=False, no
    antialias) by the scale factors (g + 0.1) / 37, in f32, as two
    products with `pos_grid_matrices` (`mats`, on the table's device, or
    made here); returned as it is for the 37x37 grid. (1, 1 + gh * gw, C)."""
    n, C = pos_embed.shape[1] - 1, pos_embed.shape[2]
    if gh * gw == n and gh == gw:
        return pos_embed
    side = int(math.sqrt(n))
    if mats is None:
        mats = tuple(m.to(pos_embed.device) for m in pos_grid_matrices(side, gh, gw))
    mh, mw = mats
    pe = pos_embed.float()
    with f32_matmuls():
        rows = (mh @ pe[0, 1:].reshape(side, side * C)).reshape(gh, side, C)
        grid = torch.matmul(mw, rows)  # (gh, gw, C)
    return torch.cat([pe[:, :1], grid.reshape(1, gh * gw, C)], 1).to(pos_embed.dtype)


def bicubic_matrix(n_in: int, n_out: int, scale: float = None):
    """(n_out, n_in) f32 weights of `F.interpolate(mode="bicubic",
    align_corners=False)` along one axis resized to `n_out` (by the scale
    factor `scale` where one is given), computed in f32 as its kernel
    computes them: source x = step * (i + 0.5) - 0.5 with step n_in /
    n_out (1 / scale), Keys' cubic with a = -0.75, taps clamped into the
    input. The resize of a map is Mh @ x @ Mw^T."""
    f = np.float32
    a = f(-0.75)

    def near(t):  # |t| <= 1
        return ((a + f(2)) * t - (a + f(3))) * t * t + f(1)

    def far(t):  # 1 < |t| < 2
        return ((a * t - f(5) * a) * t + f(8) * a) * t - f(4) * a

    step = f(1.0 / scale) if scale else f(f(n_in) / f(n_out))
    x = step * (np.arange(n_out, dtype=f) + f(0.5)) - f(0.5)
    x0 = np.floor(x)
    t = x - x0
    m = np.zeros((n_out, n_in), f)
    rows = np.arange(n_out)
    for k, w in ((-1, far(t + 1)), (0, near(t)), (1, near(1 - t)), (2, far(2 - t))):
        np.add.at(m, (rows, np.clip(x0.astype(np.int64) + k, 0, n_in - 1)), w)
    return torch.from_numpy(m)


def resized_at_pixels(depth, kp_xy, height: int, width: int):
    """Bilinear resize (align_corners=True) of maps depth (C, h, w) to
    height x width, read at the pixels kp_xy (C, K, 2) round to (half to
    even, clamped): (C, K), as `F.interpolate` computes each output pixel
    (f32 scale (in - 1) / (out - 1), the source index truncated, the
    weights' products in its order)."""
    C, h, w = depth.shape
    u = torch.clamp(torch.round(kp_xy[..., 0]).to(torch.int64), 0, width - 1)
    v = torch.clamp(torch.round(kp_xy[..., 1]).to(torch.int64), 0, height - 1)
    sh = float(np.float32(h - 1) / np.float32(height - 1)) if height > 1 else 0.0
    sw = float(np.float32(w - 1) / np.float32(width - 1)) if width > 1 else 0.0
    src_h = v.to(torch.float32) * sh  # an f32 product: sh is an f32 value
    src_w = u.to(torch.float32) * sw
    h0, w0 = src_h.to(torch.int64), src_w.to(torch.int64)
    lh1, lw1 = src_h - h0, src_w - w0
    lh0, lw0 = 1.0 - lh1, 1.0 - lw1
    h1 = h0 + (h0 < h - 1).to(torch.int64)
    w1 = w0 + (w0 < w - 1).to(torch.int64)
    flat = depth.reshape(C, h * w)

    def at(hh, ww):
        return torch.gather(flat, 1, hh * w + ww)

    return lh0 * (lw0 * at(h0, w0) + lw1 * at(h0, w1)) + lh1 * (lw0 * at(h1, w0)
                                                                + lw1 * at(h1, w1))


class DepthAnythingV2(nn.Module):
    """Gray frames -> metric depth (m) at the network's input size.

    `compute_dtype` is the encoder's matmul and the head's conv
    precision; `input_size` the lower bound of the resize (518
    published; the CPU tests use a small one)."""

    def __init__(self, compute_dtype=torch.bfloat16, device="cuda", input_size=INPUT_SIZE):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.input_size = input_size
        self.pretrained = DinoVisionTransformer()
        self.depth_head = DPTHead()
        # The resizes' matrices (and mean, std) on the device, by frame size
        # and patch grid: copied from the host once.
        self._resize = {}
        self.to(device)

    # -- the encoder ---------------------------------------------------

    def _linear(self, x, lin):
        dt = self.compute_dtype
        return F.linear(x, lin.weight.to(dt), lin.bias.to(dt))

    def _block(self, x, blk: Block):
        """One pre-norm block on the f32 residual stream x (B, N, C)."""
        dt = self.compute_dtype
        B, N, C = x.shape
        h = F.layer_norm(x, (C,), blk.norm1.weight, blk.norm1.bias, LN_EPS).to(dt)
        qkv = self._linear(h, blk.attn.qkv).view(B, N, 3, HEADS, C // HEADS)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        o = F.scaled_dot_product_attention(q, k, v)
        o = self._linear(o.transpose(1, 2).reshape(B, N, C), blk.attn.proj)
        x = torch.addcmul(x, blk.ls1.gamma, o)  # in f32: one kernel a residual
        h = F.layer_norm(x, (C,), blk.norm2.weight, blk.norm2.bias, LN_EPS).to(dt)
        h = self._linear(F.gelu(self._linear(h, blk.mlp.fc1)), blk.mlp.fc2)
        return torch.addcmul(x, blk.ls2.gamma, h)

    def encode(self, image):
        """Normalised image (B, 3, H, W), H and W multiples of 14 -> the
        patch tokens (B, gh * gw, C) of each tap after the final norm, in
        `compute_dtype`."""
        vit, dt = self.pretrained, self.compute_dtype
        B, _, H, W = image.shape
        gh, gw = H // PATCH, W // PATCH
        pe = vit.patch_embed.proj
        x = F.conv2d(image.to(dt), pe.weight.to(dt), pe.bias.to(dt), stride=PATCH)
        x = torch.cat([vit.cls_token.float().expand(B, -1, -1),
                       x.flatten(2).transpose(1, 2).float()], 1)
        key = ("pos", x.device, gh, gw)
        if key not in self._resize:
            self._resize[key] = tuple(m.to(x.device) for m in pos_grid_matrices(POS_GRID, gh, gw))
        x = x + interpolate_pos_encoding(vit.pos_embed, gh, gw, self._resize[key]).float()
        profiling.count("tokens", B * x.shape[1])
        taps = []
        for i, blk in enumerate(vit.blocks):
            x = self._block(x, blk)
            if i in TAPS:
                taps.append(F.layer_norm(x, (WIDTH,), vit.norm.weight, vit.norm.bias,
                                         LN_EPS)[:, 1:].to(dt))
        return taps

    # -- the DPT head ----------------------------------------------------

    def _conv(self, x, conv):
        dt = self.compute_dtype
        b = None if conv.bias is None else conv.bias.to(dt)
        return F.conv2d(x, conv.weight.to(dt), b, stride=conv.stride, padding=conv.padding)

    def _rcu(self, x, unit: ResidualConvUnit):
        out = self._conv(F.relu(x), unit.conv1)
        return self._conv(F.relu(out), unit.conv2) + x

    def _fuse(self, block: FeatureFusionBlock, x, skip=None, size=None):
        if skip is not None:
            x = x + self._rcu(skip, block.resConfUnit1)
        x = self._rcu(x, block.resConfUnit2)
        if size is None:
            x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        else:
            x = F.interpolate(x, size=size, mode="bilinear", align_corners=True)
        return self._conv(x, block.out_conv)

    def head(self, taps, gh: int, gw: int):
        """Tap tokens -> the Sigmoid's input (B, gh * 14, gw * 14), f32."""
        dh, dt = self.depth_head, self.compute_dtype
        sc = dh.scratch
        layers = []
        for i, t in enumerate(taps):
            x = t.transpose(1, 2).reshape(t.shape[0], WIDTH, gh, gw)
            x = self._conv(x, dh.projects[i])
            r = dh.resize_layers[i]
            if isinstance(r, nn.ConvTranspose2d):
                x = F.conv_transpose2d(x, r.weight.to(dt), r.bias.to(dt), stride=r.stride)
            elif isinstance(r, nn.Conv2d):
                x = self._conv(x, r)
            layers.append(x)
        rn = [self._conv(x, getattr(sc, f"layer{i}_rn")) for i, x in enumerate(layers, 1)]
        path = self._fuse(sc.refinenet4, rn[3], size=rn[2].shape[2:])
        path = self._fuse(sc.refinenet3, path, rn[2], size=rn[1].shape[2:])
        path = self._fuse(sc.refinenet2, path, rn[1], size=rn[0].shape[2:])
        path = self._fuse(sc.refinenet1, path, rn[0])
        out = self._conv(path, sc.output_conv1)
        out = F.interpolate(out, size=(gh * PATCH, gw * PATCH), mode="bilinear",
                            align_corners=True)
        out = F.relu(self._conv(out, sc.output_conv2[0]))
        last = sc.output_conv2[2]
        with f32_matmuls():
            return F.conv2d(out.float(), last.weight.float(), last.bias.float())[:, 0]

    # -- frames in, depth out ----------------------------------------------

    def prepare(self, gray):
        """Gray (B, H, W) f32 in [0, 1] -> the normalised 3-channel input
        (B, 3, h, w) at `input_shape`: the bicubic resize of the gray (as
        two f32 products with `bicubic_matrix`), then ImageNet's mean and
        std per channel (the resize is linear and its weights sum to 1, so
        it commutes with the per-channel affine map of the published
        order). The matrices, mean and std go to the device once per frame
        size: no copy from the host after the first call."""
        B, H, W = gray.shape
        h, w = input_shape(H, W, self.input_size)
        key = (gray.device, H, W)
        if key not in self._resize:
            stats = torch.tensor([MEAN, STD], dtype=torch.float32)[:, None, :, None, None]
            self._resize[key] = tuple(t.to(gray.device) for t in (
                bicubic_matrix(H, h), bicubic_matrix(W, w).T.contiguous(), stats[0], stats[1]))
        mh, mwt, mean, std = self._resize[key]
        with f32_matmuls():
            g = (mh @ gray.float() @ mwt)[:, None]
        return (g - mean) / std

    def logits(self, gray):
        """Gray (B, H, W) f32 in [0, 1] -> the Sigmoid's input (B, h, w)
        at the network's input size, f32."""
        x = self.prepare(gray)
        gh, gw = x.shape[2] // PATCH, x.shape[3] // PATCH
        return self.head(self.encode(x), gh, gw)

    def forward(self, gray):
        """Gray (B, H, W) f32 in [0, 1] -> metric depth (B, h, w), f32."""
        return MAX_DEPTH * torch.sigmoid(self.logits(gray))

    def keypoint_depth(self, gray_u8, kp_xy):
        """Metric depth (C, K) at the full-resolution keypoint pixels kp_xy
        (C, K, 2) of frames gray_u8 (C, H, W) uint8."""
        C, H, W = gray_u8.shape
        with torch.no_grad():
            depth = self(unit_gray(gray_u8))
        return resized_at_pixels(depth, kp_xy, H, W)


def _param_shapes() -> dict:
    with torch.device("meta"):
        m = DepthAnythingV2(device="meta")
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


PARAM_SHAPES = _param_shapes()


def init_params(generator=None, seed: int = 5) -> dict:
    """Deterministic random parameters (the trainer's starting point; no
    pipeline runs a random net), drawn as DINOv2 initialises a ViT:
    linear weights and the position embedding truncated normal with std
    0.02 (cut at +-2), the cls token normal with std 1e-6, zero biases,
    LayerNorm 1 and 0, LayerScale 1 (the published `init_values`); the
    head's convolutions as `torch.nn` initialises them (Kaiming uniform,
    a = sqrt(5), and its bias bound). From `generator` or a
    `torch.Generator` seeded with `seed`. A state dict with the
    checkpoint's names."""
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    sd = {}
    for key, shape in PARAM_SHAPES.items():
        leaf = key.rsplit(".", 1)[1]
        t = torch.empty(shape)
        if key.startswith("pretrained."):
            if key.endswith("pos_embed") or (leaf == "weight" and len(shape) == 2):
                nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)
            elif key.endswith("cls_token"):
                nn.init.normal_(t, std=1e-6, generator=generator)
            elif leaf == "weight" and len(shape) == 4:
                nn.init.kaiming_uniform_(t, a=math.sqrt(5), generator=generator)
            elif leaf in ("weight", "gamma"):
                t.fill_(1.0)
            else:
                t.zero_()
        elif leaf == "weight":
            nn.init.kaiming_uniform_(t, a=math.sqrt(5), generator=generator)
        else:
            # torch.nn's bias bound: fan_in from the weight's dim 1 (a
            # transposed conv's too) and its kernel.
            wshape = PARAM_SHAPES[key[: -len("bias")] + "weight"]
            bound = 1.0 / math.sqrt(wshape[1] * int(np.prod(wshape[2:])))
            nn.init.uniform_(t, -bound, bound, generator=generator)
        sd[key] = t
    return sd
