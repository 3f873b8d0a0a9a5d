"""Plain float32 reference of Depth Anything V2 Small, metric (Yang et
al., arXiv:2406.09414; github.com/DepthAnything/Depth-Anything-V2,
`metric_depth/depth_anything_v2/dpt.py` and `dinov2.py`, model config
`vits`, `max_depth` 20), from its checkpoint.

Written from the published definition in plain `torch` operations with
TF32 off; it imports nothing of the program and reads the weights itself.
The forward pass: the frame resized (keep aspect, lower bound 518, each
side a multiple of 14) and normalised with ImageNet's mean and std; 14x14
patches to width 384, a cls token, the 37x37 position embedding resized
bicubically by the scale factors (g + 0.1) / 37; 12 blocks of
x + g1 * attn(LN(x)), x + g2 * MLP(LN(x)) with LN eps 1e-6, attention
written out as softmax(Q K^T / 8) V over 6 heads of 64, the MLP
fc2(GELU(fc1)) with the exact GELU; the tokens of blocks 2, 5, 8, 11
after the final LN into the DPT head (1x1 projections to 48, 96, 192,
384; a 4x4/4 and a 2x2/2 transposed conv, identity, a 3x3/2 conv; 3x3
convs to 64 without bias; fusion blocks of residual conv units
x + conv2(relu(conv1(relu(x)))), a bilinear resize with align_corners=True
and a 1x1 conv; a 3x3 conv to 32, a bilinear resize to the patch grid
x 14, a 3x3 conv, ReLU, a 1x1 conv, Sigmoid, x 20). Depth at a keypoint:
the map resized to the camera's size explicitly (bilinear,
align_corners=True, as the published `infer_image`), read at the pixel
the keypoint rounds to (half to even, clamped).

Departures from the published code: the camera's gray is replicated to
the three RGB channels; the input resize is torch's bicubic in place of
`cv2.INTER_CUBIC`; the weights are the repository's own (the architecture
trained on the synthetic rooms), or a published `.pth` where one is
given. `quant`, when given, rounds every matmul's and convolution's
inputs and weights first (the control: the same network in a lower
precision).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

PATCH = 14
WIDTH = 384
HEADS = 6
BLOCKS = 12
TAPS = (2, 5, 8, 11)
INPUT_SIZE = 518
MAX_DEPTH = 20.0
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def load_checkpoint(path: str, device) -> dict:
    """{name: f32 tensor} under the published names: a `.pth` state
    dict, or an `.npz` of bf16 bits as (2, *shape) uint8 planes (high
    bytes, then low bytes)."""
    if path.endswith((".pth", ".pt")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return {k: v.float().to(device) for k, v in sd.items()}
    out = {}
    with np.load(path) as z:
        for key in z.files:
            hi, lo = z[key].astype(np.uint32)
            f32 = ((hi << 24) | (lo << 16)).view(np.float32)  # bf16 bits, widened
            out[key] = torch.from_numpy(f32.copy()).to(device)
    return out


def input_shape(height: int, width: int, size: int = INPUT_SIZE):
    """The published lower-bound, aspect-kept resize to multiples of 14."""
    scale = max(size / height, size / width)

    def fit(x):
        y = int(np.round(x / PATCH) * PATCH)
        return y if y >= size else int(np.ceil(x / PATCH) * PATCH)

    return fit(scale * height), fit(scale * width)


def _q(x, quant):
    return x if quant is None else quant(x)


def _linear(x, p, name, quant):
    return _q(x, quant) @ _q(p[name + ".weight"], quant).T + p[name + ".bias"]


def _conv(x, p, name, quant, **kw):
    return F.conv2d(_q(x, quant), _q(p[name + ".weight"], quant), p.get(name + ".bias"), **kw)


def _ln(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], 1e-6)


def position_embedding(pos_embed, gh: int, gw: int):
    """The 37x37 table for a gh x gw grid: (1, 1 + gh * gw, C)."""
    n = pos_embed.shape[1] - 1
    if gh * gw == n and gh == gw:
        return pos_embed
    side = int(round(n ** 0.5))
    grid = pos_embed[:, 1:].reshape(1, side, side, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((gh + 0.1) / side, (gw + 0.1) / side),
                         mode="bicubic", antialias=False)
    return torch.cat([pos_embed[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], 1)


def _block(x, p, i, quant):
    b = f"pretrained.blocks.{i}"
    B, N, C = x.shape
    d = C // HEADS
    qkv = _linear(_ln(x, p, b + ".norm1"), p, b + ".attn.qkv", quant)
    q, k, v = qkv.reshape(B, N, 3, HEADS, d).permute(2, 0, 3, 1, 4)
    att = torch.softmax(_q(q, quant) @ _q(k, quant).transpose(-2, -1) / d ** 0.5, dim=-1)
    o = (_q(att, quant) @ _q(v, quant)).transpose(1, 2).reshape(B, N, C)
    x = x + p[b + ".ls1.gamma"] * _linear(o, p, b + ".attn.proj", quant)
    h = F.gelu(_linear(_ln(x, p, b + ".norm2"), p, b + ".mlp.fc1", quant))
    return x + p[b + ".ls2.gamma"] * _linear(h, p, b + ".mlp.fc2", quant)


def _rcu(x, p, name, quant):
    out = _conv(F.relu(x), p, name + ".conv1", quant, padding=1)
    return _conv(F.relu(out), p, name + ".conv2", quant, padding=1) + x


def _fuse(x, p, name, quant, skip=None, size=None):
    if skip is not None:
        x = x + _rcu(skip, p, name + ".resConfUnit1", quant)
    x = _rcu(x, p, name + ".resConfUnit2", quant)
    if size is None:
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
    else:
        x = F.interpolate(x, size=size, mode="bilinear", align_corners=True)
    return _conv(x, p, name + ".out_conv", quant)


def depth_map(params, gray_u8, quant=None, input_size: int = INPUT_SIZE):
    """(N, H, W) uint8 -> metric depth (N, h, w) at the network's input
    size, f32, with TF32 off (the flags are put back after)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _depth_map(params, gray_u8, quant, input_size)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _depth_map(p, gray_u8, quant, input_size):
    N, H, W = gray_u8.shape
    h, w = input_shape(H, W, input_size)
    rgb = (gray_u8.to(torch.float32) / 255.0)[:, None].expand(-1, 3, -1, -1)
    rgb = F.interpolate(rgb, size=(h, w), mode="bicubic", align_corners=False)
    mean = torch.tensor(MEAN, device=rgb.device)[None, :, None, None]
    std = torch.tensor(STD, device=rgb.device)[None, :, None, None]
    x = (rgb - mean) / std
    gh, gw = h // PATCH, w // PATCH
    x = _conv(x, p, "pretrained.patch_embed.proj", quant, stride=PATCH)
    x = torch.cat([p["pretrained.cls_token"].expand(N, -1, -1), x.flatten(2).transpose(1, 2)], 1)
    x = x + position_embedding(p["pretrained.pos_embed"], gh, gw)
    taps = []
    for i in range(BLOCKS):
        x = _block(x, p, i, quant)
        if i in TAPS:
            taps.append(_ln(x, p, "pretrained.norm")[:, 1:])
    dh = "depth_head"
    layers = []
    for i, t in enumerate(taps):
        y = _conv(t.transpose(1, 2).reshape(N, WIDTH, gh, gw), p, f"{dh}.projects.{i}", quant)
        r = f"{dh}.resize_layers.{i}"
        if i in (0, 1):
            y = F.conv_transpose2d(_q(y, quant), _q(p[r + ".weight"], quant), p[r + ".bias"],
                                   stride=4 if i == 0 else 2)
        elif i == 3:
            y = _conv(y, p, r, quant, stride=2, padding=1)
        layers.append(y)
    sc = f"{dh}.scratch"
    rn = [_conv(y, p, f"{sc}.layer{i}_rn", quant, padding=1) for i, y in enumerate(layers, 1)]
    path = _fuse(rn[3], p, f"{sc}.refinenet4", quant, size=rn[2].shape[2:])
    path = _fuse(path, p, f"{sc}.refinenet3", quant, rn[2], size=rn[1].shape[2:])
    path = _fuse(path, p, f"{sc}.refinenet2", quant, rn[1], size=rn[0].shape[2:])
    path = _fuse(path, p, f"{sc}.refinenet1", quant, rn[0])
    out = _conv(path, p, f"{sc}.output_conv1", quant, padding=1)
    out = F.interpolate(out, size=(gh * PATCH, gw * PATCH), mode="bilinear", align_corners=True)
    out = F.relu(_conv(out, p, f"{sc}.output_conv2.0", quant, padding=1))
    out = _conv(out, p, f"{sc}.output_conv2.2", quant)
    return MAX_DEPTH * torch.sigmoid(out[:, 0])


def depth_at(params, gray_u8, xy, quant=None, input_size: int = INPUT_SIZE):
    """Metric depth (N, K) at full-resolution pixels xy (N, K, 2): the map
    resized to the frames' size, read at the rounded pixel."""
    N, H, W = gray_u8.shape
    d = depth_map(params, gray_u8, quant, input_size)
    full = F.interpolate(d[:, None], size=(H, W), mode="bilinear", align_corners=True)[:, 0]
    u = torch.round(xy[..., 0]).long().clamp(0, W - 1)
    v = torch.round(xy[..., 1]).long().clamp(0, H - 1)
    return torch.gather(full.reshape(N, H * W), 1, v * W + u)
