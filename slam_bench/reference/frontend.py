"""Plain float32 reference of the SLAM frontend: SuperPoint-v1 (forward
and decode) and the monocular DepthNet, from the committed checkpoints.

Written from the models' definitions, in plain `torch` operations, with
TF32 off; it imports nothing of the program and reads the weights from
the checkpoint files itself. `quant`, when given, rounds every
convolution's input and weights first (the control: the same network in
a lower precision).

SuperPoint (DeTone et al., arXiv:1712.07629): a VGG backbone 64-64-64-64-
128-128-128-128 with 2x2 max-pools after the 2nd, 4th and 6th conv,
detector head 256 -> 65, descriptor head 256 -> 256. Decode: a softmax
over the 65 channels, the 64 cell channels laid out as 8x8 pixels, window
NMS (a pixel survives as the maximum of its (2r+1)^2 window, the lowest
flat index winning a tie, above the confidence threshold), the K best
survivors (ties lowest index first), a quadratic sub-pixel refinement of
peaks whose 3x3 neighbourhood lies inside one 8x8 cell, and descriptors
sampled bilinearly at xy / 8 (clamped) and normalised.

DepthNet: four stride-2 3x3 convs (24, 48, 96, 128), a 128 conv, two
upsampling stages on [2x nearest upsample, skip] (96, 64), and a 3x3
head to log depth, all with SAME padding as XLA computes it; input the
gray at half resolution (2x2 mean), edge-padded to a multiple of 16; the
log depth's cells sit at full-resolution pixel (i + 0.5) * 8 - 0.5.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SP_LAYERS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b",
             "convPa", "convPb", "convDa", "convDb")
DN_LAYERS = ("down1", "down2", "down3", "down4", "mid", "up3", "up2", "head")
CELL = 8
DN_STRIDE = 8  # full-resolution pixels per log-depth cell


def load_checkpoint(path: str, device) -> dict:
    """{layer: (weight OIHW f32, bias f32)} from a flat `layer/kernel`
    (HWIO), `layer/bias` npz."""
    out = {}
    with np.load(path) as z:
        names = {k.split("/")[0] for k in z.files}
        for name in names:
            k = z[f"{name}/kernel"].astype(np.float32).transpose(3, 2, 0, 1)
            b = z[f"{name}/bias"].astype(np.float32)
            out[name] = (torch.from_numpy(np.ascontiguousarray(k)).to(device),
                         torch.from_numpy(b).to(device))
    return out


def _conv(x, params, name, quant=None, stride=1, padding=0):
    w, b = params[name]
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def superpoint_forward(params, gray_u8, quant=None):
    """(N, H, W) uint8 -> semi (N, 65, H/8, W/8), coarse descriptors
    (N, 256, H/8, W/8), f32."""
    x = gray_u8.to(torch.float32)[:, None] / 255.0
    for i, name in enumerate(SP_LAYERS[:8]):
        x = F.relu(_conv(x, params, name, quant, padding=1))
        if i in (1, 3, 5):
            x = F.max_pool2d(x, 2, 2)
    semi = _conv(F.relu(_conv(x, params, "convPa", quant, padding=1)), params, "convPb", quant)
    desc = _conv(F.relu(_conv(x, params, "convDa", quant, padding=1)), params, "convDb", quant)
    return semi, desc


def _window_max(x, radius):
    k = 2 * radius + 1
    return F.max_pool2d(x[:, None], k, stride=1, padding=radius)[:, 0]


def decode(semi, desc_coarse, max_keypoints, nms_radius, conf):
    """Keypoints (N, K, 2) x/y, valid (N, K), descriptors (N, K, D)."""
    N, _, Hc, Wc = semi.shape
    prob = torch.softmax(semi, dim=1)[:, :64]
    heat = F.pixel_shuffle(prob, CELL)[:, 0]  # (N, H, W)
    H, W = heat.shape[1:]
    is_max = (heat >= _window_max(heat, nms_radius)) & (heat > conf)
    idx = torch.arange(H * W, device=heat.device, dtype=torch.float32).reshape(1, H, W)
    first = -_window_max(-torch.where(is_max, idx, torch.inf), nms_radius)
    score = torch.where(is_max & (idx == first), heat, 0.0).reshape(N, H * W)
    top, sel = torch.sort(score, dim=1, descending=True, stable=True)
    top, sel = top[:, :max_keypoints], sel[:, :max_keypoints]
    valid = top > 0.0
    y0, x0 = sel // W, sel % W
    flat = heat.reshape(N, H * W)

    def at(yy, xx):
        return torch.gather(flat, 1, yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1))

    def vertex(lo, c, hi):
        den = lo + hi - 2.0 * c
        off = torch.where(den.abs() > 1e-12, (lo - hi) / (2.0 * den), 0.0)
        return off.clamp(-0.5, 0.5)

    c = at(y0, x0)
    dx = vertex(at(y0, x0 - 1), c, at(y0, x0 + 1))
    dy = vertex(at(y0 - 1, x0), c, at(y0 + 1, x0))
    cx, cy = x0 % CELL, y0 % CELL
    inner = ((x0 > 0) & (x0 < W - 1) & (y0 > 0) & (y0 < H - 1) & (cx >= 1) & (cx <= CELL - 2)
             & (cy >= 1) & (cy <= CELL - 2) & valid)
    xy = torch.stack([x0.float() + torch.where(inner, dx, 0.0),
                      y0.float() + torch.where(inner, dy, 0.0)], -1)
    desc = sample_descriptors(desc_coarse, xy)
    return xy, valid, torch.where(valid[..., None], desc, 0.0)


def bilinear(maps, uv):
    """Bilinear samples of maps (N, C, h, w) at uv (N, K, 2) in map
    pixels, clamped into the map: (N, K, C)."""
    N, C, h, w = maps.shape
    u = uv[..., 0].clamp(0.0, w - 1.0)
    v = uv[..., 1].clamp(0.0, h - 1.0)
    u0, v0 = u.floor().long(), v.floor().long()
    u1, v1 = (u0 + 1).clamp(max=w - 1), (v0 + 1).clamp(max=h - 1)
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    flat = maps.reshape(N, C, h * w).transpose(1, 2)

    def g(vi, ui):
        return torch.gather(flat, 1, (vi * w + ui)[..., None].expand(-1, -1, C))

    return (g(v0, u0) * (1 - fu) * (1 - fv) + g(v0, u1) * fu * (1 - fv)
            + g(v1, u0) * (1 - fu) * fv + g(v1, u1) * fu * fv)


def sample_descriptors(desc_coarse, xy):
    d = bilinear(desc_coarse, xy / CELL)
    return d / d.norm(dim=-1, keepdim=True).clamp(min=1e-8)


def superpoint(params, gray_u8, max_keypoints, nms_radius, conf, quant=None):
    semi, desc = superpoint_forward(params, gray_u8, quant)
    return decode(semi, desc, max_keypoints, nms_radius, conf)


def _same_pad(x, stride):
    def pads(n):
        out = -(-n // stride)
        total = max((out - 1) * stride + 3 - n, 0)
        return total // 2, total - total // 2

    (t, b), (lft, r) = pads(x.shape[2]), pads(x.shape[3])
    return F.pad(x, (lft, r, t, b))


def depthnet_log_depth(params, gray_u8, quant=None):
    """(N, H, W) uint8 -> log depth (N, ceil(H/8), ceil(W/8))."""
    N, H, W = gray_u8.shape
    Hh, Wh = H // 2, W // 2
    g = gray_u8[:, : Hh * 2, : Wh * 2].to(torch.float32) / 255.0
    g = g.reshape(N, Hh, 2, Wh, 2).mean(dim=(2, 4))[:, None]
    Hp, Wp = -(-Hh // 16) * 16, -(-Wh // 16) * 16
    if (Hp, Wp) != (Hh, Wh):
        g = F.pad(g, (0, Wp - Wh, 0, Hp - Hh), mode="replicate")

    def conv(x, name, stride=1):
        return _conv(_same_pad(x, stride), params, name, quant, stride=stride)

    c1 = F.relu(conv(g, "down1", 2))
    c2 = F.relu(conv(c1, "down2", 2))
    c3 = F.relu(conv(c2, "down3", 2))
    c4 = F.relu(conv(F.relu(conv(c3, "down4", 2)), "mid"))
    up = F.interpolate
    u3 = F.relu(conv(torch.cat([up(c4, scale_factor=2, mode="nearest"), c3], 1), "up3"))
    u2 = F.relu(conv(torch.cat([up(u3, scale_factor=2, mode="nearest"), c2], 1), "up2"))
    out = conv(u2, "head")[:, 0]
    return out[:, : -(-Hh // 4), : -(-Wh // 4)]


def depth_at(log_depth, xy):
    """Metric depth (N, K) at full-resolution pixels xy (N, K, 2)."""
    uv = (xy + 0.5) / DN_STRIDE - 0.5
    return torch.exp(bilinear(log_depth[:, None], uv)[..., 0])


def fp8_quant(x):
    """Round to float8 e4m3 with one scale per tensor (amax to 448), the
    way fp8 inference feeds a convolution; back in f32."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
