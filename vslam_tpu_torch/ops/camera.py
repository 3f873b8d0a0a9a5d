"""Pinhole camera projection / back-projection (batched, masked).

Port of `vslam_tpu/ops/camera.py`, with a batched bilinear sample (what
`jax.vmap(bilinear_sample)` computes in `vslam_tpu/models/depthnet.py`).
"""

from __future__ import annotations

import torch

from vslam_tpu_torch.ops.device import div_const


def project(pts_cam, fx, fy, cx, cy, eps=1e-6):
    """Camera-frame points (..., 3) -> pixels (..., 2) + in-front mask."""
    z = pts_cam[..., 2]
    valid = z > eps
    zs = torch.where(valid, z, 1.0)
    u = fx * pts_cam[..., 0] / zs + cx
    v = fy * pts_cam[..., 1] / zs + cy
    return torch.stack([u, v], dim=-1), valid


def backproject(uv, depth, fx, fy, cx, cy):
    """Pixels (..., 2) + depth (...) -> camera-frame points (..., 3)."""
    x = div_const(uv[..., 0] - cx, fx) * depth
    y = div_const(uv[..., 1] - cy, fy) * depth
    return torch.stack([x, y, depth], dim=-1)


def normalize_pixels(uv, fx, fy, cx, cy):
    """Pixels -> normalized image coordinates (x/z, y/z)."""
    return torch.stack([div_const(uv[..., 0] - cx, fx), div_const(uv[..., 1] - cy, fy)], dim=-1)


def denormalize(xn, fx, fy, cx, cy):
    """Normalized image coordinates (..., 2) -> pixels."""
    return torch.stack([xn[..., 0] * fx + cx, xn[..., 1] * fy + cy], dim=-1)


def unit_gray(gray_u8):
    """Integer gray -> f32 in [0, 1] (`/ 255` as XLA rounds it)."""
    return div_const(gray_u8.to(torch.float32), 255.0)


def in_image(uv, width, height, margin=0.0):
    """Mask of pixels inside the image bounds."""
    return (
        (uv[..., 0] >= margin)
        & (uv[..., 0] <= width - 1 - margin)
        & (uv[..., 1] >= margin)
        & (uv[..., 1] <= height - 1 - margin)
    )


def _bilinear(img, uv, valid, lead):
    """Bilinear sample of img (*lead, H, W[, C]) at uv (*lead, ..., 2)."""
    nb = len(lead)
    H, W = img.shape[nb], img.shape[nb + 1]
    chan = img.ndim == nb + 3
    u = torch.clamp(uv[..., 0], 0.0, W - 1.0)
    v = torch.clamp(uv[..., 1], 0.0, H - 1.0)
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    u1 = torch.clamp(u0 + 1, max=W - 1)
    v1 = torch.clamp(v0 + 1, max=H - 1)
    fu = u - u0.to(u.dtype)
    fv = v - v0.to(v.dtype)
    b = tuple(torch.arange(n, device=img.device).reshape((-1,) + (1,) * (u.ndim - 1))
              for n in lead)

    def gat(vi, ui):
        return img[b + (vi, ui)]

    w00 = (1 - fu) * (1 - fv)
    w01 = fu * (1 - fv)
    w10 = (1 - fu) * fv
    w11 = fu * fv
    if chan:
        w00, w01, w10, w11 = (w[..., None] for w in (w00, w01, w10, w11))
    out = gat(v0, u0) * w00 + gat(v0, u1) * w01 + gat(v1, u0) * w10 + gat(v1, u1) * w11
    if valid is not None:
        out = torch.where(valid[..., None] if chan else valid, out, 0.0)
    return out


def bilinear_sample(img, uv, valid=None):
    """Bilinearly sample a (H, W) or (H, W, C) image at float pixels
    (..., 2). The pixel is clamped into the image before the floor, and
    the right/lower neighbour is clamped to the last row/column, as the JAX
    package does; pass `valid` to zero the samples it marks False."""
    return _bilinear(img, uv, valid, ())


def bilinear_sample_batched(imgs, uv, valid=None):
    """`bilinear_sample` per image: imgs (B, H, W) or (B, H, W, C), uv
    (B, ..., 2), valid (B, ...) or None (what `jax.vmap(bilinear_sample)`
    computes)."""
    return _bilinear(imgs, uv, valid, (imgs.shape[0],))


def nearest_sample(img, uv):
    """Nearest-pixel sample (rounding half to even, as `jnp.round`)."""
    H, W = img.shape[0], img.shape[1]
    u = torch.clamp(torch.round(uv[..., 0]).to(torch.int64), 0, W - 1)
    v = torch.clamp(torch.round(uv[..., 1]).to(torch.int64), 0, H - 1)
    return img[v, u]
