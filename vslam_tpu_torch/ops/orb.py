"""ORB-style fallback features (FAST + oriented BRIEF), batched.

Port of `vslam_tpu/ops/orb.py`. The reference falls back to
`cv::ORB::create(3000, 1.2, 8)` when the SuperPoint model is absent
(`src/FeatureExtractor.cpp:12-15, 210-214`; `include/Config.h:48-50`).
Every function takes a stack of frames (B, H, W) where the JAX package
takes one frame under `vmap`:

- FAST-16: the 16 Bresenham circle taps are 16 rolled views of the
  image; the "9 contiguous" arc test is an AND over rolled masks; the
  border (where the rolls wrap) is zeroed.
- Orientation by intensity centroid over a 15x15 patch.
- rBRIEF: the seeded numpy pattern (the JAX package's generator, copied)
  rotated by each keypoint's angle; bits are +-1/sqrt(256) floats, so the
  L2 matcher works on them unchanged.
- Pyramid: each level resizes the FULL image with `ops.resize`, the
  counterpart of `jax.image.resize(..., "bilinear")` (which antialiases
  when it shrinks); NMS and top-k are `ops.nms`'s; the final top-K across
  levels is a stable sort, as `jnp.argsort` is.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vslam_tpu_torch.ops import device, nms as nms_ops
from vslam_tpu_torch.ops.resize import resize_bilinear

# FAST-16 Bresenham circle offsets (radius 3), clockwise.
_CIRCLE = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)


def fast_score(img, threshold=0.08, arc=9):
    """FAST-16 corner response of every pixel of (B, H, W) images in
    [0, 1] -> (B, H, W): the mean |diff| over the circle where the
    contiguous-arc test passes, else 0."""
    diff = torch.stack([torch.roll(img, shifts=(-int(dy), -int(dx)), dims=(-2, -1)) - img
                        for dx, dy in _CIRCLE])  # (16, B, H, W)
    bright = diff > threshold
    dark = diff < -threshold

    def contiguous(mask):
        acc = torch.zeros_like(mask[0])
        for s in range(16):
            run = torch.ones_like(mask[0])
            for a in range(arc):
                run = run & mask[(s + a) % 16]
            acc = acc | run
        return acc

    is_corner = contiguous(bright) | contiguous(dark)
    # The mean over the 16 taps, summed tap by tap (as XLA sums it on the
    # CPU), so the card and the CPU compute the same bits.
    ad = torch.abs(diff)
    total = ad[0]
    for k in range(1, 16):
        total = total + ad[k]
    score = total / 16.0
    score = torch.where(is_corner, score, 0.0)
    score[..., :3, :] = 0.0
    score[..., -3:, :] = 0.0
    score[..., :, :3] = 0.0
    score[..., :, -3:] = 0.0
    return score


def _gather_pixels(img, v, u):
    """img (B, H, W), integer v/u (B, ...) -> img[b, v, u] (B, ...)."""
    B, H, W = img.shape
    flat = (v * W + u).reshape(B, -1)
    return torch.gather(img.reshape(B, H * W), 1, flat).reshape(v.shape)


def orientation(img, xy, patch=15):
    """Intensity-centroid orientation (radians) at keypoints xy (B, K, 2)
    of images (B, H, W) -> (B, K)."""
    B, H, W = img.shape
    r = patch // 2
    dev = img.device
    offs = torch.arange(-r, r + 1, device=dev)
    cx = torch.clamp(xy[..., 0].to(torch.int64), r, W - 1 - r)
    cy = torch.clamp(xy[..., 1].to(torch.int64), r, H - 1 - r)
    yy = cy[..., None, None] + offs[:, None]
    xx = cx[..., None, None] + offs[None, :]
    p = _gather_pixels(img, yy.expand(-1, -1, -1, patch), xx.expand(-1, -1, patch, -1))
    # The moments sum the patch row by row with one rounding per term, as
    # XLA's fused multiply-reduce does (an FMA per term): each product of
    # an f32 pixel and a small integer is exact in f64, so adding it in
    # f64 and rounding to f32 gives the FMA's result. The angles then
    # agree with the JAX package's to atan2's rounding, on the card and on
    # the CPU alike; a plain sum differs by ~1e-5 rad on patches whose
    # moments nearly cancel.
    p = p.to(torch.float64)
    offs = offs.to(torch.float64)
    terms = torch.stack([p * offs[:, None], p * offs], dim=0).flatten(-2)  # (2, B, K, 225)
    acc = torch.zeros(terms.shape[:-1], dtype=torch.float64, device=dev)
    for t in range(terms.shape[-1]):  # row by row: (i, j) in row-major order
        acc = (acc + terms[..., t]).float().double()
    m01, m10 = acc.float()
    return torch.atan2(m01, m10)


@functools.lru_cache(maxsize=4)
def _brief_pattern_np(n_bits=256, patch=31, seed=7):
    """Deterministic BRIEF point pairs ~ N(0, (patch/5)^2), clipped: the
    JAX package's generator, value for value."""
    rng = np.random.default_rng(seed)
    r = patch // 2
    return np.clip(rng.normal(0, patch / 5.0, (n_bits, 4)), -r, r).astype(np.float32)


def brief_descriptors(img, xy, angles, n_bits=256):
    """Rotated BRIEF of images (B, H, W) at xy (B, K, 2) with angles
    (B, K) -> (B, K, n_bits) floats in {-1, +1} / sqrt(n_bits)."""
    pat = torch.from_numpy(_brief_pattern_np(n_bits)).to(img.device)  # (bits, 4)
    c, s = torch.cos(angles)[..., None], torch.sin(angles)[..., None]

    def rot(px, py):
        return c * px - s * py, s * px + c * py

    x1, y1 = rot(pat[:, 0], pat[:, 1])
    x2, y2 = rot(pat[:, 2], pat[:, 3])
    B, H, W = img.shape

    def sample(dx, dy):
        u = torch.clamp(xy[..., 0:1] + dx, 0, W - 1).to(torch.int64)
        v = torch.clamp(xy[..., 1:2] + dy, 0, H - 1).to(torch.int64)
        return _gather_pixels(img, v, u)

    bits = torch.where(sample(x1, y1) < sample(x2, y2), 1.0, -1.0)
    return bits / device.sqrt(torch.tensor(float(n_bits), dtype=torch.float32))


def detect_orb(img, max_keypoints=400, num_levels=8, scale_factor=1.2, threshold=0.08,
               nms_radius=4):
    """Multi-scale ORB detection on (B, H, W) grayscale [0, 1] images.

    Returns (xy (B, K, 2), score (B, K), valid (B, K), desc (B, K, 256))
    at full-image coordinates, as the SuperPoint frontend returns them."""
    B, H, W = img.shape
    img = img.to(torch.float32)
    per_level = max(max_keypoints // num_levels, 16)
    all_xy, all_score, all_valid, all_desc = [], [], [], []
    cur = img
    scale = 1.0
    for _ in range(num_levels):
        score = fast_score(cur, threshold=threshold)
        kept = nms_ops.nms_local_max(score, radius=nms_radius, conf_threshold=1e-6)
        kps = nms_ops.topk_keypoints(kept, per_level)
        ang = orientation(cur, kps.xy)
        all_desc.append(brief_descriptors(cur, kps.xy, ang))
        all_xy.append(kps.xy * scale)
        all_score.append(kps.score)
        all_valid.append(kps.valid)
        scale *= scale_factor
        nh, nw = int(round(H / scale)), int(round(W / scale))
        if nh < 32 or nw < 32:
            break
        cur = resize_bilinear(img, (nh, nw))

    xy = torch.cat(all_xy, dim=1)
    sc = torch.cat(all_score, dim=1)
    va = torch.cat(all_valid, dim=1)
    de = torch.cat(all_desc, dim=1)
    order = torch.argsort(-torch.where(va, sc, -1.0), dim=1, stable=True)[:, :max_keypoints]
    return (torch.gather(xy, 1, order[..., None].expand(-1, -1, 2)), torch.gather(sc, 1, order),
            torch.gather(va, 1, order),
            torch.gather(de, 1, order[..., None].expand(-1, -1, de.shape[-1])))
