"""SuperPoint decode: channel softmax, depth-to-space, NMS, top-k,
bilinear descriptor sampling — batched tensor code.

Port of `vslam_tpu/ops/nms.py:27-228`. Ties are resolved as the JAX
package resolves them: `lax.top_k` returns equal values lowest index
first, which a stable descending sort reproduces (`torch.topk` makes no
such promise on the card); the window reductions are max-pools with
-inf padding (min as -maxpool(-x)).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from vslam_tpu_torch.ops import device

CELL = 8


def decode_heatmap(semi):
    """(B, Hc, Wc, 65) logits -> (B, H, W) keypoint probability heatmap."""
    e = torch.exp(semi - torch.amax(semi, dim=-1, keepdim=True))
    prob = (e / torch.sum(e, dim=-1, keepdim=True))[..., :64]
    B, Hc, Wc, _ = prob.shape
    prob = prob.reshape(B, Hc, Wc, CELL, CELL).permute(0, 1, 3, 2, 4)
    return prob.reshape(B, Hc * CELL, Wc * CELL)


def _win_max(x, k):
    """Separable (k, k) window max with SAME padding (-inf)."""
    r = k // 2
    y = F.max_pool2d(x[:, None], (k, 1), stride=1, padding=(r, 0))
    return F.max_pool2d(y, (1, k), stride=1, padding=(0, r))[:, 0]


def nms_local_max(heatmap, radius=4, conf_threshold=0.005):
    """Window-maximum NMS with an exact lowest-index tie-break:
    (B, H, W) -> same-shape score map with non-maxima zeroed."""
    B, H, W = heatmap.shape
    k = 2 * radius + 1
    pooled = _win_max(heatmap, k)
    is_max = (heatmap >= pooled) & (heatmap > conf_threshold)
    dev = heatmap.device
    idx = (torch.arange(H, dtype=torch.float32, device=dev)[:, None] * W
           + torch.arange(W, dtype=torch.float32, device=dev)[None, :])[None]
    e = torch.where(is_max, idx, torch.inf)
    tmin = -_win_max(-e, k)
    keep = is_max & (idx == tmin)
    return torch.where(keep, heatmap, 0.0)


class Keypoints(NamedTuple):
    xy: torch.Tensor  # (B, K, 2) float32 pixel coords (x=col, y=row)
    score: torch.Tensor  # (B, K)
    valid: torch.Tensor  # (B, K) bool


def _top_k(x, k):
    """`lax.top_k` over the last axis: descending, ties lowest index first."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def topk_keypoints(nms_map, max_keypoints=400, tile=8, per_tile=4):
    """Top-K surviving scores: top-4 per 8x8 tile, then a global top-K
    over the candidates (lossless after window-max NMS)."""
    B, H, W = nms_map.shape
    Ht, Wt = H // tile, W // tile
    tiles = nms_map[:, : Ht * tile, : Wt * tile]
    tiles = tiles.reshape(B, Ht, tile, Wt, tile).permute(0, 1, 3, 2, 4)
    tiles = tiles.reshape(B, Ht * Wt, tile * tile)
    tv, ti = _top_k(tiles, per_tile)
    tile_ids = torch.arange(Ht * Wt, device=nms_map.device)[None, :, None]
    ys = ((tile_ids // Wt) * tile + ti // tile).reshape(B, -1)
    xs = ((tile_ids % Wt) * tile + ti % tile).reshape(B, -1)
    scores, sel = _top_k(tv.reshape(B, -1), max_keypoints)
    xy = torch.stack(
        [torch.gather(xs, 1, sel).to(torch.float32), torch.gather(ys, 1, sel).to(torch.float32)],
        dim=-1,
    )
    return Keypoints(xy, scores, scores > 0.0)


def refine_subpixel(heatmap, kps: Keypoints):
    """Quadratic subpixel peak refinement of integer keypoint positions,
    only for peaks whose 3x3 neighbourhood lies inside one 8x8 cell."""
    B, H, W = heatmap.shape
    flat = heatmap.reshape(B, H * W)
    x0 = torch.clamp(kps.xy[..., 0].to(torch.int64), 0, W - 1)
    y0 = torch.clamp(kps.xy[..., 1].to(torch.int64), 0, H - 1)

    def at(yy, xx):
        yy = torch.clamp(yy, 0, H - 1)
        xx = torch.clamp(xx, 0, W - 1)
        return torch.gather(flat, 1, yy * W + xx)

    c = at(y0, x0)
    lx, rx = at(y0, x0 - 1), at(y0, x0 + 1)
    uy, dy = at(y0 - 1, x0), at(y0 + 1, x0)

    def vertex(lo, ct, hi):
        denom = lo + hi - 2.0 * ct
        off = torch.where(torch.abs(denom) > 1e-12, (lo - hi) / (2.0 * denom), 0.0)
        return torch.clamp(off, -0.5, 0.5)

    xy = kps.xy + torch.where(
        kps.valid[..., None], torch.stack([vertex(lx, c, rx), vertex(uy, c, dy)], dim=-1), 0.0
    )
    cx_ = torch.remainder(x0, CELL)
    cy_ = torch.remainder(y0, CELL)
    same_cell = (cx_ >= 1) & (cx_ <= CELL - 2) & (cy_ >= 1) & (cy_ <= CELL - 2)
    interior = ((x0 > 0) & (x0 < W - 1) & (y0 > 0) & (y0 < H - 1) & same_cell)[..., None]
    return Keypoints(torch.where(interior, xy, kps.xy), kps.score, kps.valid)


def sample_descriptors(desc_coarse, kp_xy, valid=None):
    """Bilinear descriptor sampling at kp/8 + L2 normalization.
    desc_coarse (B, Hc, Wc, D), kp_xy (B, K, 2) -> (B, K, D)."""
    B, Hc, Wc, D = desc_coarse.shape
    u = torch.clamp(kp_xy[..., 0] / CELL, 0.0, Wc - 1.0)
    v = torch.clamp(kp_xy[..., 1] / CELL, 0.0, Hc - 1.0)
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    u1 = torch.clamp(u0 + 1, max=Wc - 1)
    v1 = torch.clamp(v0 + 1, max=Hc - 1)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    flat = desc_coarse.reshape(B, Hc * Wc, D)

    def gather(vi, ui):
        return torch.gather(flat, 1, (vi * Wc + ui)[..., None].expand(-1, -1, D))

    d = (
        gather(v0, u0) * (1 - fu) * (1 - fv)
        + gather(v0, u1) * fu * (1 - fv)
        + gather(v1, u0) * (1 - fu) * fv
        + gather(v1, u1) * fu * fv
    )
    d = d / torch.clamp(device.sqrt(torch.sum(d * d, dim=-1, keepdim=True)), min=1e-8)
    if valid is not None:
        d = torch.where(valid[..., None], d, 0.0)
    return d


def extract_keypoints(semi, desc_coarse, max_keypoints=400, radius=4, conf=0.005,
                      subpixel=True):
    """Full decode: logits -> (Keypoints, descriptors), batched."""
    heat = decode_heatmap(semi)
    kept = nms_local_max(heat, radius=radius, conf_threshold=conf)
    kps = topk_keypoints(kept, max_keypoints)
    if subpixel:
        kps = refine_subpixel(heat, kps)
    return kps, sample_descriptors(desc_coarse, kps.xy, kps.valid)
