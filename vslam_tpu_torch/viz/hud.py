"""2D HUD / match visualization (the OpenCV-highgui window equivalent).

Port of `vslam_tpu/viz/hud.py` (pure numpy, unchanged): the reference
app's per-frame debug imagery (its `src/main.cpp:1218-1306`), the current
frame annotated with keypoints, plus side-by-side before/after match
visualizations between the keyframe and the current frame, as uint8 RGB
images (save with cv2 or feed to the viewer frame stream).
"""

from __future__ import annotations

import numpy as np


def _to_rgb(img):
    img = np.asarray(img)
    if img.ndim == 2:
        if img.dtype != np.uint8:
            img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        return np.stack([img] * 3, axis=-1)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    return img.copy()


def _draw_point(img, x, y, color, r=2):
    H, W = img.shape[:2]
    x, y = int(round(x)), int(round(y))
    if 0 <= x < W and 0 <= y < H:
        img[max(y - r, 0) : y + r + 1, max(x - r, 0) : x + r + 1] = color


def _draw_line(img, x0, y0, x1, y1, color):
    H, W = img.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    xs = np.linspace(x0, x1, n).round().astype(int)
    ys = np.linspace(y0, y1, n).round().astype(int)
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[ok], xs[ok]] = color


GREEN = np.array([0, 255, 0], np.uint8)
RED = np.array([255, 60, 60], np.uint8)
CYAN = np.array([0, 255, 255], np.uint8)
YELLOW = np.array([255, 255, 0], np.uint8)


def annotate_frame(gray, kp_xy, kp_valid, tracked_mask=None):
    """Current frame with keypoints: green = tracked to map, cyan = raw."""
    img = _to_rgb(gray)
    kp_xy = np.asarray(kp_xy)
    kp_valid = np.asarray(kp_valid)
    tracked = (
        np.asarray(tracked_mask) if tracked_mask is not None else np.zeros(len(kp_xy), bool)
    )
    for i in range(len(kp_xy)):
        if kp_valid[i]:
            _draw_point(img, kp_xy[i, 0], kp_xy[i, 1], GREEN if tracked[i] else CYAN)
    return img


def match_image(gray1, gray2, xy1, xy2, match_idx, match_mask, color=GREEN,
                max_lines=150):
    """Side-by-side match visualization (`main.cpp:1262-1302`)."""
    a = _to_rgb(gray1)
    b = _to_rgb(gray2)
    H = max(a.shape[0], b.shape[0])
    W = a.shape[1] + b.shape[1]
    canvas = np.zeros((H, W, 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1] :] = b
    off = a.shape[1]
    xy1 = np.asarray(xy1)
    xy2 = np.asarray(xy2)
    idx = np.asarray(match_idx)
    mask = np.asarray(match_mask)
    drawn = 0
    for i in range(len(xy1)):
        if not mask[i]:
            continue
        j = idx[i]
        _draw_point(canvas, xy1[i, 0], xy1[i, 1], color)
        _draw_point(canvas, xy2[j, 0] + off, xy2[j, 1], color)
        _draw_line(canvas, xy1[i, 0], xy1[i, 1], xy2[j, 0] + off, xy2[j, 1], color)
        drawn += 1
        if drawn >= max_lines:
            break
    return canvas


def before_after(gray_kf, gray_cur, xy_kf, xy_cur, match_idx, raw_mask, gated_mask):
    """The reference's stacked raw-vs-gated comparison."""
    top = match_image(gray_kf, gray_cur, xy_kf, xy_cur, match_idx, raw_mask, YELLOW)
    bot = match_image(gray_kf, gray_cur, xy_kf, xy_cur, match_idx, gated_mask, GREEN)
    return np.concatenate([top, bot], axis=0)
