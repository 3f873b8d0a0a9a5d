"""SuperPoint training: synthetic-shapes pretraining + homographic pairs.

Port of `vslam_tpu/models/train_superpoint.py`, the recipe behind the
committed `superpoint_synth.npz`:
- a synthetic-shapes corner dataset and textured room renders with exact
  keypoint labels, made on the host with numpy (the port's own
  `data.synthetic` renderers);
- the detector loss, a per-cell 65-way cross-entropy against the corner
  grid (dustbin channel for empty cells), on both the image and its
  homography-warped view;
- the descriptor loss, a hinge contrastive loss over homography-related
  cell pairs;
- Adam (lr 1e-3, betas 0.9 / 0.999, eps 1e-8, as `optax.adam`).

The random homographies, photometric augments and batch indices come from
the port's `ops.prng`, which draws the same bits as `jax.random`, so a
step sees what the JAX package's step sees for the same key. The state is
the `SuperPoint` module (f32 parameters, bf16 compute as in Flax), its
`torch.optim.Adam` and a step count; a step updates them in place. The f32
products (warps, descriptor similarities) run with TF32 off
(`ops.linalg.f32_matmuls`). `make_epoch` is a host loop over steps that
gathers its batches from a dataset staged on the device: no step reads
anything back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from vslam_tpu_torch.models import superpoint as sp
from vslam_tpu_torch.ops import camera, prng
from vslam_tpu_torch.ops.device import sqrt, to_device
from vslam_tpu_torch.ops.linalg import f32_matmuls

CELL = 8


# ---------------------------------------------------------------------------
# Synthetic shapes data (host numpy, the JAX package's generators)
# ---------------------------------------------------------------------------


def synthetic_shapes_batch(rng, batch, height=120, width=160, max_corners=48):
    """Random segments/polygons with exact corner coordinates.

    Returns (images (B, H, W, 1) f32, corners (B, C, 2) f32, cmask (B, C))."""
    imgs = np.zeros((batch, height, width), np.float32)
    corners = np.zeros((batch, max_corners, 2), np.float32)
    cmask = np.zeros((batch, max_corners), bool)
    for b in range(batch):
        img = np.full((height, width), rng.uniform(0.1, 0.4), np.float32)
        pts = []
        for _ in range(rng.integers(3, 8)):
            x0, y0 = rng.uniform(5, width - 5), rng.uniform(5, height - 5)
            x1, y1 = rng.uniform(5, width - 5), rng.uniform(5, height - 5)
            n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
            xs = np.linspace(x0, x1, n).astype(int)
            ys = np.linspace(y0, y1, n).astype(int)
            shade = rng.uniform(0.6, 1.0)
            img[np.clip(ys, 0, height - 1), np.clip(xs, 0, width - 1)] = shade
            img[np.clip(ys + 1, 0, height - 1), np.clip(xs, 0, width - 1)] = shade  # thicken
            pts.append((x0, y0))
            pts.append((x1, y1))
        for i, (x, y) in enumerate(pts[:max_corners]):
            corners[b, i] = (x, y)
            cmask[b, i] = True
        imgs[b] = img + rng.normal(0, 0.02, img.shape)
    return imgs[..., None].astype(np.float32), corners, cmask


def _yaw_pitch_R(yaw, pitch):
    cy_, sy = np.cos(yaw), np.sin(yaw)
    cp, sp_ = np.cos(pitch), np.sin(pitch)
    Ry = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]], np.float32)
    Rx = np.array([[1, 0, 0], [0, cp, -sp_], [0, sp_, cp]], np.float32)
    return Ry @ Rx


def textured_batch(rng, batch, height=120, width=160, max_corners=160,
                   num_landmarks=300, fx=None, fy=None, family="v1"):
    """Textured room renders with exact keypoint labels (the landmark
    projections, i.e. the patch centres); a fresh world and fresh patch
    textures per image. `family="v2"` renders the held-out family.

    Returns (images (B, H, W, 1) f32, corners (B, C, 2), cmask (B, C))."""
    from vslam_tpu_torch.data import synthetic

    fx = fx or 0.75 * width
    fy = fy or 0.75 * width
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    imgs = np.zeros((batch, height, width), np.float32)
    corners = np.zeros((batch, max_corners, 2), np.float32)
    cmask = np.zeros((batch, max_corners), bool)
    render = synthetic.render_textured_v2 if family == "v2" else synthetic.render_textured
    for b in range(batch):
        world = synthetic.make_room_world(rng, num_landmarks=num_landmarks, desc_dim=8)
        R = _yaw_pitch_R(rng.uniform(-np.pi, np.pi), rng.uniform(-0.2, 0.2))
        t = np.array([rng.uniform(-2.5, 2.5), rng.uniform(-0.3, 0.9), rng.uniform(-2.5, 2.5)],
                     np.float32)
        imgs[b] = render(world, R, t, fx, fy, cx, cy, width, height,
                         seed=int(rng.integers(1 << 31))) + rng.normal(0, 0.01, (height, width))
        # Camera-frame coords are R^T (X - t), i.e. (X - t) @ R row-wise.
        pc = (world.landmarks - t) @ R
        z = pc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = fx * pc[:, 0] / z + cx
            v = fy * pc[:, 1] / z + cy
        vis = (z > 0.5) & (u >= 4) & (u < width - 4) & (v >= 4) & (v < height - 4)
        ids = np.nonzero(vis)[0][:max_corners]
        corners[b, : len(ids), 0] = u[ids]
        corners[b, : len(ids), 1] = v[ids]
        cmask[b, : len(ids)] = True
    return imgs[..., None].astype(np.float32), corners, cmask


# ---------------------------------------------------------------------------
# Labels, homographies, warps
# ---------------------------------------------------------------------------


def corners_to_cell_labels(corners, cmask, height, width):
    """Corner pixels (B, C, 2) -> per-cell 65-way labels (B, H/8, W/8):
    the position inside the cell (0-63), 64 (dustbin) for an empty cell;
    several corners in one cell keep the smallest position. As the JAX
    package's scatter-min with `mode="drop"`, a corner whose flat cell
    index falls outside the grid (possible when W is not a multiple of 8)
    is dropped; masked corners offer 64, which changes nothing."""
    B, C, _ = corners.shape
    Hc, Wc = height // CELL, width // CELL
    cx = torch.clamp(corners[..., 0].to(torch.int32), 0, width - 1)
    cy = torch.clamp(corners[..., 1].to(torch.int32), 0, height - 1)
    sub = (cy % CELL) * CELL + (cx % CELL)
    pos = (cy // CELL) * Wc + cx // CELL
    bidx = torch.arange(B, device=corners.device)[:, None].expand(B, C)
    b = torch.where(cmask, bidx, B - 1)
    pos = torch.where(cmask, pos, 0)
    val = torch.where(cmask, sub, 64)
    keep = pos < Hc * Wc
    flat_idx = torch.where(keep, b * (Hc * Wc) + pos, 0).reshape(-1).long()
    val = torch.where(keep, val, 64).reshape(-1).long()
    labels = torch.full((B * Hc * Wc,), 64, dtype=torch.int64, device=corners.device)
    labels.scatter_reduce_(0, flat_idx, val, "amin")
    return labels.reshape(B, Hc, Wc)


def random_homographies(key, batch, height, width, max_angle=0.15, max_scale=0.15,
                        max_shift=0.1):
    """Mild random similarity homographies (B, 3, 3) in pixel coordinates,
    H = T(centre + shift) R S T(-centre), drawn from `key` as the JAX
    package draws them. On the key's device."""
    ks = prng.split(key, 4)
    ang = prng.uniform(ks[0], (batch,), -max_angle, max_angle)
    sc = 1.0 + prng.uniform(ks[1], (batch,), -max_scale, max_scale)
    tx = prng.uniform(ks[2], (batch,), -max_shift, max_shift) * width
    ty = prng.uniform(ks[3], (batch,), -max_shift, max_shift) * height
    c, s = torch.cos(ang) * sc, torch.sin(ang) * sc
    cx, cy = width / 2.0, height / 2.0
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([
        torch.stack([c, -s, -c * cx + s * cy + cx + tx], -1),
        torch.stack([s, c, -s * cx - c * cy + cy + ty], -1),
        torch.stack([zero, zero, one], -1),
    ], dim=-2)


def _dehomogenise(w):
    z = torch.clamp(w[..., 2], min=1e-8)
    return w[..., 0] / z, w[..., 1] / z


def warp_images(images, H):
    """Inverse-warp images (B, H, W, 1) by homographies (B, 3, 3),
    bilinearly (`ops.camera.bilinear_sample`'s clamping). Returns (warped
    (B, H, W, 1), in-bounds mask (B, H, W))."""
    B, Ht, Wt, _ = images.shape
    dev = images.device
    ys, xs = torch.meshgrid(torch.arange(Ht, dtype=torch.float32, device=dev),
                            torch.arange(Wt, dtype=torch.float32, device=dev), indexing="ij")
    grid = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    Hinv, _ = torch.linalg.inv_ex(H)
    with f32_matmuls():
        src = torch.einsum("bij,pj->bpi", Hinv, grid)
    sx, sy = _dehomogenise(src)
    out = camera.bilinear_sample_batched(images[..., 0], torch.stack([sx, sy], -1))
    inb = ((sx >= 0) & (sx < Wt) & (sy >= 0) & (sy < Ht)).reshape(B, Ht, Wt)
    return out.reshape(B, Ht, Wt, 1), inb


def warp_corners(corners, cmask, H, height, width):
    """Forward-warp corner pixels (B, C, 2) by H (B, 3, 3); drop those that
    leave the image. Returns (warped (B, C, 2), mask (B, C))."""
    hom = torch.cat([corners, torch.ones_like(corners[..., :1])], -1)
    with f32_matmuls():
        w = torch.einsum("bij,bcj->bci", H, hom)
    wx, wy = _dehomogenise(w)
    inb = (wx >= 0) & (wx < width) & (wy >= 0) & (wy < height)
    return torch.stack([wx, wy], -1), cmask & inb


# ---------------------------------------------------------------------------
# Losses + train step
# ---------------------------------------------------------------------------


def detector_loss(semi, labels, valid=None):
    """65-way cross-entropy per cell (semi (B, Hc, Wc, 65) logits)."""
    logp = F.log_softmax(semi, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if valid is not None:
        ll = ll * valid
        return -torch.sum(ll) / torch.clamp(torch.sum(valid), min=1.0)
    return -torch.mean(ll)


def descriptor_loss(desc_a, desc_b, H, margin_pos=1.0, margin_neg=0.2):
    """Hinge contrastive loss over cell-centre correspondences (SuperPoint
    eq. 4): cells whose centres map within half a cell are positives.
    Positive and negative terms are each normalised by their pair counts
    (positives are ~1/P of the pairs). The (B, P, P) similarity is one
    batched product, with TF32 off."""
    B, Hc, Wc, D = desc_a.shape
    dev = desc_a.device
    da = desc_a / torch.clamp(torch.linalg.vector_norm(desc_a, dim=-1, keepdim=True), min=1e-8)
    db = desc_b / torch.clamp(torch.linalg.vector_norm(desc_b, dim=-1, keepdim=True), min=1e-8)
    ys, xs = torch.meshgrid(torch.arange(Hc, dtype=torch.float32, device=dev),
                            torch.arange(Wc, dtype=torch.float32, device=dev), indexing="ij")
    centers = torch.stack([xs * CELL + CELL / 2, ys * CELL + CELL / 2, torch.ones_like(xs)],
                          -1).reshape(-1, 3)
    with f32_matmuls():
        warped = torch.einsum("bij,pj->bpi", H, centers)
        wx, wy = _dehomogenise(warped)
        cq = centers[:, :2]
        d2 = (wx[:, :, None] - cq[None, None, :, 0]) ** 2 + (wy[:, :, None] - cq[None, None, :, 1]) ** 2
        s_corr = (d2 <= (CELL / 2.0) ** 2).to(da.dtype)
        dots = torch.matmul(da.reshape(B, -1, D), db.reshape(B, -1, D).transpose(1, 2))
    pos = s_corr * torch.clamp(margin_pos - dots, min=0.0)
    neg = (1.0 - s_corr) * torch.clamp(dots - margin_neg, min=0.0)
    return (torch.sum(pos) / torch.clamp(torch.sum(s_corr), min=1.0)
            + torch.sum(neg) / torch.clamp(torch.sum(1.0 - s_corr), min=1.0))


def binomial_blur(x):
    """[1, 2, 1] / 4 blur along H then W of (B, H, W, 1), edge-padded."""
    xp = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
    x = 0.25 * xp[:, :-2] + 0.5 * xp[:, 1:-1] + 0.25 * xp[:, 2:]
    xp = torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)
    return 0.25 * xp[:, :, :-2] + 0.5 * xp[:, :, 1:-1] + 0.25 * xp[:, :, 2:]


def photometric_augment(warped, key):
    """The warped view's augment, from the same split keys as the JAX
    step: a binomial blur on half the images, gain in [0.8, 1.2), bias in
    [-0.08, 0.08) and read noise of std 0.02."""
    B = warped.shape[0]
    kb, kg, ko, kn = prng.split(key, 4)
    gain = prng.uniform(kg, (B, 1, 1, 1), 0.8, 1.2)
    bias = prng.uniform(ko, (B, 1, 1, 1), -0.08, 0.08)
    blur_on = prng.bernoulli(kb, 0.5, (B, 1, 1, 1))
    warped = torch.where(blur_on, binomial_blur(warped), warped)
    return warped * gain + bias + 0.02 * prng.normal(kn, tuple(warped.shape))


def prepare_step(images, corners, cmask, key, height, width):
    """What a step computes before the network, without gradients: the
    cell labels of both views, the homographies (from the key's first
    split) and the warped view with its photometric augment (from the
    second). Returns (warped, labels_a, labels_b, H)."""
    labels_a = corners_to_cell_labels(corners, cmask, height, width)
    k_h, k_p = prng.split(key, 2)
    H = random_homographies(k_h, images.shape[0], height, width)
    warped, _ = warp_images(images, H)
    wc, wmask = warp_corners(corners, cmask, H, height, width)
    labels_b = corners_to_cell_labels(wc, wmask, height, width)
    return photometric_augment(warped, k_p), labels_a, labels_b, H


def loss_fn(model, images, warped, labels_a, labels_b, H, desc_weight=1.0):
    """(loss, detector loss, descriptor loss) of a step: detector CE on
    both views + `desc_weight` x descriptor hinge loss. Both views go
    through the network as one batch."""
    B = images.shape[0]
    semi, desc = model(torch.cat([images, warped]))
    l_det = detector_loss(semi[:B], labels_a) + detector_loss(semi[B:], labels_b)
    l_desc = descriptor_loss(desc[:B], desc[B:], H)
    return l_det + desc_weight * l_desc, l_det, l_desc


class TrainState(NamedTuple):
    model: sp.SuperPoint
    opt: torch.optim.Adam
    step: int


def adam(params, lr):
    """`optax.adam(lr)`'s settings."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_trainer(height=120, width=160, lr=1e-3, desc_weight=1.0, device="cuda",
                 compute_dtype=torch.bfloat16):
    """Returns (init, train_step, make_epoch), as the JAX package's
    `make_trainer`:
    - `init(params=None, seed=0)`: a TrainState from a SuperPoint state
      dict (e.g. one carried from Flax), else `superpoint.init_params(seed)`;
    - `train_step(state, images, corners, cmask, key)` -> (state, metrics
      {"loss", "det", "desc"} as 0-dim device tensors); the batch lies on
      the device and `key` is a `prng` key there;
    - `make_epoch(steps, batch)` -> `epoch(state, images, corners, cmask,
      base_key)` -> (state, (steps, 3) losses on the device).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_trainer: no CUDA device (pass device='cpu' for the CPU)")

    def init(params=None, seed=0):
        model = sp.SuperPoint(compute_dtype=compute_dtype, device=dev)
        model.load_state_dict(params if params is not None else sp.init_params(seed=seed))
        model.train()
        return TrainState(model, adam(model.parameters(), lr), 0)

    def train_step(state: TrainState, images, corners, cmask, key):
        """One step on a (B, H, W, 1) batch with exact corner labels:
        detector CE on both views + descriptor hinge loss, then Adam."""
        warped, labels_a, labels_b, H = prepare_step(images, corners, cmask, key, height, width)
        loss, l_det, l_desc = loss_fn(state.model, images, warped, labels_a, labels_b, H,
                                      desc_weight)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        state.opt.step()
        metrics = {"loss": loss.detach(), "det": l_det.detach(), "desc": l_desc.detach()}
        return TrainState(state.model, state.opt, state.step + 1), metrics

    def make_epoch(steps: int, batch: int):
        """`steps` steps sampling batches from a dataset staged on the
        device: step i's batch indices and key come from
        `fold_in(base_key, i)` as in the JAX package's scanned epoch."""

        def epoch(state, images, corners, cmask, base_key):
            N = images.shape[0]
            keys = prng.fold_in(base_key, torch.arange(steps, device=base_key.device))
            rows = []
            for i in range(steps):
                k1, k2 = prng.split(keys[:, i], 2)
                idx = prng.randint(k1, (batch,), 0, N)
                state, m = train_step(state, images[idx], corners[idx], cmask[idx], k2)
                rows.append(torch.stack([m["loss"], m["det"], m["desc"]]))
            return state, torch.stack(rows)

        return epoch

    return init, train_step, make_epoch


def _key(seed, dev):
    return to_device(prng.prng_key(seed), dev)


def train_synthetic(steps=50, batch=8, height=120, width=160, seed=0, log_every=10,
                    device="cuda"):
    """Short supervised pretraining run on synthetic shapes (corners).
    Returns (TrainState, history of {"loss", "det", "desc"} floats)."""
    rng = np.random.default_rng(seed)
    init, step_fn, _ = make_trainer(height, width, device=device)
    state = init(seed=seed)
    dev = torch.device(device)
    base = _key(seed + 1, dev)
    history = []
    for i in range(steps):
        imgs, corners, cmask = synthetic_shapes_batch(rng, batch, height, width)
        state, metrics = step_fn(state, torch.from_numpy(imgs).to(dev),
                                 torch.from_numpy(corners).to(dev),
                                 torch.from_numpy(cmask).to(dev), prng.fold_in(base, i))
        history.append({k: float(v) for k, v in metrics.items()})
        if log_every and i % log_every == 0:
            print(f"step {i}: {history[-1]}")
    return state, history


def evaluate_detector(model, seed=123, n_pairs=8, height=120, width=160,
                      max_keypoints=100, conf=0.015, ratio=0.85, family="v1"):
    """Held-out self-evaluation of a SuperPoint module on its device:
    detector repeatability and descriptor match precision between
    homography-related views of fresh textured renders.

    repeatability: the share of view-A keypoints whose warp lands within
    3 px of a detected view-B keypoint. match_precision: the share of
    ratio-test matches that are right under the homography (< 4 px)."""
    from vslam_tpu_torch.ops import matching, nms

    dev = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    imgs, _, _ = textured_batch(rng, n_pairs, height, width, family=family)
    imgs = torch.from_numpy(imgs).to(dev)
    H = random_homographies(_key(seed, dev), n_pairs, height, width)
    warped, _ = warp_images(imgs, H)

    def extract(images):
        with torch.no_grad():
            semi, desc_c = model(images)
        kps, desc = nms.extract_keypoints(semi, desc_c, max_keypoints=max_keypoints,
                                          radius=4, conf=conf)
        return kps.xy, kps.valid, desc

    with f32_matmuls():
        xy_a, va, da = extract(imgs)
        xy_b, vb, db = extract(warped)
        hom = torch.cat([xy_a, torch.ones_like(xy_a[..., :1])], -1)
        wx, wy = _dehomogenise(torch.einsum("bij,bkj->bki", H, hom))
        inb = (wx >= 0) & (wx < width) & (wy >= 0) & (wy < height) & va
        d2 = (wx[:, :, None] - xy_b[:, None, :, 0]) ** 2 + (wy[:, :, None] - xy_b[:, None, :, 1]) ** 2
        d2 = torch.where(vb[:, None, :], d2, 1e9)
        nearest = sqrt(torch.amin(d2, dim=-1))
        rep = float(torch.sum((nearest < 3.0) & inb) / torch.clamp(torch.sum(inb), min=1))
        n_correct = n_matched = 0
        for b in range(n_pairs):
            m = matching.knn2_ratio_match(da[b], db[b], va[b], vb[b], ratio=ratio)
            j = m.idx.long()
            err = sqrt((wx[b] - xy_b[b][j, 0]) ** 2 + (wy[b] - xy_b[b][j, 1]) ** 2)
            ok = m.valid & inb[b]
            n_matched += int(ok.sum())
            n_correct += int((ok & (err < 4.0)).sum())
    return {
        "repeatability": rep,
        "match_precision": n_correct / max(n_matched, 1),
        "matches_per_pair": n_matched / n_pairs,
        "kps_per_image": float(va.sum(-1).float().mean()),
    }


def render_training_set(num_images=384, height=120, width=160, seed=0, mix_shapes=0.25):
    """The recipe's dataset on the host: textured renders, then
    synthetic-shapes images (`mix_shapes` of them), drawn from one
    `default_rng(seed)` in the JAX package's order. Returns (images,
    corners, cmask) numpy arrays."""
    rng = np.random.default_rng(seed)
    n_shapes = int(num_images * mix_shapes)
    imgs_t, c_t, m_t = textured_batch(rng, num_images - n_shapes, height, width)
    imgs_s, c_s, m_s = synthetic_shapes_batch(rng, n_shapes, height, width,
                                              max_corners=c_t.shape[1])
    return (np.concatenate([imgs_t, imgs_s]), np.concatenate([c_t, c_s]),
            np.concatenate([m_t, m_s]))


def train_textured(steps=2000, batch=16, height=120, width=160, num_images=384, seed=0,
                   lr=1e-3, desc_weight=1.0, steps_per_scan=50, mix_shapes=0.25, log=print,
                   device="cuda", dataset=None):
    """The full training recipe behind the committed checkpoint: textured
    room renders mixed with synthetic-shapes corners, homographic
    descriptor pairs, epochs of `steps_per_scan` steps over the dataset
    staged on the device. Deterministic for a fixed seed (on one device).
    `dataset` is a `render_training_set` triple rendered beforehand (the
    seed's own when None).

    Returns (TrainState, history: list of (loss, det, desc) rows)."""
    dev = torch.device(device)
    steps_per_scan = max(min(steps_per_scan, steps), 1)
    init, _, make_epoch = make_trainer(height, width, lr=lr, desc_weight=desc_weight,
                                       device=dev)
    state = init(seed=seed)
    if dataset is None:
        dataset = render_training_set(num_images, height, width, seed, mix_shapes)
    images, corners, cmask = (torch.from_numpy(a).to(dev) for a in dataset)
    epoch = make_epoch(steps_per_scan, batch)
    base = _key(seed + 13, dev)
    history = []
    n_scans = max(steps // steps_per_scan, 1)
    for e in range(n_scans):
        state, ms = epoch(state, images, corners, cmask, prng.fold_in(base, e))
        ms = ms.cpu().numpy()
        history.extend(ms.tolist())
        if log:
            log(f"scan {e + 1}/{n_scans} (step {(e + 1) * steps_per_scan}): "
                f"loss {ms[-1][0]:.4f} det {ms[-1][1]:.4f} desc {ms[-1][2]:.4f}")
    return state, history
