"""Depth Anything V2 Small (`models.depth_anything`) trained on the
synthetic room worlds.

The published checkpoint is not in the repository, so the published
architecture is trained here on the rooms DepthNet trains on
(`models.train_depthnet`), reusing its pieces: `render_dataset` (the same
random in-room poses and jittered geometry, at full resolution: uint8
frames as the camera stores them and ray-cast depth), the masked L1 on
log depth (`masked_log_l1`), its photometric augments (gain, bias, read
noise from `ops.prng`), Adam with the warmup-cosine schedule
(`warmup_cosine`) and `evaluate` (DepthNet's held-out cells, so the two
networks' numbers compare). The loss is taken where the pipeline reads
depth: the network's map resized back to the camera's size (bilinear,
align_corners=True, as the published `infer_image`), against the
full-resolution depth. Gradients are clipped to norm 1 (a ViT trained
from scratch). A step updates the state in place, as DepthNet's does.
"""

from __future__ import annotations

import multiprocessing
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from vslam_tpu_torch.models import depth_anything as da
from vslam_tpu_torch.models import train_depthnet as tdn
from vslam_tpu_torch.ops import prng
from vslam_tpu_torch.ops.camera import unit_gray
from vslam_tpu_torch.ops.device import to_device

WARMUP_STEPS = 500
CLIP_NORM = 1.0
RENDER_PART = 64  # frames a rendering task draws from one generator


def _render_part(args):
    seed, part, n = args
    return tdn.render_dataset(np.random.default_rng([seed, part]), n, full_res=True)


def render(seed: int, num_images: int, workers: int = 1):
    """(gray (N, 480, 640) uint8, depth (N, 480, 640) f32) from
    `render_dataset(..., full_res=True)` in parts of `RENDER_PART` frames,
    part k drawn from `default_rng([seed, k])`; the same for any number
    of `workers` (spawned processes)."""
    parts = [(seed, k, min(RENDER_PART, num_images - k * RENDER_PART))
             for k in range(-(-num_images // RENDER_PART))]
    if workers > 1:
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            out = pool.map(_render_part, parts)
    else:
        out = [_render_part(p) for p in parts]
    return tuple(np.concatenate(a) for a in zip(*out))


def full_res_log_depth(model, gray, height: int, width: int):
    """The network's depth on gray (B, H, W) in [0, 1], resized to
    height x width (bilinear, align_corners=True), as log depth."""
    depth = model(gray)
    full = F.interpolate(depth[:, None], size=(height, width), mode="bilinear",
                         align_corners=True)[:, 0]
    return torch.log(torch.clamp(full, min=1e-6))


class TrainState(NamedTuple):
    model: da.DepthAnythingV2
    opt: torch.optim.Adam
    sched: object  # LambdaLR or None
    step: int


def make_trainer(lr=3e-4, total_steps=None, device="cuda", compute_dtype=torch.bfloat16,
                 input_size=da.INPUT_SIZE):
    """Returns (init, train_step, make_epoch), as `train_depthnet`'s:
    `init(params=None, seed=5)` from a state dict or
    `depth_anything.init_params(seed=seed)`; `train_step(state, gray_u8,
    logd, valid, key)` on frames (B, H, W) uint8 and full-resolution log
    depth and validity -> (state, loss as a 0-dim device tensor);
    `make_epoch(steps, batch)`. With `total_steps`, Adam follows the
    warmup-cosine schedule (warmup min(500, total_steps // 10), decay to
    lr / 100)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_trainer: no CUDA device (pass device='cpu' for the CPU)")

    def init(params=None, seed=5):
        model = da.DepthAnythingV2(compute_dtype=compute_dtype, device=dev,
                                   input_size=input_size)
        model.load_state_dict(params if params is not None else da.init_params(seed=seed))
        model.train()
        opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        sched = None
        if total_steps:
            warm = min(WARMUP_STEPS, total_steps // 10)
            sched = torch.optim.lr_scheduler.LambdaLR(
                opt, lambda n: tdn.warmup_cosine(n, lr, warm, total_steps, lr * 1e-2) / lr)
        return TrainState(model, opt, sched, 0)

    def train_step(state: TrainState, gray_u8, logd, valid, key):
        kg, kb, kn = prng.split(key, 3)
        B, H, W = gray_u8.shape
        gain = prng.uniform(kg, (B, 1, 1), 0.8, 1.2)
        bias = prng.uniform(kb, (B, 1, 1), -0.08, 0.08)
        g = torch.clamp(unit_gray(gray_u8) * gain + bias + 0.01 * prng.normal(kn, (B, H, W)),
                        0.0, 1.0)
        loss = tdn.masked_log_l1(full_res_log_depth(state.model, g, H, W), logd, valid)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(state.model.parameters(), CLIP_NORM)
        state.opt.step()
        if state.sched is not None:
            state.sched.step()
        return TrainState(state.model, state.opt, state.sched, state.step + 1), loss.detach()

    def make_epoch(steps: int, batch: int):
        def epoch(state, gray_u8, logd, valid, base_key):
            N = gray_u8.shape[0]
            keys = prng.fold_in(base_key, torch.arange(steps, device=base_key.device))
            losses = []
            for i in range(steps):
                k1, k2 = prng.split(keys[:, i], 2)
                idx = prng.randint(k1, (batch,), 0, N)
                state, loss = train_step(state, gray_u8[idx], logd[idx], valid[idx], k2)
                losses.append(loss)
            return state, torch.stack(losses)

        return epoch

    return init, train_step, make_epoch


def train(steps=8000, batch=16, num_images=4096, seed=0, lr=3e-4, steps_per_scan=100,
          log=print, device="cuda", dataset=None, input_size=da.INPUT_SIZE):
    """Full training run; deterministic for a fixed seed (on one device).
    `dataset` is a `render` pair rendered beforehand (the seed's own when
    None). Returns (TrainState, history list of losses)."""
    dev = torch.device(device)
    steps_per_scan = max(min(steps_per_scan, steps), 1)
    init, _, make_epoch = make_trainer(lr=lr, total_steps=steps, device=dev,
                                       input_size=input_size)
    state = init(seed=seed + 5)
    if dataset is None:
        if log:
            log(f"rendering {num_images} training frames...")
        dataset = render(seed, num_images)
    gray = torch.from_numpy(dataset[0]).to(dev)
    depth = torch.from_numpy(dataset[1]).to(dev)
    logd, valid = torch.log(torch.clamp(depth, min=0.1)), depth > 0.1
    del depth
    epoch = make_epoch(steps_per_scan, batch)
    base = to_device(prng.prng_key(seed + 31), dev)
    history = []
    n_scans = max(steps // steps_per_scan, 1)
    for e in range(n_scans):
        state, losses = epoch(state, gray, logd, valid, prng.fold_in(base, e))
        losses = losses.cpu().numpy()
        history.extend(losses.tolist())
        if log:
            log(f"scan {e + 1}/{n_scans} (step {(e + 1) * steps_per_scan}): "
                f"L1(log depth) {losses.mean():.4f}")
    return state, history


def predict_cells(model, gray_u8, batch: int = 8):
    """Log depth at DepthNet's output cells (`train_depthnet.cell_targets`)
    of frames gray_u8 (N, H, W) uint8 (host numpy): the network's map
    resized to the camera's size, the 2x2 mean around each cell centre."""
    dev = next(model.parameters()).device
    S = tdn.depthnet.OUT_STRIDE
    out = []
    with torch.no_grad():
        for i in range(0, len(gray_u8), batch):
            g = torch.from_numpy(gray_u8[i: i + batch]).to(dev)
            full = full_res_log_depth(model, unit_gray(g), g.shape[1], g.shape[2]).exp()
            blk = torch.stack([full[:, 3::S, 3::S], full[:, 3::S, 4::S], full[:, 4::S, 3::S],
                               full[:, 4::S, 4::S]])
            out.append(torch.log(blk.mean(0)).cpu().numpy())
    return np.concatenate(out)


def evaluate(model, seed=321, n_images=16):
    """`train_depthnet.evaluate` of the network: held-out default-geometry
    worlds, the same cells as DepthNet's."""
    return tdn.evaluate(model, seed, n_images, predict=predict_cells)
