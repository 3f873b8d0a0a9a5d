"""DepthNet training on the synthetic RGB-D room worlds.

Port of `vslam_tpu/models/train_depthnet.py`: frames rendered at the
benchmark camera (VGA, fx 525) from random in-room poses with jittered
room geometry, box-downsampled 2x to the net's input; log metric depth
targets at the net's output stride; a masked L1 on log depth; photometric
augments (gain, bias, read noise) per step; Adam with a warmup-cosine
learning-rate schedule when the run's length is known.

The schedule is `optax.warmup_cosine_decay_schedule`'s formula in a
`torch.optim.lr_scheduler.LambdaLR` stepped after each `optimizer.step()`,
so step t updates with the schedule's value at count t, as optax
evaluates it before the update (its first step has lr 0 and changes no
parameter). Augments and batch indices come from the port's `ops.prng`
(the bits of `jax.random`). The state is the `DepthNet` module, its Adam,
its scheduler and a step count; a step updates them in place.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from vslam_tpu_torch.models import depthnet
from vslam_tpu_torch.ops import prng
from vslam_tpu_torch.ops.device import to_device
from vslam_tpu_torch.ops.linalg import f32_matmuls

FULL_W, FULL_H = 640, 480
FX = FY = 525.0
CX, CY = 319.5, 239.5


def _pose(rng, wall_dist):
    """Random in-room camera pose: planar-ish (the benchmark trajectory
    family) with height/pitch/roll jitter."""
    lim = wall_dist - 2.0
    t = np.array([rng.uniform(-lim, lim), rng.uniform(-0.25, 0.3), rng.uniform(-lim, lim)],
                 np.float32)
    yaw = rng.uniform(-np.pi, np.pi)
    pitch = rng.uniform(-0.12, 0.12)
    roll = rng.uniform(-0.05, 0.05)
    cy_, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    Ry = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return (Ry @ Rx @ Rz).astype(np.float32), t


def render_dataset(rng, num_images, jitter=True):
    """Render (gray_half (N, 240, 320, 1) f32, log_depth (N, 60, 80) f32,
    valid (N, 60, 80) bool) training triples on the host."""
    from vslam_tpu_torch.data import synthetic

    S = depthnet.OUT_STRIDE
    Hs, Ws = FULL_H // S, FULL_W // S
    gray = np.zeros((num_images, FULL_H // 2, FULL_W // 2, 1), np.float32)
    logd = np.zeros((num_images, Hs, Ws), np.float32)
    valid = np.zeros((num_images, Hs, Ws), bool)
    for i in range(num_images):
        wall = rng.uniform(7.0, 9.0) if jitter else 8.0
        floor = rng.uniform(1.3, 1.7) if jitter else 1.5
        n_lm = int(rng.integers(3000, 9001)) if jitter else 6000
        world = synthetic.make_room_world(rng, num_landmarks=n_lm, desc_dim=8, floor_y=floor,
                                          wall_dist=wall)
        R, t = _pose(rng, wall)
        img = synthetic.render_textured(world, R, t, FX, FY, CX, CY, FULL_W, FULL_H,
                                        seed=int(rng.integers(1 << 31)))
        d = synthetic.render_depth_room(R.astype(np.float64), t.astype(np.float64), FX, FY,
                                        CX, CY, FULL_W, FULL_H, floor_y=floor, wall_dist=wall)
        # 2x box downsample (the inference path's preprocessing).
        gray[i, ..., 0] = img.reshape(FULL_H // 2, 2, FULL_W // 2, 2).mean((1, 3))
        # Target at the output cell centre (full-res pixel 8i + 3.5): the
        # mean of the 2x2 block around it, valid iff all four hit geometry.
        blk = np.stack([d[3::S, 3::S], d[3::S, 4::S], d[4::S, 3::S], d[4::S, 4::S]])
        logd[i] = np.log(np.maximum(blk.mean(axis=0), 0.1))
        valid[i] = (blk > 0.1).all(axis=0)
    return gray, logd, valid


def warmup_cosine(count, peak, warmup_steps, decay_steps, end_value, init_value=0.0):
    """`optax.warmup_cosine_decay_schedule(init_value, peak, warmup_steps,
    decay_steps, end_value)` at `count` (a Python int): a linear ramp from
    init_value to peak over warmup_steps, then a cosine from peak to
    end_value over the remaining decay_steps - warmup_steps."""
    if count < warmup_steps:
        frac = 1.0 - count / warmup_steps
        return (init_value - peak) * frac + peak
    span = decay_steps - warmup_steps
    c = min(count - warmup_steps, span)
    alpha = end_value / peak
    cosine = 0.5 * (1.0 + math.cos(math.pi * c / span)) if span > 0 else 1.0
    return peak * ((1.0 - alpha) * cosine + alpha)


class TrainState(NamedTuple):
    model: depthnet.DepthNet
    opt: torch.optim.Adam
    sched: object  # LambdaLR or None
    step: int


def make_trainer(lr=2e-3, height=FULL_H // 2, width=FULL_W // 2, total_steps=None,
                 device="cuda", compute_dtype=torch.bfloat16):
    """Returns (init, train_step, make_epoch), as the JAX package's:
    `init(params=None, seed=11)` from a DepthNet state dict or
    `depthnet.init_params(seed=seed)`; `train_step(state, gray, logd,
    valid, key)` -> (state, loss as a 0-dim device tensor);
    `make_epoch(steps, batch)` -> `epoch(state, gray, logd, valid,
    base_key)` -> (state, (steps,) losses on the device). With
    `total_steps`, Adam follows the warmup-cosine schedule (warmup
    min(200, total_steps // 10), decay to lr / 100)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_trainer: no CUDA device (pass device='cpu' for the CPU)")

    def init(params=None, seed=11):
        model = depthnet.DepthNet(compute_dtype=compute_dtype, device=dev)
        model.load_state_dict(params if params is not None else depthnet.init_params(seed=seed))
        model.train()
        opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        sched = None
        if total_steps:
            warm = min(200, total_steps // 10)
            sched = torch.optim.lr_scheduler.LambdaLR(
                opt, lambda n: warmup_cosine(n, lr, warm, total_steps, lr * 1e-2) / lr)
        return TrainState(model, opt, sched, 0)

    def train_step(state: TrainState, gray, logd, valid, key):
        kg, kb, kn = prng.split(key, 3)
        B = gray.shape[0]
        gain = prng.uniform(kg, (B, 1, 1, 1), 0.8, 1.2)
        bias = prng.uniform(kb, (B, 1, 1, 1), -0.08, 0.08)
        g = torch.clamp(gray * gain + bias + 0.01 * prng.normal(kn, tuple(gray.shape)), 0.0, 1.0)
        with f32_matmuls():
            pred = state.model(g)
        vf = valid.to(pred.dtype)
        loss = torch.sum(torch.abs(pred - logd) * vf) / torch.clamp(torch.sum(vf), min=1.0)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        state.opt.step()
        if state.sched is not None:
            state.sched.step()
        return TrainState(state.model, state.opt, state.sched, state.step + 1), loss.detach()

    def make_epoch(steps: int, batch: int):
        def epoch(state, gray, logd, valid, base_key):
            N = gray.shape[0]
            keys = prng.fold_in(base_key, torch.arange(steps, device=base_key.device))
            losses = []
            for i in range(steps):
                k1, k2 = prng.split(keys[:, i], 2)
                idx = prng.randint(k1, (batch,), 0, N)
                state, loss = train_step(state, gray[idx], logd[idx], valid[idx], k2)
                losses.append(loss)
            return state, torch.stack(losses)

        return epoch

    return init, train_step, make_epoch


def train(steps=2000, batch=8, num_images=256, seed=0, lr=2e-3, steps_per_scan=50, log=print,
          device="cuda", dataset=None):
    """Full training run; deterministic for a fixed seed (on one device).
    `dataset` is a `render_dataset` triple rendered beforehand (the seed's
    own when None). Returns (TrainState, history list of losses)."""
    dev = torch.device(device)
    steps_per_scan = max(min(steps_per_scan, steps), 1)
    init, _, make_epoch = make_trainer(lr=lr, total_steps=steps, device=dev)
    state = init(seed=seed)
    if dataset is None:
        if log:
            log(f"rendering {num_images} training frames...")
        dataset = render_dataset(np.random.default_rng(seed), num_images)
    gray, logd, valid = (torch.from_numpy(a).to(dev) for a in dataset)
    epoch = make_epoch(steps_per_scan, batch)
    base = to_device(prng.prng_key(seed + 29), dev)
    history = []
    n_scans = max(steps // steps_per_scan, 1)
    for e in range(n_scans):
        state, losses = epoch(state, gray, logd, valid, prng.fold_in(base, e))
        losses = losses.cpu().numpy()
        history.extend(losses.tolist())
        if log:
            log(f"scan {e + 1}/{n_scans} (step {(e + 1) * steps_per_scan}): "
                f"L1(log depth) {losses[-1]:.4f}")
    return state, history


def evaluate(model, seed=321, n_images=16):
    """Held-out evaluation on fresh default-geometry worlds (the benchmark
    distribution): standard monocular depth metrics on valid cells."""
    rng = np.random.default_rng(seed)
    gray, logd, valid = render_dataset(rng, n_images, jitter=False)
    dev = next(model.parameters()).device
    with torch.no_grad():
        pred = model(torch.from_numpy(gray).to(dev)).float().cpu().numpy()
    d_gt, d_pr, m = np.exp(logd), np.exp(pred), valid
    ratio = np.maximum(d_pr[m] / d_gt[m], d_gt[m] / d_pr[m])
    return {
        "abs_rel": float(np.mean(np.abs(d_pr[m] - d_gt[m]) / d_gt[m])),
        "rmse_log": float(np.sqrt(np.mean((pred[m] - logd[m]) ** 2))),
        "delta_1.25": float(np.mean(ratio < 1.25)),
        "n_cells": int(m.sum()),
    }
