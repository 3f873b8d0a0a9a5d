"""Train the monocular DepthNet on synthetic RGB-D worlds and write a
checkpoint.

The port's counterpart of `scripts/train_depthnet.py` (same flags, plus
`--cpu`): frames rendered from random in-room poses, log-depth targets,
masked L1, Adam with the warmup-cosine schedule
(`models.train_depthnet.train`). It prints each scan's loss, the render
time, the training steps per second and the model's achieved TFLOP/s (a
step counted as 3 x forward x batch, `utils.flops`), writes the npz in
the JAX package's format and evaluates it on fresh default-geometry
worlds.

Usage:
  python -m vslam_tpu_torch.apps.train_depthnet --out out_torch/dn.npz
  python -m vslam_tpu_torch.apps.train_depthnet --eval-only [--out X.npz]

It runs on the CUDA card; `--cpu` runs it on the CPU instead, and without
`--cpu` it raises when there is no card. `--out` defaults under
`out_torch/`; `--eval-only` evaluates `--out`, or the JAX package's
committed checkpoint when `--out` is not given.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from vslam_tpu_torch.apps.train_superpoint import device_of

DEFAULT_OUT = os.path.join("out_torch", "depthnet_synth.npz")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--images", type=int, default=448)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--out", default=None, help=f"checkpoint to write (default {DEFAULT_OUT})")
    ap.add_argument("--eval-only", action="store_true")
    return ap.parse_args(argv)


def main(argv=None):
    """Train (or evaluate) as the flags say; returns a dict of what was
    printed."""
    from vslam_tpu_torch.models import train_depthnet as tdn, weights as w
    from vslam_tpu_torch.utils import flops

    args = parse_args(argv)
    dev = device_of(args)
    if args.eval_only:
        model = w.load_depthnet(args.out or w.TRAINED_DN_NPZ, device=dev)
        ev = tdn.evaluate(model)
        print("eval:", ev)
        return {"eval": ev}

    out = args.out or DEFAULT_OUT
    t0 = time.perf_counter()
    data = tdn.render_dataset(np.random.default_rng(args.seed), args.images)
    render_s = time.perf_counter() - t0
    print(f"rendered {args.images} training frames in {render_s:.1f}s")
    t0 = time.perf_counter()
    state, history = tdn.train(steps=args.steps, batch=args.batch, seed=args.seed, lr=args.lr,
                               device=dev, dataset=data)
    train_s = time.perf_counter() - t0
    n = len(history)
    rate = n / train_s
    H, W = tdn.FULL_H // 2, tdn.FULL_W // 2
    tflops = flops.depthnet_train_step_flops(args.batch, H, W) * rate / 1e12
    print(f"trained {n} steps in {train_s:.1f}s: {rate:.2f} steps/s, {1e3 / rate:.2f} ms/step, "
          f"{tflops:.3f} TFLOP/s (final loss {history[-1]:.4f})")
    w.save_depthnet_npz(out, state.model)
    print(f"saved {out} ({os.path.getsize(out) / 1e6:.2f} MB)")
    ev = tdn.evaluate(state.model.eval())
    print("eval:", ev)
    return {"history": history, "render_s": render_s, "train_s": train_s,
            "steps_per_s": rate, "tflops": tflops, "out": out, "eval": ev}


if __name__ == "__main__":
    main()
