"""Train SuperPoint on synthetic textured scenes and write a checkpoint.

The port's counterpart of `scripts/train_superpoint.py` (same flags, plus
`--cpu`): supervised interest points on textured room renders mixed with
synthetic-shapes corners, homographic descriptor pairs
(`models.train_superpoint.train_textured`). It prints each scan's loss,
the render time of the dataset, the training steps per second and the
model's achieved TFLOP/s (a step counted as 3 x forward x 2 views x
batch, `utils.flops`), writes the npz in the JAX package's format and
evaluates it on fresh held-out renders.

Usage:
  python -m vslam_tpu_torch.apps.train_superpoint --out out_torch/sp.npz
  python -m vslam_tpu_torch.apps.train_superpoint --eval-only [--out X.npz]

It runs on the CUDA card; `--cpu` runs it on the CPU instead, and without
`--cpu` it raises when there is no card. `--out` defaults under
`out_torch/`; `--eval-only` evaluates `--out`, or the JAX package's
committed checkpoint when `--out` is not given.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

DEFAULT_OUT = os.path.join("out_torch", "superpoint_synth.npz")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--images", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--desc-weight", type=float, default=1.0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--out", default=None, help=f"checkpoint to write (default {DEFAULT_OUT})")
    ap.add_argument("--eval-only", action="store_true")
    return ap.parse_args(argv)


def device_of(args) -> torch.device:
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: training runs on the card (pass --cpu for the CPU)")
    return torch.device("cuda")


def main(argv=None):
    """Train (or evaluate) as the flags say; returns a dict of what was
    printed (losses, rates, evaluation)."""
    from vslam_tpu_torch.models import train_superpoint as tsp, weights as w
    from vslam_tpu_torch.utils import flops

    args = parse_args(argv)
    dev = device_of(args)
    H, W = 120, 160
    if args.eval_only:
        model = w.load_superpoint(args.out or w.TRAINED_SP_NPZ, device=dev)
        ev = tsp.evaluate_detector(model)
        print("eval:", ev)
        return {"eval": ev}

    out = args.out or DEFAULT_OUT
    t0 = time.perf_counter()
    data = tsp.render_training_set(args.images, H, W, seed=args.seed)
    render_s = time.perf_counter() - t0
    print(f"rendered {args.images} training images in {render_s:.1f}s")
    t0 = time.perf_counter()
    state, history = tsp.train_textured(
        steps=args.steps, batch=args.batch, height=H, width=W, seed=args.seed, lr=args.lr,
        desc_weight=args.desc_weight, device=dev,
        dataset=data)
    train_s = time.perf_counter() - t0
    n = len(history)
    rate = n / train_s
    tflops = flops.superpoint_train_step_flops(args.batch, H, W) * rate / 1e12
    print(f"trained {n} steps in {train_s:.1f}s: {rate:.2f} steps/s, {1e3 / rate:.2f} ms/step, "
          f"{tflops:.3f} TFLOP/s (final loss {history[-1][0]:.4f})")
    w.save_superpoint_npz(out, state.model)
    print(f"saved {out} ({os.path.getsize(out) / 1e6:.2f} MB)")
    ev = tsp.evaluate_detector(state.model.eval())
    print("eval:", ev)
    return {"history": history, "render_s": render_s, "train_s": train_s,
            "steps_per_s": rate, "tflops": tflops, "out": out, "eval": ev}


if __name__ == "__main__":
    main()
