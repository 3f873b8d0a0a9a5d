"""Train Depth Anything V2 Small (metric) on synthetic room worlds and
write its bf16 checkpoint.

The published architecture (`models.depth_anything`) trained from random
init on the rooms DepthNet trains on (`models.train_depth_anything`):
full-resolution frames from random in-room poses rendered in
`--workers` processes, the masked L1 on log depth at the camera's
resolution, Adam with the warmup-cosine schedule. It prints each scan's
loss, the render time, the steps per second and the achieved TFLOP/s (a
step counted as 3 x forward x batch, `utils.flops`), writes the weights
as bf16 (`models.weights.save_depth_anything_npz`) and evaluates them on
DepthNet's held-out cells (`abs_rel`, `rmse_log`, `delta_1.25`).

Usage:
  python -m vslam_tpu_torch.apps.train_depth_anything --out out_torch/da2.npz
  python -m vslam_tpu_torch.apps.train_depth_anything --eval-only [--out X.npz]

It runs on the CUDA card; `--cpu` runs it on the CPU instead (use a small
`--input-size` there), and without `--cpu` it raises when there is no
card. `--out` defaults under `out_torch/`; `--eval-only` evaluates
`--out`, or the committed checkpoint when `--out` is not given.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from vslam_tpu_torch.apps.train_superpoint import device_of

DEFAULT_OUT = os.path.join("out_torch", "depth_anything_v2_small_synth.npz")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--images", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--workers", type=int, default=8, help="rendering processes")
    ap.add_argument("--input-size", type=int, default=518,
                    help="the resize's lower bound (518 published)")
    ap.add_argument("--eval-images", type=int, default=16)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--out", default=None, help=f"checkpoint to write (default {DEFAULT_OUT})")
    ap.add_argument("--eval-only", action="store_true")
    return ap.parse_args(argv)


def main(argv=None):
    """Train (or evaluate) as the flags say; returns a dict of what was
    printed."""
    from vslam_tpu_torch.models import depth_anything as da
    from vslam_tpu_torch.models import train_depth_anything as tda
    from vslam_tpu_torch.models import weights as w
    from vslam_tpu_torch.utils import flops

    args = parse_args(argv)
    dev = device_of(args)
    if args.eval_only:
        model = w.load_depth_anything(args.out or w.TRAINED_DA2_NPZ, device=dev,
                                      input_size=args.input_size)
        ev = tda.evaluate(model, n_images=args.eval_images)
        print("eval:", json.dumps(ev))
        return {"eval": ev}

    out = args.out or DEFAULT_OUT
    t0 = time.perf_counter()
    data = tda.render(args.seed, args.images, args.workers)
    render_s = time.perf_counter() - t0
    print(f"rendered {args.images} training frames in {render_s:.1f}s", flush=True)
    t0 = time.perf_counter()
    state, history = tda.train(steps=args.steps, batch=args.batch, seed=args.seed, lr=args.lr,
                               device=dev, dataset=data, input_size=args.input_size,
                               log=lambda s: print(s, flush=True))
    train_s = time.perf_counter() - t0
    n = len(history)
    rate = n / train_s
    h, wd = da.input_shape(data[0].shape[1], data[0].shape[2], args.input_size)
    tflops = 3.0 * flops.depth_anything_flops_per_frame(h, wd) * args.batch * rate / 1e12
    print(f"trained {n} steps in {train_s:.1f}s: {rate:.2f} steps/s, {1e3 / rate:.2f} ms/step, "
          f"{tflops:.3f} TFLOP/s (final loss {history[-1]:.4f})", flush=True)
    w.save_depth_anything_npz(out, state.model)
    print(f"saved {out} ({os.path.getsize(out) / 1e6:.2f} MB)", flush=True)
    ev = tda.evaluate(state.model, n_images=args.eval_images)
    print("eval:", json.dumps(ev), flush=True)
    return {"history": history, "render_s": render_s, "train_s": train_s,
            "steps_per_s": rate, "tflops": tflops, "out": out, "eval": ev}


if __name__ == "__main__":
    main()
