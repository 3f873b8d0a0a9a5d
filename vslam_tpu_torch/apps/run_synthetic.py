"""One-command end-to-end demo on a generated synthetic sequence.

Port of `examples/run_synthetic.py`: generates a TUM-format dataset (the
room world's rendered gray and depth, ground truth, accelerometer and
the synthetic feature cache) with `data.synthetic.write_tum_sequence`,
then drives the whole app (`apps.run_tum`) on it as a user would on real
TUM data: cache-replay frontend, tracking, RTS smoothing, PGO + BA,
dense fusion, cloud epilogue, ATE/RPE, trajectory and PLY exports and the
viewer.

Usage:
  python -m vslam_tpu_torch.apps.run_synthetic              # on the card, 36 frames
  python -m vslam_tpu_torch.apps.run_synthetic --cpu --frames 16 --out /tmp/demo
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description="vslam_tpu_torch on a generated TUM directory")
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--out", default="out_torch/synthetic_demo")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--mono", action="store_true", help="monocular mode")
    ap.add_argument("--poisson", action="store_true",
                    help="Poisson mesh the dense cloud at the end")
    args = ap.parse_args(argv)

    from vslam_tpu_torch.apps import run_tum
    from vslam_tpu_torch.data import synthetic

    data_dir = os.path.join(args.out, "dataset")
    print(f"[run_synthetic] generating {args.frames}-frame room sequence -> {data_dir}")
    seq = synthetic.make_room_sequence(num_frames=args.frames, seed=args.seed)
    synthetic.write_tum_sequence(data_dir, seq, write_cache="sp_cache.npz")
    argv_tum = [data_dir, "--out", os.path.join(args.out, "run"),
                "--cache", os.path.join(data_dir, "sp_cache.npz"), "--frame-step", "1", "--ba"]
    if args.cpu:
        argv_tum.append("--cpu")
    if args.mono:
        argv_tum.append("--mono")
    if args.poisson:
        argv_tum.append("--poisson")
    print(f"[run_synthetic] run_tum {' '.join(argv_tum)}")
    run_tum.main(argv_tum)


if __name__ == "__main__":
    main()
