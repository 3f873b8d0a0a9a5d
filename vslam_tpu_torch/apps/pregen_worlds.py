"""Pre-populate the port's rendered-world cache (`data.worldcache`).

The counterpart of `scripts/pregen_worlds.py`: the same worlds (the
bench's geometry: image worlds of seeds [0, N), the held-out v2 worlds
of seeds 40-41, the stress worlds s101_l1 and s202_l2.5), rendered by the
port's own `data.synthetic` into the port's own cache directory. Host
numpy only; no device.

Usage: python -m vslam_tpu_torch.apps.pregen_worlds [--tiny] [--seeds 10]
"""

from __future__ import annotations

import argparse
import time

from vslam_tpu_torch.config import SlamConfig, tiny_test_config
from vslam_tpu_torch.data import worldcache as wc


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seeds", type=int, default=10,
                    help="image worlds of seeds [0, N) (the bench's ate_wide uses 10)")
    ap.add_argument("--chunk", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.tiny:
        cfg = tiny_test_config()
        n_frames, lm, radius, long_frames = 16, 600, 2.0, 48
    else:
        cfg = SlamConfig()
        n_frames, lm, radius, long_frames = 848, 6000, 3.0, 2560
    c = cfg.camera
    chunk = args.chunk or (4 if args.tiny else 128)
    n_c = max((n_frames + chunk - 1) // chunk, 1) * chunk
    n_long = (long_frames + chunk - 1) // chunk * chunk
    W, H = c.width, c.height
    intr = dict(width=W, height=H, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy)
    fkw = dict(fx=float(c.fx), fy=float(c.fy), cx=float(c.cx), cy=float(c.cy))
    t0 = time.time()

    def note(msg):
        print(f"[pregen +{time.time() - t0:5.0f}s] {msg}", flush=True)

    def state(tag):
        return "cached" if wc.is_cached(tag) else "render"

    for seed in range(args.seeds):
        tag = wc.image_world_tag(n_c, W, H, seed, lm, radius, c.fx, c.fy, c.cx, c.cy)
        note(f"world seed={seed} ({state(tag)})")
        wc.image_world(n_c, seed=seed, num_landmarks=lm, radius=radius, **intr)
    for seed in (40, 41):
        tag = wc.image_world_tag(n_c, W, H, seed, lm, radius, c.fx, c.fy, c.cx, c.cy,
                                 family="v2")
        note(f"holdout v2 seed={seed} ({state(tag)})")
        wc.image_world(n_c, seed=seed, num_landmarks=lm, radius=radius, family="v2", **intr)
    s101 = dict(seed=101, loops=1.0)
    s202 = dict(seed=202, loops=2.5, pause=(0.3, 0.02), dropout=(0.6, 0.01))
    note(f"stress ({state(wc.stress_world_tag(n_c, W, H, lm, 's101_l1', **fkw, **s101))})")
    wc.stress_world("s101_l1", n_c, num_landmarks=lm, **intr, **s101)
    note(f"long stress ({state(wc.stress_world_tag(n_long, W, H, lm, 's202_l2.5', **fkw, **s202))})")
    wc.stress_world("s202_l2.5", n_long, num_landmarks=lm, **intr, **s202)
    note("done")


if __name__ == "__main__":
    main()
