"""Batched multi-sequence runner: N sequences across the device mesh.

The port of `examples/run_batch.py`, the JAX package's scaling
configuration: one tracking scan per device (`parallel.mesh.
sharded_tracking_scan`: each device runs its own sequence's unbatched
scan), data parallel over sequences. With fewer datasets than devices,
synthetic sequences fill the rest. Prints the aggregate frames/s of a
timed run (after a warm-up run) and each sequence's ATE.

Usage:
  python -m vslam_tpu_torch.apps.run_batch [dataset_dir ...] [--devices N]
      [--cpu] [--frames N] [--frame-step 3]

It runs on the CUDA cards (one sequence per card); `--cpu` runs a mesh
of N CPU ranks instead, and without `--cpu` it raises when there is no
card. The JAX script's `--virtual-devices` (a virtual CPU mesh) has no
counterpart: `--cpu --devices N` does that job.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("datasets", nargs="*", help="TUM sequence directories")
    ap.add_argument("--devices", type=int, default=0,
                    help="mesh size (0 = every card, or 1 CPU rank with --cpu); the JAX "
                    "script's --virtual-devices has no counterpart: use --cpu --devices N")
    ap.add_argument("--cpu", action="store_true", help="a mesh of CPU ranks instead of cards")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--frame-step", type=int, default=3)
    return ap.parse_args(argv)


def main(argv=None):
    """Parse `argv` (the command line when None) and run at the default
    configuration; returns what `run` returns."""
    from vslam_tpu_torch.config import SlamConfig

    return run(parse_args(argv), SlamConfig())


def _device(args) -> torch.device:
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run_batch runs on the cards (pass --cpu for the CPU)")
    return torch.device("cuda")


def run(args, cfg):
    """The runner on parsed `args` with config `cfg`. Returns a summary:
    devices, frames, seconds and frames/s of the timed run, {name: ATE
    RMSE in m} per sequence with ground truth, and each rank's kernel
    launches and tracking counters in the timed run (`Mesh.stats`)."""
    from vslam_tpu_torch.core import frontend as fe, pipeline
    from vslam_tpu_torch.core.state import stack_trees
    from vslam_tpu_torch.data import loader as loader_mod, synthetic, tum
    from vslam_tpu_torch.eval import ate as ate_mod
    from vslam_tpu_torch.parallel import mesh as pmesh
    from vslam_tpu_torch.utils.cache import enable_persistent_cache

    dev = _device(args)
    enable_persistent_cache()
    c = cfg.camera
    n_dev = args.devices or (torch.cuda.device_count() if dev.type == "cuda" else 1)
    m = pmesh.make_mesh(n_dev, device=dev.type)
    print(f"[mesh] {n_dev} device(s): {[str(d) for d in m.devices]}")

    streams, names, gts = [], [], []
    front = None
    for d in args.datasets[:n_dev]:
        ld = loader_mod.open_sequence(d, width=c.width, height=c.height,
                                      depth_scale=c.depth_scale)
        meta = tum.load_sequence(d)
        idxs = list(range(0, len(ld), args.frame_step))[: args.frames]
        ld.prefetch(0, args.frame_step, len(idxs))
        grays, depths, stamps = [], [], []
        for i in idxs:
            rgb, depth, ts = ld.get(i)
            grays.append(np.mean(rgb, -1).astype(np.float32) / 255.0)
            depths.append(depth)
            stamps.append(ts)
        ld.close()
        if front is None:
            front = fe.SuperPointFrontend(cfg, device=dev)
        streams.append(fe.extract_sequence(front, np.stack(grays), np.stack(depths),
                                           np.asarray(stamps)))
        names.append(os.path.basename(d.rstrip("/")))
        gts.append(meta.gt)
    while len(streams) < n_dev:
        i = len(streams)
        seq = synthetic.make_sequence(
            num_frames=args.frames, max_keypoints=cfg.frontend.max_keypoints,
            desc_dim=cfg.frontend.descriptor_dim,
            fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, width=c.width, height=c.height,
            seed=i, num_landmarks=4000,
        )
        streams.append(pipeline.features_from_synthetic(seq, device=dev))
        names.append(f"synthetic-{i}")
        gts.append(np.concatenate(
            [seq.timestamps[:, None], seq.t, np.zeros((len(seq.timestamps), 4))], axis=1))

    frames = pmesh.shard_batched(stack_trees(streams), m)
    states = pmesh.shard_batched(pmesh.replicate_state(cfg, n_dev, device=dev), m)

    pmesh.sharded_tracking_scan(states, frames, cfg, m)  # warm-up
    t0 = time.perf_counter()
    fs, outs = pmesh.sharded_tracking_scan(states, frames, cfg, m)
    t_est = outs.t.cpu().numpy()
    dt = time.perf_counter() - t0
    rank_stats = m.stats
    m.close()
    total = sum(int(s.timestamp.shape[0]) for s in streams)
    print(f"[batch] {total} frames across {n_dev} device(s) in {dt:.2f}s "
          f"= {total / dt:.1f} frames/s aggregate")

    ate = {}
    for i, name in enumerate(names):
        ts = streams[i].timestamp.cpu().numpy()
        if gts[i] is not None:
            res = ate_mod.compute_ate(ts, t_est[i], gts[i][:, 0], gts[i][:, 1:4],
                                      with_scale=False)
            ate[name] = float(res.rmse)
            print(f"  {name}: ATE RMSE {res.rmse:.4f} m ({res.num_pairs} pairs)")
    return {"devices": n_dev, "frames": total, "seconds": dt, "frames_per_s": total / dt,
            "ate_rmse_m": ate, "rank_stats": rank_stats}


if __name__ == "__main__":
    main()
