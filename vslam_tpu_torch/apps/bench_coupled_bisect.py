"""Bisect the coupled program's cost on one rendered sequence.

The port of `scripts/bench_coupled_bisect.py`: on the same rasterized
seed-0 room world (6,000 landmarks, radius 3 m, with colors) and chunk
size it times

  (A)  the chunked frontend alone (SuperPoint, keypoints, descriptors and
       keypoint depth);
  (B)  the frontend and the tracking loop (`core.tracking.run_frames`,
       the JAX script's nested `make_scan_step` scan);
  (E1) B with every `StepOutputs` leaf read (the JAX script's B-full);
  (D)  dense fusion alone on the ground-truth poses, and (E2) the same
       with the colors;
  (C)  the whole coupled program, `core.coupled.run_coupled`.

The JAX script's F, G and H are not ported: they probe what XLA's
dead-code elimination removes from one jitted program (phase 2 on input
poses, a scalar output, in-program checksums of every buffer). The port
runs eagerly and removes nothing, so G is C, H is C with every leaf read
and F is B followed by E2.

Each program copies the state and the dense map it starts from, as
`run_coupled` does (both are written in place). One run of C warms
every program (it runs all their kernels); then a program's time is the
median of `--iters` runs (`utils.profiling.seconds_per_iter`: CUDA
events on the card, the host clock on the CPU), in ms per frame;
beside it the program's device activities per frame (`torch.profiler`,
CUDA activity only; null on the CPU), and its checksum (the value the JAX
program returns). One JSON line with the JAX script's keys.

Usage: python -m vslam_tpu_torch.apps.bench_coupled_bisect [--cpu]
       [--chunk 128] [--frames 896] [--iters 5]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from vslam_tpu_torch.utils.profiling import bench_device, device_activities, seconds_per_iter


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--frames", type=int, default=896)
    ap.add_argument("--iters", type=int, default=5, help="timed runs per program")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return ap.parse_args(argv)


def main(argv=None):
    from vslam_tpu_torch.config import SlamConfig

    out = run(parse_args(argv), SlamConfig())
    print(json.dumps({k: v for k, v in out.items() if k != "C_t"}))
    return out


def run(args, cfg):
    """The bisect on parsed `args` with config `cfg`. Returns the JAX
    script's keys (`*_ms_per_frame`, the deltas, `chunk`, `frames`), with
    `*_activities_per_frame`, `checksums` {program: value}, the weights'
    source, `C_ate_raw_m` (C's raw ATE against the ground truth) and
    `C_t` (C's positions, (frames, 3) as lists)."""
    from vslam_tpu_torch.core import coupled, frontend as fe, tracking as T
    from vslam_tpu_torch.core.state import StepOutputs, copy_to, init_state
    from vslam_tpu_torch.data import synthetic
    from vslam_tpu_torch.eval import ate as ate_mod
    from vslam_tpu_torch.models import weights
    from vslam_tpu_torch.ops import gridhash

    dev = bench_device(args, "bench_coupled_bisect")
    c = cfg.camera
    C = args.chunk
    S = max((args.frames + C - 1) // C, 1)
    nC = S * C
    H, W = c.height, c.width

    model, src = weights.load_or_init_superpoint(device=dev)
    d0 = synthetic.make_image_sequence(
        nC, width=W, height=H, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
        seed=0, num_landmarks=6000, radius=3.0, with_rgb=True)
    gray = torch.from_numpy(d0["gray"].reshape(S, C, H, W)).to(dev)
    dep = torch.from_numpy(d0["depth_u16"].astype(np.int32).reshape(S, C, H, W)).to(dev)
    rgb = torch.from_numpy(d0["rgb"].reshape(S, C, H, W, 3)).to(dev)
    ts = torch.from_numpy(d0["timestamps"].astype(np.float32).reshape(S, C)).to(dev)
    fid = torch.arange(nC, dtype=torch.int32).reshape(S, C).to(dev)
    ids = fid.cpu().tolist()
    stat = torch.zeros((S, C), dtype=torch.bool, device=dev)
    Rgt = torch.from_numpy(d0["R"].astype(np.float32).reshape(S, C, 3, 3)).to(dev)
    tgt = torch.from_numpy(d0["t"].astype(np.float32).reshape(S, C, 3)).to(dev)
    st0 = init_state(cfg, device=dev)
    dn0 = gridhash.init_dense_map(cfg.dense.hash_capacity, cfg.dense.cloud_capacity, device=dev)

    def fe_only():
        chk = torch.zeros((), dtype=torch.float32, device=dev)
        for s in range(S):
            kps, desc = fe.extract_chunk(model, gray[s], cfg)
            kpd = fe.sample_depth_at_keypoints(fe.depth_meters(dep[s], c.depth_scale), kps.xy)
            chk = chk + torch.sum(kpd) + torch.sum(kps.xy) * 1e-6 + torch.sum(desc) * 1e-6
        return chk

    def fe_track_outs():
        st, outs = copy_to(st0, dev), []
        for s in range(S):
            frames = fe.frontend_features(model, gray[s], dep[s], ts[s], fid[s], stat[s], cfg)
            st, out = T.run_frames(st, frames, ids[s], cfg, seed=42)
            outs.append(out)
        return StepOutputs(*(torch.cat(f) for f in zip(*outs)))

    def fe_track():
        return torch.sum(fe_track_outs().t)

    def fe_track_full():
        chk = torch.zeros((), dtype=torch.float32, device=dev)
        for leaf in fe_track_outs():
            chk = chk + torch.sum(leaf.to(torch.float32))
        return chk

    def fuse_nested(colors):
        dn = copy_to(dn0, dev)
        for s in range(S):
            dn = coupled.fuse_chunk(dn, dep[s], rgb[s] if colors else None, Rgt[s], tgt[s], cfg, C)
        return dn.cloud_count

    def full():
        _, _, outs = coupled.run_coupled(model, st0, dn0, gray, dep, rgb, ts, fid, stat, cfg,
                                         device=dev)
        return outs.t

    programs = {
        "A_frontend": fe_only,
        "B_fe_track": fe_track,
        "D_fuse_nested": lambda: fuse_nested(False),
        "E1_fe_track_full_outs": fe_track_full,
        "E2_fuse_nested_rgb": lambda: fuse_nested(True),
        "C_full": full,
    }
    last = {}

    def keep(name, fn):
        def call():
            last[name] = fn()
        return call

    full()  # the warm run for all: every kernel built, cuDNN's choices made
    res, secs = {}, {}
    for name, fn in programs.items():
        secs[name] = seconds_per_iter(keep(name, fn), 1, dev, reps=args.iters, warm=False)
        res[f"{name}_ms_per_frame"] = 1e3 * secs[name] / nC
        print(f"{name:24s} {res[f'{name}_ms_per_frame']:9.3f} ms/frame", flush=True)
    for name, fn in programs.items():  # after every timing: a profiler session slows launches
        a = device_activities(fn, dev)
        res[f"{name}_activities_per_frame"] = None if a is None else a / nC
    res["tracking_delta_ms"] = 1e3 * (secs["B_fe_track"] - secs["A_frontend"]) / nC
    res["dense_delta_ms"] = 1e3 * (secs["C_full"] - secs["B_fe_track"]) / nC
    res["chunk"], res["frames"] = C, nC
    t_c = last["C_full"].cpu().numpy()
    res["checksums"] = {name: float(torch.sum(v)) for name, v in last.items()}
    res["weights"] = src
    res["C_ate_raw_m"] = float(ate_mod.compute_ate(d0["timestamps"], t_c, d0["timestamps"],
                                                   d0["t"], with_scale=False).rmse)
    res["C_t"] = t_c.tolist()
    return res


if __name__ == "__main__":
    main()
