"""Per-component latency and kernel launches of the batched tracking step.

The port of `scripts/bench_batched_step.py`. B members are warmed up on
their own 64-frame synthetic worlds of 6,000 landmarks (so their maps
differ); then it times, on the last frame of each world:

  * the full batched step (`tracking_batched.tracking_step_batched`),
    the state threaded from iteration to iteration, at each B in `--bs`
    up to `--b`;
  * each component the JAX script times, at B: keyframe match, F-gate,
    3D-3D RANSAC, EKF fuse, local-map tracking (member by member and
    batched: one radius-kernel launch for all members), GN-PnP refine,
    make-keyframe, and a carry-touch (every state leaf read and written).

A time is the median of 3 runs of `--n` iterations, divided by `--n`:
CUDA events on the card (the stream's time from the first launch of a
run to the end of its last, host gaps included), the host clock on the
CPU. Beside each time it gives the component's device activities per
iteration (kernels, copies and fills: `torch.profiler`, CUDA activity
only, one iteration, after all the timings), the split by op of the
step's launch cost; on the CPU there is none to count (null).

Usage: python -m vslam_tpu_torch.apps.bench_batched_step [--cpu] [--n 256]
       [--b 4] [--bs 1,2,4,8] [--only pat]
"""

from __future__ import annotations

import argparse
import json

import torch

from vslam_tpu_torch.utils.profiling import bench_device, device_activities, seconds_per_iter


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--n", type=int, default=256, help="iterations per timed run")
    ap.add_argument("--b", type=int, default=4, help="batch size")
    ap.add_argument("--only", type=str, default="", help="substring filter")
    ap.add_argument("--bs", type=str, default="1,2,4,8",
                    help="batch sizes for the full-step sweep (those up to --b)")
    return ap.parse_args(argv)


def main(argv=None):
    from vslam_tpu_torch.config import SlamConfig

    out = run(parse_args(argv), SlamConfig())
    print(json.dumps(out))
    return out


def _head(tree, n):
    """The first n members of a batched state or frame tree."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_head(v, n) for v in tree))
    return None if tree is None else tree[:n]


def run(args, cfg):
    """The bench on parsed `args` with config `cfg`. Returns {"device",
    "B", "N", "map_rows", "us_per_iter": {component: us},
    "launches_per_iter": {component: count or None}}."""
    from vslam_tpu_torch.core import pipeline, tracking as T, tracking_batched as TB
    from vslam_tpu_torch.core.state import clone_tree, init_state, member, stack_trees
    from vslam_tpu_torch.data import synthetic
    from vslam_tpu_torch.ops import prng
    from vslam_tpu_torch.ops.linalg import f32_matmuls
    from vslam_tpu_torch.utils.cache import enable_persistent_cache

    dev = bench_device(args, "bench_batched_step")
    enable_persistent_cache()
    c = cfg.camera
    N, B = args.n, args.b

    def warm_state(seed):
        seq = synthetic.make_sequence(
            num_frames=64, max_keypoints=cfg.frontend.max_keypoints,
            desc_dim=cfg.frontend.descriptor_dim, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
            width=c.width, height=c.height, seed=seed, num_landmarks=6000)
        frames = pipeline.features_from_synthetic(seq, device=dev)
        st, _ = T.run_frames(init_state(cfg, device=dev), frames, frames.frame_id.tolist(), cfg)
        return st, T.frame_at(frames, frames.timestamp.shape[0] - 1)

    singles = [warm_state(s) for s in range(B)]
    states = stack_trees([s for s, _ in singles])
    frame = stack_trees([f for _, f in singles])
    frame = frame._replace(desc=frame.desc.to(states.kf_desc.dtype))
    map_rows = [int(x) for x in states.map.valid.sum(-1).tolist()]
    print(f"device={dev}  B={B}  map={map_rows}  N={N}")
    keys = [prng.fold_in(prng.prng_key(7), i) for i in range(B)]
    sts = [member(states, b) for b in range(B)]
    frs = [member(frame, b) for b in range(B)]
    true = torch.tensor(True, device=dev)

    cases = {}

    def case(name):
        def add(fn):
            if not args.only or any(p in name for p in args.only.split(",")):
                cases[name] = fn
            return fn
        return add

    for Bx in [int(x) for x in args.bs.split(",") if x]:
        if Bx > B:
            continue
        carry = {"st": clone_tree(_head(states, Bx))}
        frx = _head(frame, Bx)

        @case(f"full batched step B={Bx} (threaded)")
        def full(carry=carry, frx=frx, Bx=Bx):
            carry["st"], _ = TB.tracking_step_batched(carry["st"], frx, cfg, keys[:Bx])

    m0 = [T._match_to_keyframe(s, f, cfg, k) for s, f, k in zip(sts, frs, keys)]
    lm0 = [T._track_local_map(s, f, cfg, s.R, s.t) for s, f in zip(sts, frs)]

    @case(f"match_to_keyframe B={B}")
    def kf_match():
        for s, f, k in zip(sts, frs, keys):
            T._match_to_keyframe(s, f, cfg, k)

    @case(f"fundamental_gate B={B}")
    def fgate():
        for (_, ukf, ucur, g, _), k in zip(m0, keys):
            T._fundamental_gate(ukf, ucur, g, cfg, k)

    @case(f"3d3d RANSAC B={B}")
    def r3d():
        for s, f, (mm, ukf, ucur, g, _), k in zip(sts, frs, m0, keys):
            T._motion_3d3d(s, f, cfg, mm, ukf, ucur, g, k)

    @case(f"fuse_ekf B={B}")
    def ekf():
        for s, f in zip(sts, frs):
            T._fuse_ekf(s, f, cfg, s.t, true, true)

    @case(f"track_local_map per member B={B}")
    def local_map():
        for s, f in zip(sts, frs):
            T._track_local_map(s, f, cfg, s.R, s.t)

    @case(f"batched track_local_map B={B}")
    def local_map_batched():
        T._track_local_maps(sts, frs, cfg, [s.R for s in sts], [s.t for s in sts])

    @case(f"refine_pnp B={B}")
    def gn():
        for s, f, (mi, ko, _), k in zip(sts, frs, lm0, keys):
            T._refine_pnp(s, f, cfg, s.R, s.t, mi, ko, k)

    kf_sts = [member(clone_tree(states), b) for b in range(B)]  # written in place

    @case(f"make_keyframe B={B}")
    def mkkf():
        for s, f, (mm, _, _, g, _) in zip(kf_sts, frs, m0):
            T._make_keyframe(s, f, cfg, s.R, s.t, mm, g)

    @case(f"carry-touch only B={B}")
    def carry_only():
        clone_tree(states)

    us, launches = {}, {}
    with f32_matmuls():
        for name, fn in cases.items():
            us[name] = seconds_per_iter(fn, N, dev) * 1e6
            per = f"  ({us[name] / int(name.split('B=')[1].split()[0]):7.1f} us/frame)" \
                if name.startswith("full") else ""
            print(f"{name:40s} {us[name]:10.1f} us/iter{per}")
        for name, fn in cases.items():  # after every timing: a profiler session slows launches
            launches[name] = device_activities(fn, dev)
    print("launches per iteration: " + json.dumps(launches))
    return {"device": str(dev), "B": B, "N": N, "map_rows": map_rows, "us_per_iter": us,
            "launches_per_iter": launches}


if __name__ == "__main__":
    main()
