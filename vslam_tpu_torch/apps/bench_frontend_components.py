"""The frontend's latency by stage.

The port of `scripts/bench_frontend_components.py`: on `--chunks` chunks
of `--batch` random uint8 frames at the config's resolution, with a
bf16 SuperPoint of random parameters (`superpoint.init_params(seed=0)`,
as the JAX script's `init_params(PRNGKey(0))`), it times per frame

  * the conv backbone and heads (`models.superpoint.SuperPoint`);
  * softmax, depth-to-space and window NMS (`ops.nms.decode_heatmap`,
    `nms_local_max`);
  * the tiled top-k (`nms.topk_keypoints`);
  * bilinear descriptor sampling (`nms.sample_descriptors`);
  * the full extract (SuperPoint and `nms.extract_keypoints`).

The decode, top-k and sampling stages run on the first chunk's outputs,
once per chunk. Each run's inputs depend on a carry scalar on the device
that the previous chunk's result updates, as in the JAX script's scan. A
time is the median of 3 runs over all chunks, per frame
(`utils.profiling.seconds_per_iter`: CUDA events on the card, the host
clock on the CPU); beside it the stage's device activities per frame
(`torch.profiler`, CUDA activity only; null on the CPU).

Usage: python -m vslam_tpu_torch.apps.bench_frontend_components [--cpu]
       [--batch 32] [--chunks 8]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from vslam_tpu_torch.utils.profiling import bench_device, device_activities, seconds_per_iter


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--chunks", type=int, default=8)
    return ap.parse_args(argv)


def main(argv=None):
    from vslam_tpu_torch.config import SlamConfig

    out = run(parse_args(argv), SlamConfig())
    print(json.dumps(out))
    return out


def random_frames(args, cfg, dev):
    """(chunks, batch, H, W) random uint8 frames, seeded as the JAX
    script's."""
    c = cfg.camera
    imgs = np.random.default_rng(0).integers(0, 255, (args.chunks, args.batch, c.height, c.width),
                                             dtype=np.uint8)
    return torch.from_numpy(imgs).to(dev)


def run(args, cfg):
    """The bench on parsed `args` with config `cfg`. Returns {"device",
    "batch", "chunks", "us_per_frame": {stage: us}, "fps": {stage: frames
    per s}, "activities_per_frame": {stage: count or None}}."""
    from vslam_tpu_torch.models import superpoint as sp
    from vslam_tpu_torch.ops import camera, nms

    dev = bench_device(args, "bench_frontend_components")
    fc = cfg.frontend
    B, C = args.batch, args.chunks
    model = sp.SuperPoint(device=dev)
    model.load_state_dict(sp.init_params(seed=0))
    model.eval()
    imgs = random_frames(args, cfg, dev)
    print(f"device={dev}  batch={B} chunks={C}")
    carry = {"cr": torch.zeros((), dtype=torch.float32, device=dev)}

    def images(x):
        return camera.unit_gray(x)[..., None] + 0.0 * carry["cr"]

    def scanned(chunk_fn):
        """chunk_fn(chunk) -> value, over every chunk; the carry follows."""
        def prog():
            for x in imgs:
                carry["cr"] = chunk_fn(x) * 1e-9 + carry["cr"] * 0.5
        return prog

    with torch.no_grad():
        semi0, desc0 = model(camera.unit_gray(imgs[0])[..., None])
        heat0 = nms.nms_local_max(nms.decode_heatmap(semi0), radius=fc.sp_nms_radius,
                                  conf_threshold=fc.sp_confidence_threshold)
        kp0 = nms.topk_keypoints(heat0, max_keypoints=fc.max_keypoints)

    def conv_only(x):
        semi, _ = model(images(x))
        return torch.sum(semi[..., 0])

    def decode_only(x):
        heat = nms.nms_local_max(nms.decode_heatmap(semi0 + carry["cr"] * 1e-9),
                                 radius=fc.sp_nms_radius,
                                 conf_threshold=fc.sp_confidence_threshold)
        return torch.sum(heat)

    def topk_only(x):
        kps = nms.topk_keypoints(heat0 + carry["cr"] * 1e-12, max_keypoints=fc.max_keypoints)
        return torch.sum(kps.score)

    def sample_only(x):
        return torch.sum(nms.sample_descriptors(desc0, kp0.xy + carry["cr"] * 1e-9, kp0.valid))

    def full(x):
        semi, desc_c = model(images(x))
        kps, desc = nms.extract_keypoints(semi, desc_c, max_keypoints=fc.max_keypoints,
                                          radius=fc.sp_nms_radius,
                                          conf=fc.sp_confidence_threshold)
        return torch.sum(kps.score) + torch.sum(desc) * 1e-6

    stages = {name: scanned(fn) for name, fn in (
        ("conv backbone + heads", conv_only), ("softmax+d2s+window NMS", decode_only),
        ("tiled top-k", topk_only), ("bilinear desc sampling", sample_only),
        ("FULL extract pipeline", full))}
    us, acts = {}, {}
    with torch.no_grad():
        for name, prog in stages.items():
            us[name] = seconds_per_iter(prog, 1, dev) / (B * C) * 1e6
            print(f"{name:34s} {us[name]:9.1f} us/frame  ({1e6 / us[name]:8.1f} fps)", flush=True)
        for name, prog in stages.items():  # after every timing: a profiler session slows launches
            a = device_activities(prog, dev)
            acts[name] = None if a is None else a / (B * C)
    return {"device": str(dev), "batch": B, "chunks": C, "us_per_frame": us,
            "fps": {k: 1e6 / v for k, v in us.items()}, "activities_per_frame": acts}


if __name__ == "__main__":
    main()
