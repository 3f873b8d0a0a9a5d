"""The SuperPoint backbone's latency layer by layer.

The port of `scripts/bench_conv_layers.py`: it times cumulative prefixes
of the conv plan (`conv1a` ... `conv4b`, then the detector head
`convPa+Pb` and the descriptor head `convDa+Db`, each on the `conv4b`
output) in bf16 on `--chunks` chunks of `--batch` random uint8 frames at
the config's resolution, with random parameters
(`superpoint.init_params(seed=0)`), and takes differences to give each
layer's cost (a layer followed by a 2x2 max pool carries the pool).
Beside each layer's time stand its FLOPs, 2 * H * W * C_in * C_out * k^2
per frame at the layer's resolution (two convolutions for a head), and
its TFLOP/s against the H100's 989 dense bf16 peak.

A prefix's time is the median of 3 runs over all chunks, per frame
(`utils.profiling.seconds_per_iter`: CUDA events on the card, the host
clock on the CPU), each chunk's input depending on a carry scalar on the
device as in the JAX script's scan; beside it its device activities per
frame (`torch.profiler`, CUDA activity only; null on the CPU).

Usage: python -m vslam_tpu_torch.apps.bench_conv_layers [--cpu]
       [--batch 32] [--chunks 8]
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from vslam_tpu_torch.utils.profiling import bench_device, device_activities, seconds_per_iter

H100_BF16_TFLOPS = 989.0

# The layer plan of `SuperPoint.forward`: (step, its convs, 2x2 pool after).
PLAN = (
    ("conv1a", ("conv1a",), False), ("conv1b", ("conv1b",), True),
    ("conv2a", ("conv2a",), False), ("conv2b", ("conv2b",), True),
    ("conv3a", ("conv3a",), False), ("conv3b", ("conv3b",), True),
    ("conv4a", ("conv4a",), False), ("conv4b", ("conv4b",), False),
    ("convPa+Pb", ("convPa", "convPb"), False), ("convDa+Db", ("convDa", "convDb"), False),
)


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


def layer_flops(height: int, width: int) -> dict:
    """FLOPs per frame of each PLAN step (2 * H * W * C_in * C_out * k^2
    per convolution at its input resolution, stride 1)."""
    from vslam_tpu_torch.models.superpoint import LAYERS

    shape = {name: (cin, cout, k) for name, cin, cout, k in LAYERS}
    out, h, w = {}, height, width
    for step, convs, pool in PLAN:
        out[step] = sum(2 * h * w * shape[n][0] * shape[n][1] * shape[n][2] ** 2 for n in convs)
        if pool:
            h, w = h // 2, w // 2
    return out


def run(args, cfg):
    """The bench on parsed `args` with config `cfg`. Returns {"device",
    "batch", "chunks", "prefix_us_per_frame": {step: us through it},
    "prefix_activities_per_frame": {step: count or None},
    "layer_us_per_frame": {step: its difference}, "layer_flops_per_frame",
    "layer_tflops": {step: TFLOP/s, None where the difference is not
    positive}, "peak_tflops": 989}."""
    from vslam_tpu_torch.apps.bench_frontend_components import random_frames
    from vslam_tpu_torch.models import superpoint as sp
    from vslam_tpu_torch.ops import camera

    dev = bench_device(args, "bench_conv_layers")
    c = cfg.camera
    B, C = args.batch, args.chunks
    model = sp.SuperPoint(device=dev)
    model.load_state_dict(sp.init_params(seed=0))
    imgs = random_frames(args, cfg, dev)
    dt = model.compute_dtype
    print(f"device={dev}  batch={B} chunks={C}")
    carry = {"cr": torch.zeros((), dtype=torch.float32, device=dev)}

    def prefix(n_steps):
        def chunk(x_u8):
            x = camera.unit_gray(x_u8)[:, None].to(dt) + (carry["cr"] * 1e-20).to(dt)
            acc = torch.zeros((), dtype=torch.float32, device=dev)
            for step, convs, pool in PLAN[:n_steps]:
                if len(convs) == 2:  # a head, on the conv4b output
                    y = model._conv(F.relu(model._conv(x, convs[0])), convs[1])
                    acc = acc + torch.sum(y, dtype=torch.float32)
                else:
                    x = F.relu(model._conv(x, convs[0]))
                    if pool:
                        x = F.max_pool2d(x, 2, 2)
            return acc + torch.sum(x, dtype=torch.float32)

        def prog():
            for x in imgs:
                carry["cr"] = chunk(x) * 1e-20 + carry["cr"] * 0.5
        return prog

    progs = {step: prefix(i + 1) for i, (step, _, _) in enumerate(PLAN)}
    thru, acts = {}, {}
    with torch.no_grad():
        prev = 0.0
        for step, prog in progs.items():
            thru[step] = seconds_per_iter(prog, 1, dev) / (B * C) * 1e6
            print(f"thru {step:10s} {thru[step]:9.1f} us/frame  (+{thru[step] - prev:7.1f})",
                  flush=True)
            prev = thru[step]
        for step, prog in progs.items():  # after every timing: a profiler session slows launches
            a = device_activities(prog, dev)
            acts[step] = None if a is None else a / (B * C)
    steps = list(thru)
    layer = {s: thru[s] - (thru[steps[i - 1]] if i else 0.0) for i, s in enumerate(steps)}
    flops = layer_flops(c.height, c.width)
    return {"device": str(dev), "batch": B, "chunks": C, "prefix_us_per_frame": thru,
            "prefix_activities_per_frame": acts, "layer_us_per_frame": layer,
            "layer_flops_per_frame": flops,
            "layer_tflops": {s: flops[s] / (layer[s] * 1e-6) / 1e12 if layer[s] > 0 else None
                             for s in steps},
            "peak_tflops": H100_BF16_TFLOPS}


if __name__ == "__main__":
    main()
