"""Shared set-up of the benchmark's CPU tests: a cell's spec cut to a
size the CPU runs in seconds (the card runs the cells as written)."""

import copy

import pytest
import torch

from slam_bench import registry

torch.set_num_threads(2)


def tiny(cell: str, frames: int = 48, scale: int = 1) -> dict:
    """`registry.cell(cell)` at 160x120, K 64, small maps, `frames`
    frames of a 600-landmark world in chunks of 8; `scale` 2 doubles the
    image side and the keypoints (1,500 landmarks), where every stream
    tracks."""
    spec = copy.deepcopy(registry.cell(cell))
    s = spec["config"]["slam"]
    k = scale
    s["camera"].update(width=160 * k, height=120 * k, fx=120.0 * k, fy=120.0 * k,
                       cx=80.0 * k - 0.5, cy=60.0 * k - 0.5)
    s["frontend"]["max_keypoints"] = 64 * k
    s["map"] = {"map_capacity": 512 * k * k, "keyframe_capacity": 16}
    s["dense"].update(hash_capacity=4096, cloud_capacity=4096)
    s["motion"] = {"em_ransac_iters": 32, "fm_ransac_iters": 32, "r3d_iters": 32}
    s["pnp"] = {"ransac_iters": 32}
    spec["config"]["sequence_frames"] = frames
    t = spec["traffic"]
    t["num_landmarks"] = 600 if scale == 1 else 1500
    if t["frames_per_call"] > 1:
        t["frames_per_call"], t["chunk"] = frames, 8
    t["warmup_frames"] = t["profile_frames"] = 8
    return spec


@pytest.fixture
def tiny_spec():
    return tiny
