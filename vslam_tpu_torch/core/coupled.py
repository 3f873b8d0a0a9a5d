"""End-to-end pipeline: uint8 frames in, trajectory and dense cloud out.

Port of `vslam_tpu/core/coupled.py` (`run_coupled`, `run_coupled_batched`):

  phase 1, per chunk of C frames:
    uint8 gray  -> normalize -> SuperPoint (batched over the chunk)
                -> softmax/d2s decode + NMS + top-K + descriptor sampling
    uint16 depth -> meters -> keypoint depth gather
                 (with `depth_params`, a DepthNet: keypoints without
                 sensor depth take the net's predicted depth)
    -> the tracking step over the chunk's frames, one at a time
    -> when the chunk accepted a new loop constraint, the in-run
       pose-graph correction (`core.pipeline.inrun_pgo_correct`,
       `config.opt.inrun_pgo`)
  phase 2: dense voxel fusion of every chunk at the poses phase 1
    estimated (`ops.gridhash.fuse_chunk_scan`)

The multi-sequence entry point has no in-run correction and no
`depth_params`, as in the JAX package.

Spans (`utils.profiling.span`, no-ops while its recorder is off): `entry`
around each call, with `entry.copy` (the copies of the state and dense
map, the inputs' moves to the device, the frame ids' read to the host),
`frontend` and `track` per chunk (`track_chunk`'s `pgo` and the tracking
step's spans inside), and `fuse` per chunk and member.
"""

from __future__ import annotations

import math

import torch

from vslam_tpu_torch.config import SlamConfig
from vslam_tpu_torch.core import frontend as fe
from vslam_tpu_torch.core import pipeline
from vslam_tpu_torch.core import tracking_batched
from vslam_tpu_torch.core.state import (
    FrameFeatures,
    StepOutputs,
    TrackState,
    copy_to,
    member,
    stack_trees,
)
from vslam_tpu_torch.ops import gridhash
from vslam_tpu_torch.utils import profiling


def _check_dense(dense):
    if not isinstance(dense, gridhash.DenseMapState):
        raise TypeError("run_coupled fuses into a dense map: pass a gridhash.DenseMapState "
                        f"(gridhash.init_dense_map), not {type(dense).__name__}")


def fuse_chunk(dense, depth_u16, rgb, R, t, config: SlamConfig, chunk: int):
    """Phase 2 for one chunk: dense fusion of C frames (depth (C, H, W)
    integer, rgb (C, H, W, 3) or None) at poses R (C, 3, 3), t (C, 3), as
    the JAX package's `run_coupled` fuses a chunk of `chunk` frames.
    Writes `dense` in place and returns it."""
    c, dn = config.camera, config.dense
    depth_m = fe.depth_meters(depth_u16, c.depth_scale)
    return gridhash.fuse_chunk_scan(
        dense, depth_m, rgb, R, t, c.fx, c.fy, c.cx, c.cy,
        pixel_step=dn.pixel_step, max_depth=dn.max_depth, voxel_size=dn.voxel_size,
        frames_per_step=math.gcd(chunk, dn.fuse_frames_per_insert),
    )


def run_coupled(
    model,
    state: TrackState,
    dense: gridhash.DenseMapState,
    gray,        # (S, C, H, W) uint8
    depth_u16,   # (S, C, H, W) integer depth (value / depth_scale = meters)
    rgb,         # (S, C, H, W, 3) uint8 or None (the cloud's colors)
    timestamps,  # (S, C) f32
    frame_ids,   # (S, C) int32
    stationary,  # (S, C) bool
    config: SlamConfig,
    seed: int = 42,
    depth_params=None,
    device="cuda",
):
    """Run frontend + tracking over S chunks of C frames, then fuse the
    dense cloud, on `device`.

    `model` is a `models.superpoint.SuperPoint` (see
    `models.weights.load_superpoint`). `depth_params`, a
    `models.depthnet.DepthNet` (`models.weights.load_depthnet`) or None:
    keypoints whose sensor depth is not above `camera.depth_min` take
    the net's depth, as the JAX package's `run_coupled(depth_params=...)`
    does; with all-zero depth this is the depth-assisted monocular mode.
    The state and the dense map handed in are copied, not modified.
    Returns (final TrackState, fused DenseMapState, StepOutputs stacked
    (S*C, ...)).
    """
    _check_dense(dense)
    dev = torch.device(device)
    S, C = gray.shape[:2]
    with profiling.span("entry", frames=S * C):
        with profiling.span("entry.copy"):
            st = copy_to(state, dev)
            dense = copy_to(dense, dev)
            gray, depth_u16 = gray.to(dev), depth_u16.to(dev)
            rgb = None if rgb is None else rgb.to(dev)
            timestamps, frame_ids = timestamps.to(dev), frame_ids.to(dev)
            stationary = stationary.to(dev)
            ids_host = frame_ids.cpu().tolist()
        outs = []
        for s in range(S):
            with profiling.span("frontend", frames=C, ids=ids_host[s]):
                frames = fe.frontend_features(
                    model, gray[s], depth_u16[s], timestamps[s], frame_ids[s], stationary[s],
                    config, depth_model=depth_params,
                )
            with profiling.span("track", frames=C, ids=ids_host[s]):
                st, out = pipeline.track_chunk(st, frames, ids_host[s], config, seed)
            outs.append(out)
        for s, out in enumerate(outs):
            rgb_s = None if rgb is None else rgb[s]
            with profiling.span("fuse", frames=C, ids=ids_host[s]):
                dense = fuse_chunk(dense, depth_u16[s], rgb_s, out.R, out.t, config, C)
        return st, dense, StepOutputs(*(torch.cat(f) for f in zip(*outs)))


def run_coupled_batched(
    model,
    states: TrackState,            # leaves (B, ...)
    dense: gridhash.DenseMapState,  # leaves (B, ...)
    gray,        # (S, C, B, H, W) uint8
    depth_u16,   # (S, C, B, H, W) integer depth
    timestamps,  # (S, C, B) f32
    frame_ids,   # (S, C, B) int32
    stationary,  # (S, C, B) bool
    config: SlamConfig,
    seed: int = 42,
    device="cuda",
):
    """Multi-sequence coupled pipeline: B independent streams on one card.

    Per chunk, the frontend runs once over its C*B frames, then the
    batched tracking step (`core.tracking_batched`) advances all B
    members frame by frame. Phase 2 fuses each member's dense map, without
    colors (as the JAX package does). States and maps handed in are
    copied, not modified. Returns (states, dense, StepOutputs with
    (S*C, B, ...) leaves).
    """
    _check_dense(dense)
    dev = torch.device(device)
    S, C, B = gray.shape[:3]
    with profiling.span("entry", frames=S * C * B):
        with profiling.span("entry.copy"):
            states = copy_to(states, dev)
            dense = copy_to(dense, dev)
            gray, depth_u16 = gray.to(dev), depth_u16.to(dev)
            timestamps, frame_ids = timestamps.to(dev), frame_ids.to(dev)
            stationary = stationary.to(dev)
            ids_host = frame_ids.cpu().tolist()
        outs = []
        for s in range(S):
            with profiling.span("frontend", frames=C * B, ids=ids_host[s]):
                flat = fe.frontend_features(
                    model, gray[s].flatten(0, 1), depth_u16[s].flatten(0, 1),
                    timestamps[s].flatten(), frame_ids[s].flatten(), stationary[s].flatten(),
                    config,
                )
                frames = FrameFeatures(*(x.unflatten(0, (C, B)) for x in flat))
            with profiling.span("track", frames=C * B, ids=ids_host[s]):
                states, out = tracking_batched.run_frames_batched(states, frames, ids_host[s],
                                                                  config, seed)
            outs.append(out)
        fused = []
        for b in range(B):
            d = member(dense, b)
            for s, out in enumerate(outs):
                with profiling.span("fuse", frames=C):
                    d = fuse_chunk(d, depth_u16[s, :, b], None, out.R[:, b], out.t[:, b],
                                   config, C)
            fused.append(d)
        return states, stack_trees(fused), StepOutputs(*(torch.cat(f) for f in zip(*outs)))
