"""End-to-end pipeline: uint8 frames in, trajectory out.

Port of phase 1 of `vslam_tpu/core/coupled.py:42-169` (`run_coupled`):

  per chunk of C frames:
    uint8 gray  -> normalize -> SuperPoint (batched over the chunk)
                -> softmax/d2s decode + NMS + top-K + descriptor sampling
    uint16 depth -> meters -> keypoint depth gather
    -> the tracking step over the chunk's frames, one at a time

Not ported yet, and refused rather than skipped: dense voxel fusion
(phase 2; `dense` must be None), the in-run pose-graph correction after a
chunk accepts a new loop constraint (`config.opt.inrun_pgo`), and the
DepthNet keypoint-depth fill (`depth_params`).
"""

from __future__ import annotations

import torch

from vslam_tpu_torch.config import SlamConfig
from vslam_tpu_torch.core import frontend as fe
from vslam_tpu_torch.core import tracking
from vslam_tpu_torch.core.state import StepOutputs, TrackState, clone_tree


def _to(tree, device):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, device) for v in tree))
    return None if tree is None else tree.to(device)


def run_coupled(
    model,
    state: TrackState,
    dense,
    gray,        # (S, C, H, W) uint8
    depth_u16,   # (S, C, H, W) integer depth (value / depth_scale = meters)
    rgb,         # unused until dense fusion is ported (colors feed it only)
    timestamps,  # (S, C) f32
    frame_ids,   # (S, C) int32
    stationary,  # (S, C) bool
    config: SlamConfig,
    seed: int = 42,
    depth_params=None,
    device="cuda",
):
    """Run frontend + tracking over S chunks of C frames on `device`.

    `model` is a `models.superpoint.SuperPoint` (see
    `models.weights.load_superpoint`). The state handed in is copied, not
    modified. Returns (final TrackState, None, StepOutputs stacked
    (S*C, ...)); the None stands where the JAX package returns the dense
    map.
    """
    if dense is not None:
        raise NotImplementedError("dense voxel fusion is not ported yet: pass dense=None")
    if depth_params is not None:
        raise NotImplementedError("DepthNet keypoint depth is not ported yet")
    dev = torch.device(device)
    st = clone_tree(_to(state, dev))
    gray, depth_u16 = gray.to(dev), depth_u16.to(dev)
    timestamps, frame_ids, stationary = timestamps.to(dev), frame_ids.to(dev), stationary.to(dev)
    ids_host = frame_ids.cpu().tolist()
    outs = []
    for s in range(gray.shape[0]):
        frames = fe.frontend_features(
            model, gray[s], depth_u16[s], timestamps[s], frame_ids[s], stationary[s], config
        )
        n_loops0 = torch.sum(st.loops.valid)
        st, out = tracking.run_frames(st, frames, ids_host[s], config, seed)
        outs.append(out)
        if config.opt.inrun_pgo and tracking._cond(torch.sum(st.loops.valid) > n_loops0):
            raise NotImplementedError(
                "a chunk accepted a new loop constraint and in-run PGO "
                "(config.opt.inrun_pgo) is not ported yet"
            )
    return st, None, StepOutputs(*(torch.cat(f) for f in zip(*outs)))
