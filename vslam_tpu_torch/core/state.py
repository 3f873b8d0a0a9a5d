"""SLAM state containers: fixed-capacity, masked NamedTuples of tensors.

Port of `vslam_tpu/core/state.py:21-259`: the same classes, field names,
shapes and dtypes (descriptors bf16, counters int32, masks bool, geometry
f32). `to_numpy` / `from_numpy` carry a state between the two packages
leaf by leaf; bf16 leaves cross as uint16 bit views (numpy has no bf16).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vslam_tpu_torch.ops.ekf import EKFState


class FrameFeatures(NamedTuple):
    """Per-frame inputs to the tracking step."""

    xy: torch.Tensor  # (K, 2) keypoint pixels
    desc: torch.Tensor  # (K, D) unit descriptors
    depth: torch.Tensor  # (K,) sensor depth at keypoint, 0 = invalid
    valid: torch.Tensor  # (K,) detection mask
    timestamp: torch.Tensor  # () f32
    stationary: torch.Tensor  # () bool
    frame_id: torch.Tensor  # () int32


class KeyframeStore(NamedTuple):
    """Keyframe ring buffer (capacity KFC) for loop closure + PGO."""

    xy: torch.Tensor  # (KFC, K, 2)
    desc: torch.Tensor  # (KFC, K, D)
    depth: torch.Tensor  # (KFC, K)
    kp_valid: torch.Tensor  # (KFC, K)
    R: torch.Tensor  # (KFC, 3, 3) camera-to-world
    t: torch.Tensor  # (KFC, 3)
    R_anchor: torch.Tensor  # (KFC, 3, 3) tracked pose at registration
    t_anchor: torch.Tensor  # (KFC, 3)
    frame_id: torch.Tensor  # (KFC,) int32
    valid: torch.Tensor  # (KFC,)


class MapStore(NamedTuple):
    """Fixed-capacity map points with visible/found culling counters."""

    pos: torch.Tensor  # (M, 3)
    desc: torch.Tensor  # (M, D)
    valid: torch.Tensor  # (M,)
    visible: torch.Tensor  # (M,) int32
    found: torch.Tensor  # (M,) int32
    first_kf: torch.Tensor  # (M,) int32
    num_obs: torch.Tensor  # (M,) int32


class LoopConstraints(NamedTuple):
    """Accumulated loop-closure constraints for PGO."""

    kf_from: torch.Tensor  # (L,) int32
    kf_to: torch.Tensor  # (L,) int32
    from_id: torch.Tensor  # (L,) int32
    to_id: torch.Tensor  # (L,) int32
    R_rel: torch.Tensor  # (L, 3, 3)
    t_rel: torch.Tensor  # (L, 3)
    valid: torch.Tensor  # (L,)


class TrackState(NamedTuple):
    """Full tracking state carried from frame to frame."""

    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)
    ekf: EKFState
    kf_xy: torch.Tensor  # (K, 2)
    kf_desc: torch.Tensor  # (K, D)
    kf_depth: torch.Tensor  # (K,)
    kf_valid: torch.Tensor  # (K,)
    kf_R: torch.Tensor  # (3, 3)
    kf_t: torch.Tensor  # (3,)
    kf_frame_id: torch.Tensor  # () int32
    prev_xy: torch.Tensor  # (K, 2)
    prev_desc: torch.Tensor  # (K, D) bf16
    prev_depth: torch.Tensor  # (K,)
    prev_valid: torch.Tensor  # (K,)
    prev_R: torch.Tensor  # (3, 3)
    prev_t: torch.Tensor  # (3,)
    prev_frame_id: torch.Tensor  # () int32 (-1 = none)
    keyframes: KeyframeStore
    map: MapStore
    loops: LoopConstraints
    frame_idx: torch.Tensor  # () int32
    kf_count: torch.Tensor  # () int32
    last_time: torch.Tensor  # () f32
    last_scale: torch.Tensor  # () f32
    recovery_cooldown: torch.Tensor  # () int32
    tracking_ok: torch.Tensor  # () bool
    was_stationary: torch.Tensor  # () bool
    gravity: torch.Tensor  # (3,)
    initial_height: torch.Tensor  # ()
    has_height: torch.Tensor  # () bool
    inrun_corrections: torch.Tensor = None  # () int32


class StepOutputs(NamedTuple):
    """Per-frame outputs (poses, EKF snapshots, diagnostics)."""

    R: torch.Tensor
    t: torch.Tensor
    timestamp: torch.Tensor
    x_pred: torch.Tensor
    P_pred: torch.Tensor
    x_filt: torch.Tensor
    P_filt: torch.Tensor
    dt: torch.Tensor
    num_matches: torch.Tensor
    num_inliers: torch.Tensor
    num_tracked: torch.Tensor
    is_keyframe: torch.Tensor
    used_3d3d: torch.Tensor
    tracking_ok: torch.Tensor
    epi_before: torch.Tensor
    epi_after: torch.Tensor
    bridged: torch.Tensor
    recovered: torch.Tensor
    num_depth_ok: torch.Tensor


def init_state(config, R0=None, t0=None, gravity=None, initial_height=0.0,
               device="cuda") -> TrackState:
    """Initial state (`vslam_tpu.core.state.init_state`) on `device`."""
    K = config.frontend.max_keypoints
    D = config.frontend.descriptor_dim
    M = config.map.map_capacity
    KFC = config.map.keyframe_capacity
    L = config.opt.max_loop_constraints
    dev = torch.device(device)
    f32, i32, bf16, b = torch.float32, torch.int32, torch.bfloat16, torch.bool

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=dev)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    eye = torch.eye(3, dtype=f32, device=dev)
    R0 = eye.clone() if R0 is None else torch.as_tensor(R0, dtype=f32, device=dev)
    t0 = z(3) if t0 is None else torch.as_tensor(t0, dtype=f32, device=dev)
    has_g = gravity is not None
    gravity = z(3) if gravity is None else torch.as_tensor(gravity, dtype=f32, device=dev)
    return TrackState(
        R=R0.clone(), t=t0.clone(),
        ekf=EKFState(x=z(6), P=torch.eye(6, dtype=f32, device=dev),
                     initialized=scalar(False, b), last_time=scalar(0.0, f32)),
        kf_xy=z(K, 2), kf_desc=z(K, D, dtype=bf16), kf_depth=z(K), kf_valid=z(K, dtype=b),
        kf_R=R0.clone(), kf_t=t0.clone(), kf_frame_id=scalar(-1, i32),
        prev_xy=z(K, 2), prev_desc=z(K, D, dtype=bf16), prev_depth=z(K),
        prev_valid=z(K, dtype=b), prev_R=R0.clone(), prev_t=t0.clone(),
        prev_frame_id=scalar(-1, i32),
        keyframes=KeyframeStore(
            xy=z(KFC, K, 2), desc=z(KFC, K, D, dtype=bf16), depth=z(KFC, K),
            kp_valid=z(KFC, K, dtype=b), R=eye.expand(KFC, 3, 3).clone(), t=z(KFC, 3),
            R_anchor=eye.expand(KFC, 3, 3).clone(), t_anchor=z(KFC, 3),
            frame_id=full((KFC,), -1, i32), valid=z(KFC, dtype=b),
        ),
        map=MapStore(
            pos=z(M, 3), desc=z(M, D, dtype=bf16), valid=z(M, dtype=b),
            visible=z(M, dtype=i32), found=z(M, dtype=i32), first_kf=z(M, dtype=i32),
            num_obs=z(M, dtype=i32),
        ),
        loops=LoopConstraints(
            kf_from=full((L,), -1, i32), kf_to=full((L,), -1, i32),
            from_id=full((L,), -1, i32), to_id=full((L,), -1, i32),
            R_rel=eye.expand(L, 3, 3).clone(), t_rel=z(L, 3), valid=z(L, dtype=b),
        ),
        frame_idx=scalar(0, i32), kf_count=scalar(0, i32), last_time=scalar(0.0, f32),
        last_scale=scalar(config.motion.motion_scale, f32),
        recovery_cooldown=scalar(0, i32), tracking_ok=scalar(True, b),
        was_stationary=scalar(False, b), gravity=gravity,
        initial_height=scalar(float(initial_height), f32), has_height=scalar(has_g, b),
        inrun_corrections=scalar(0, i32),
    )


def _is_tree(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_numpy(tree):
    """Tensors -> numpy copies, leaf by leaf (bf16 leaves as uint16 bit
    views). Copies, so that a later in-place update of the state (the
    keyframe ring, see `core.tracking`) leaves them as they were."""
    if _is_tree(tree):
        return type(tree)(*(to_numpy(v) for v in tree))
    if tree is None:
        return None
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def from_numpy(tree, device="cuda"):
    """numpy (or array-like) tree -> tensors on `device`. uint16 leaves,
    and numpy bf16 leaves, become bf16 tensors bit for bit."""
    if _is_tree(tree):
        return type(tree)(*(from_numpy(v, device) for v in tree))
    if tree is None:
        return None
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def clone_tree(tree):
    """Deep copy of a state tree (tensors cloned)."""
    if _is_tree(tree):
        return type(tree)(*(clone_tree(v) for v in tree))
    return None if tree is None else tree.clone()


def copy_to(tree, device):
    """A copy of a state tree on `device`, so that in-place updates of the
    copy (the keyframe ring) leave the tree as it was."""
    if _is_tree(tree):
        return type(tree)(*(copy_to(v, device) for v in tree))
    return None if tree is None else tree.to(device).clone()


def contiguous_tree(tree):
    """Every leaf contiguous (a no-op for leaves that are). Small products
    round by the layout of their operands, so a state carried in one
    layout tracks bit for bit like the same state carried in another."""
    if _is_tree(tree):
        return type(tree)(*(contiguous_tree(v) for v in tree))
    return None if tree is None else tree.contiguous()


def member(tree, b: int):
    """Member b of a tree whose leaves carry a leading batch dimension.
    The leaves are views, so an in-place write to one (the keyframe ring)
    lands in the batched storage."""
    if _is_tree(tree):
        return type(tree)(*(member(v, b) for v in tree))
    return None if tree is None else tree[b]


def stack_trees(trees):
    """Trees of one structure stacked along a new leading dimension
    (copies)."""
    first = trees[0]
    if _is_tree(first):
        return type(first)(*(stack_trees(list(f)) for f in zip(*trees)))
    return None if first is None else torch.stack(list(trees))
