"""Dense voxel fusion: the voxel-hash cloud that `run_coupled` accumulates.

Port of `vslam_tpu/ops/gridhash.py`: every Nth pixel of a depth frame
(<= max_depth) is back-projected to the world and kept iff its voxel is
new. The voxel set is a fixed-capacity open hash table on the device
(`table_winner`, one int32 per slot); a point whose slot holds another
voxel is dropped, as in the JAX package.

In place: `insert_points` (and so `fuse_chunk_scan`) writes the state's
winner table and cloud arrays in place and returns the state with its new
counters. `core.coupled` works on a copy of the map it is handed.

No host sync: the append offset `cloud_count` stays on the device (the
block of K rows is written at `cloud_count + arange(K)`, which the
81,920-row append scratch past the capacity always holds).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vslam_tpu_torch.ops.device import div_const

# Large primes for coordinate hashing (`vslam_tpu/ops/gridhash.py:25-27`).
_P1 = 73856093
_P2 = 19349663
_P3 = 83492791

# Empty-slot sentinel of the winner table: every real insert id is
# smaller, so a scatter-min claims a free slot.
_EMPTY = 2**31 - 1

# Rows past the reported cloud capacity: an insert writes its whole block
# of K rows at cloud_count <= capacity, so K may not exceed this.
_APPEND_SCRATCH = 81920


class DenseMapState(NamedTuple):
    table_winner: torch.Tensor  # (C,) int32: insert id of the slot's voxel, _EMPTY if free
    cloud_xyz: torch.Tensor  # (N + scratch, 3) f32; [:cloud_count] valid
    cloud_rgb: torch.Tensor  # (N + scratch, 3) uint8
    cloud_count: torch.Tensor  # () int32, <= reported capacity N
    insert_epoch: torch.Tensor  # () int32: candidates ever offered


def init_dense_map(hash_capacity: int, cloud_capacity: int, device="cuda") -> DenseMapState:
    """An empty map on `device` (8 MB of table, 13.6 MB of xyz and 3.4 MB
    of rgb at the default 2^21 slots and 2^20 points)."""
    dev = torch.device(device)
    rows = cloud_capacity + _APPEND_SCRATCH
    return DenseMapState(
        table_winner=torch.full((hash_capacity,), _EMPTY, dtype=torch.int32, device=dev),
        cloud_xyz=torch.zeros((rows, 3), dtype=torch.float32, device=dev),
        cloud_rgb=torch.zeros((rows, 3), dtype=torch.uint8, device=dev),
        cloud_count=torch.zeros((), dtype=torch.int32, device=dev),
        insert_epoch=torch.zeros((), dtype=torch.int32, device=dev),
    )


def dense_cloud_capacity(state: DenseMapState) -> int:
    """Reported capacity (the cloud arrays carry the append scratch past it)."""
    return state.cloud_xyz.shape[0] - _APPEND_SCRATCH


def voxel_coords(points, voxel_size):
    return torch.floor(div_const(points, voxel_size)).to(torch.int32)


def voxel_hash(coords, capacity):
    """int32 hash with wraparound, as `jnp` computes it: an int32 tensor
    times a Python int stays int32 and wraps, `*` binds before `^`,
    abs(INT_MIN) stays INT_MIN, and `remainder` floors like `%`."""
    h = coords[..., 0] * _P1 ^ coords[..., 1] * _P2 ^ coords[..., 2] * _P3
    return torch.remainder(torch.abs(h), capacity)


def insert_points(state: DenseMapState, points, colors, valid, voxel_size=0.02) -> DenseMapState:
    """Insert a batch of candidate points; only the first point of a new
    voxel survives. Within the batch the lowest index wins a slot (a
    scatter-min of monotone global insert ids); a point whose slot already
    holds another voxel is dropped. Winners are appended in batch order;
    past the capacity they are dropped. Writes the table and the cloud
    arrays in place."""
    C = state.table_winner.shape[0]
    N = dense_cloud_capacity(state)
    K = points.shape[0]
    if K > _APPEND_SCRATCH:
        raise ValueError(f"insert batch {K} exceeds append scratch {_APPEND_SCRATCH}; "
                         "split the batch (fuse_chunk_scan's frames_per_step does this)")
    dev = points.device
    slots = voxel_hash(voxel_coords(points, voxel_size), C).long()
    ar = torch.arange(K, dtype=torch.int32, device=dev)
    gid = state.insert_epoch + ar

    table = state.table_winner
    prev = table[slots]
    # An invalid point offers _EMPTY, which leaves any slot as it was: the
    # JAX package's mode="drop" write to an out-of-range slot.
    table.scatter_reduce_(0, slots, torch.where(valid, gid, _EMPTY), "amin", include_self=True)
    win = valid & (prev == _EMPTY) & (table[slots] == gid)

    # Sort-compact append: winners first, in batch (= insertion) order.
    perm = torch.argsort(torch.where(win, ar, K), stable=True)
    n_win = torch.sum(win, dtype=torch.int32)
    start = state.cloud_count
    rows = start.long() + torch.arange(K, device=dev)
    state.cloud_xyz.index_copy_(0, rows, points[perm])
    state.cloud_rgb.index_copy_(0, rows, colors[perm].to(torch.uint8))
    return state._replace(cloud_count=torch.clamp(start + n_win, max=N),
                          insert_epoch=state.insert_epoch + K)


def backproject_frame(depth, rgb, R, t, fx, fy, cx, cy, pixel_step=8, max_depth=5.0,
                      depth_min=0.1):
    """Back-project every Nth pixel of depth frames to world points.
    depth (..., H, W) meters, rgb (..., H, W, 3) uint8 or None, R (..., 3, 3),
    t (..., 3). Returns (points (..., n, 3), colors (..., n, 3) uint8,
    valid (..., n)) with n = (H/step) * (W/step).

    The rotation is applied as elementwise products and sums in a fixed
    order (not a matrix product), and the divisions by fx, fy multiply by
    their f32 reciprocals (`device.div_const`, as XLA rounds them), so that
    the CPU and the card round alike, bit for bit, and put a point in the
    same voxel."""
    H, W = depth.shape[-2:]
    dev = depth.device
    vs = torch.arange(0, H - H % pixel_step, pixel_step, device=dev)
    us = torch.arange(0, W - W % pixel_step, pixel_step, device=dev)
    lead = depth.shape[:-2]
    z = depth[..., vs[:, None], us[None, :]]
    valid = (z > depth_min) & (z <= max_depth)
    x = div_const(us.to(torch.float32)[None, :] - cx, fx) * z
    y = div_const(vs.to(torch.float32)[:, None] - cy, fy) * z
    x, y, z = (a.reshape(lead + (-1,)) for a in (x, y, z))
    pts = torch.stack([
        x * R[..., i, 0, None] + y * R[..., i, 1, None] + z * R[..., i, 2, None] + t[..., i, None]
        for i in range(3)
    ], dim=-1)
    if rgb is None:
        cols = torch.zeros(pts.shape, dtype=torch.uint8, device=dev)
    else:
        cols = rgb[..., vs[:, None], us[None, :], :].reshape(lead + (-1, 3))
    return pts, cols, valid.reshape(lead + (-1,))


def fuse_chunk_scan(state: DenseMapState, depths, rgbs, Rs, ts, fx, fy, cx, cy,
                    pixel_step=8, max_depth=5.0, voxel_size=0.02, depth_min=0.1,
                    frames_per_step=1) -> DenseMapState:
    """Dense accumulation over a chunk of frames, `frames_per_step` frames
    to one insert. Exactly equal to one insert per frame: the earlier
    frame wins a contested voxel and winners append in frame order.

    depths (N, H, W) f32 meters (0 = invalid); rgbs (N, H, W, 3) uint8 or
    None; Rs (N, 3, 3); ts (N, 3). N must be a multiple of frames_per_step.
    Writes the map in place (see `insert_points`)."""
    F = frames_per_step
    N = depths.shape[0]
    if N % F:
        raise ValueError(f"{N} frames is not a multiple of frames_per_step {F}")
    for i in range(0, N, F):
        pts, cols, valid = backproject_frame(
            depths[i:i + F], None if rgbs is None else rgbs[i:i + F], Rs[i:i + F], ts[i:i + F],
            fx, fy, cx, cy, pixel_step=pixel_step, max_depth=max_depth, depth_min=depth_min,
        )
        state = insert_points(state, pts.reshape(-1, 3), cols.reshape(-1, 3), valid.reshape(-1),
                              voxel_size)
    return state


def fuse_sequence(state: DenseMapState, depths, rgbs, Rs, ts, fx, fy, cx, cy,
                  pixel_step=8, max_depth=5.0, voxel_size=0.02, depth_min=0.1,
                  chunk: int = 64, frames_per_step: int = 16) -> DenseMapState:
    """Fuse a whole sequence in chunks of `chunk` frames, as the JAX
    package's `fuse_sequence` does: the last chunk is padded with frames of
    zero depth at identity poses (no-op inserts that still advance
    `insert_epoch`), and each chunk inserts gcd(chunk, frames_per_step)
    frames at a time. depths (N, H, W) f32 meters, rgbs (N, H, W, 3) uint8
    or None, Rs (N, 3, 3), ts (N, 3): tensors on the map's device. Writes
    the map in place (see `insert_points`)."""
    N = depths.shape[0]
    F = math.gcd(chunk, frames_per_step)
    for k in range(0, N, chunk):
        d, R, t = depths[k:k + chunk], Rs[k:k + chunk], ts[k:k + chunk]
        r = None if rgbs is None else rgbs[k:k + chunk]
        pad = chunk - d.shape[0]
        if pad:
            d = torch.cat([d, d.new_zeros((pad,) + d.shape[1:])])
            r = None if r is None else torch.cat([r, r.new_zeros((pad,) + r.shape[1:])])
            R = torch.cat([R, torch.eye(3, dtype=R.dtype, device=R.device).expand(pad, 3, 3)])
            t = torch.cat([t, t.new_zeros((pad, 3))])
        state = fuse_chunk_scan(state, d, r, R, t, fx, fy, cx, cy, pixel_step=pixel_step,
                                max_depth=max_depth, voxel_size=voxel_size,
                                depth_min=depth_min, frames_per_step=F)
    return state
