"""The comparison that decides `correct`: what the window's timed path
produced, held against the plain reference (`reference/`) and the
generator's ground truth.

Numbers (each held to its limit in `limits/<cell>.json`; only the ones
named there are judged):
- `pose_err_m`: the largest per-frame position error, after alignment
  (SE(3) with sensor depth, sim(3) without), of every whole sequence in
  the window, every stream, against the ground truth.
- `kp_miss`: over the checked frames, the share of keypoints (the
  program's and the reference's together) with no keypoint of the other
  side within 0.5 px.
- `desc_gap`: the largest L2 distance between the program's descriptor
  and the reference's at matched keypoints.
- `depth_gap`: the largest |log depth| gap between the program's keypoint
  depth and the reference depth network's at the same pixels (where the
  configuration names one).
- `cloud_diff`: cloud rows that differ from the reference's voxel replay
  at the program's poses, plus the difference in count (exact: limit 0).

The frontend and the cloud are checked on the window's first whole
sequence and on one later whole sequence drawn from the seed.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from slam_bench import registry
from slam_bench.reference import fusion as ref_fu
from slam_bench.reference import trajectory as ref_tr

MATCH_PX = 0.5
BLOCK = 32  # frames per reference block


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def sequence_poses(calls, seq: int, B: int):
    """t (N, B, 3) of whole sequence `seq` from its calls."""
    t = np.concatenate([c.t for c in calls if c.sequence == seq], 0)
    return t.reshape(t.shape[0], B, 3)


def sequence_rotations(calls, seq: int, B: int):
    R = np.concatenate([c.R for c in calls if c.sequence == seq], 0)
    return R.reshape(R.shape[0], B, 3, 3)


def pose_errors(t_est, t_gt, with_scale: bool):
    """Aligned per-frame errors (N, B) of t_est (N, B, 3), each stream
    against its own ground truth t_gt (B, N, 3); inf for a stream with a
    non-finite pose."""
    out = np.full(t_est.shape[:2], np.inf)
    for b in range(t_est.shape[1]):
        if np.isfinite(t_est[:, b]).all():
            out[:, b] = ref_tr.aligned_errors(t_est[:, b], t_gt[b], with_scale)
    return out


def features_of(captured):
    """The program's frontend outputs of one sequence, frames in order:
    xy (F, K, 2), valid (F, K), desc (F, K, D), depth (F, K)."""
    return {k: torch.cat([getattr(f, k) for f in captured]) for k in ("xy", "valid", "desc",
                                                                        "depth")}


def keypoint_gaps(p_xy, p_valid, p_desc, r_xy, r_valid, r_desc):
    """(misses, keypoints, largest descriptor gap) of a block of frames."""
    d = torch.cdist(p_xy.double(), r_xy.double())  # (F, Kp, Kr)
    d = d.masked_fill(~r_valid[:, None, :], np.inf).masked_fill(~p_valid[:, :, None], np.inf)
    near_p, j = d.min(2)
    near_r, _ = d.min(1)
    hit_p = (near_p <= MATCH_PX) & p_valid
    hit_r = (near_r <= MATCH_PX) & r_valid
    misses = int((p_valid & ~hit_p).sum() + (r_valid & ~hit_r).sum())
    total = int(p_valid.sum() + r_valid.sum())
    rd = torch.gather(r_desc, 1, j[..., None].expand(-1, -1, r_desc.shape[-1]))
    gap = (p_desc.float() - rd.float()).norm(dim=-1)
    gap = float(gap[hit_p].max()) if bool(hit_p.any()) else 0.0
    return misses, total, gap


def reference_networks(config: dict, device) -> dict:
    """{role: (network module, its reference parameters)} of the
    networks the configuration names (`networks/<name>.py`)."""
    return {role: (net, net.reference(config, device))
            for role, net in registry.networks(config).items()}


def reference_frontend(nets: dict, gray, fc: dict, quant=None, depth_xy=None):
    """The reference's keypoints, valid mask and descriptors of frames
    gray (F, H, W) uint8, and (with a depth network) its depth at
    `depth_xy` (F, K, 2), by default at its own keypoints."""
    features, f_params = nets["features"]
    with no_tf32(), torch.no_grad():
        xy, valid, desc = features.reference_features(f_params, gray, fc, quant)
        depth = None
        if "depth" in nets:
            net, d_params = nets["depth"]
            depth = net.reference_depth_at(d_params, gray, xy if depth_xy is None else depth_xy,
                                           quant)
    return xy, valid, desc, depth


def frontend_numbers(feats, gray, config: dict, device, quant=None):
    """kp_miss, desc_gap and (with a depth network) depth_gap of the
    program's features `feats` of frames gray (F, H, W) against the
    reference."""
    nets = reference_networks(config, device)
    fc = config["slam"]["frontend"]
    misses = total = 0
    desc_gap = depth_gap = 0.0
    for i in range(0, gray.shape[0], BLOCK):
        sl = slice(i, i + BLOCK)
        p_xy, p_valid = feats["xy"][sl].to(device), feats["valid"][sl].to(device)
        r_xy, r_valid, r_desc, ref_depth = reference_frontend(nets, gray[sl], fc, quant, p_xy)
        m, n, g = keypoint_gaps(p_xy, p_valid, feats["desc"][sl].to(device), r_xy, r_valid,
                                r_desc)
        misses, total, desc_gap = misses + m, total + n, max(desc_gap, g)
        if ref_depth is not None:
            p_depth = feats["depth"][sl].to(device)
            gap = (p_depth.double().log() - ref_depth.double().log()).abs()
            gap = torch.where(p_valid, gap, 0.0)
            depth_gap = max(depth_gap, float(gap.max()))
    out = dict(kp_miss=misses / max(total, 1), desc_gap=desc_gap)
    if "depth" in nets:
        out["depth_gap"] = depth_gap
    return out


def reference_features(gray, config: dict, device, quant):
    """The reference in the program's place (the control): its features
    of frames gray (F, H, W), computed with `quant` rounding."""
    nets = reference_networks(config, device)
    fc = config["slam"]["frontend"]
    parts = []
    for i in range(0, gray.shape[0], BLOCK):
        xy, valid, desc, depth = reference_frontend(nets, gray[i:i + BLOCK], fc, quant)
        if depth is None:
            depth = torch.zeros_like(xy[..., 0])
        parts.append(dict(xy=xy, valid=valid, desc=desc, depth=depth))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def cloud_number(dense, R, t, depth_u16, config: dict) -> int:
    """cloud_diff of the program's dense map(s) (one per stream) against
    the reference replay of each stream's own depth depth_u16 (B, N, H, W)
    at the program's poses R (N, B, 3, 3), t (N, B, 3)."""
    s = config["slam"]
    cam, dn = s["camera"], s["dense"]
    count = dense.cloud_count.reshape(-1).cpu().numpy()
    xyz = dense.cloud_xyz.reshape(len(count), -1, 3)
    diff = 0
    for b in range(len(count)):
        ref = ref_fu.fused_cloud(depth_u16[b], R[:, b], t[:, b], cam, dn)
        diff += ref_fu.cloud_diff(xyz[b, : int(count[b])].cpu().numpy(), ref)
    return diff


def judge(numbers: dict, limits: dict) -> bool:
    return all(k in numbers and np.isfinite(numbers[k]) and numbers[k] <= v
               for k, v in limits.items())
