"""Synthetic RGB-D sequences with exact ground truth (numpy).

The port's own copy of `vslam_tpu/data/synthetic.py`: the feature-level
generators (`make_world`, `observe`, `make_sequence`,
`make_room_sequence`), the pixels-in ones (a room of textured landmarks
on the floor and four walls, a planar arc trajectory or the stress
world's closed circle with a stationary pause and a texture dropout,
textured gray renders of the training family "v1" or the held-out family
"v2" and analytic depth in the TUM storage formats, the stress world's
accelerometer rows), the Kinect-model sensor noise (`apply_sensor_noise`),
the Gaussian-spot render (`render_gray`) and `write_tum_sequence`, which
writes a sequence as a TUM dataset directory. It feeds the port on the
card, where the JAX package is not imported; the output is identical,
bit for bit, to the JAX package's generator for the same arguments.

Conventions: camera x right, y down, z forward; world = first camera
frame; poses are camera-to-world.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

# Bump when any renderer / trajectory / world generator changes output:
# the world cache (`data.worldcache`) keys its files on it.
DATA_VERSION = 1


@dataclass
class SyntheticWorld:
    landmarks: np.ndarray  # (P, 3) world points
    descriptors: np.ndarray  # (P, D) unit descriptors
    priority: np.ndarray  # (P,) persistent selection priority


@dataclass
class SyntheticSequence:
    timestamps: np.ndarray  # (N,)
    R: np.ndarray  # (N, 3, 3) camera-to-world
    t: np.ndarray  # (N, 3)
    kp_xy: np.ndarray  # (N, K, 2) observed pixels
    kp_desc: np.ndarray  # (N, K, D)
    kp_depth: np.ndarray  # (N, K) sensor depth at keypoint (0 = invalid)
    kp_valid: np.ndarray  # (N, K) bool
    kp_landmark: np.ndarray  # (N, K) int32 true landmark id (-1 invalid)
    accel: np.ndarray  # (M, 4): t, ax, ay, az (camera frame)
    world: SyntheticWorld
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def make_room_world(rng, num_landmarks=4000, desc_dim=256, floor_y=1.5, wall_dist=8.0):
    """Landmarks ON the analytic room surfaces (floor + 4 walls), so that
    `render_depth_room` depth maps are geometrically consistent with the
    landmark observations — required for image+depth end-to-end runs."""
    P = num_landmarks
    plane = rng.integers(0, 5, P)
    u = rng.uniform(-wall_dist, wall_dist, P)
    v = rng.uniform(-wall_dist, wall_dist, P)
    ys = rng.uniform(-2.0, floor_y - 0.05, P)
    pts = np.zeros((P, 3), np.float32)
    # floor
    m = plane == 0
    pts[m] = np.stack([u[m], np.full(m.sum(), floor_y), v[m]], -1)
    # +x / -x walls
    m = plane == 1
    pts[m] = np.stack([np.full(m.sum(), wall_dist), ys[m], v[m]], -1)
    m = plane == 2
    pts[m] = np.stack([np.full(m.sum(), -wall_dist), ys[m], v[m]], -1)
    # +z / -z walls
    m = plane == 3
    pts[m] = np.stack([u[m], ys[m], np.full(m.sum(), wall_dist)], -1)
    m = plane == 4
    pts[m] = np.stack([u[m], ys[m], np.full(m.sum(), -wall_dist)], -1)
    pts = pts.astype(np.float32) * 0.999  # just inside the surfaces
    desc = rng.normal(size=(P, desc_dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return SyntheticWorld(pts, desc, rng.random(P).astype(np.float32))


def make_world(rng, num_landmarks=4000, desc_dim=256, extent=(12.0, 2.5, 12.0)):
    """Landmarks in a box around the trajectory; floor-ish band included."""
    P = num_landmarks
    pts = np.stack(
        [
            rng.uniform(-extent[0], extent[0], P),
            rng.uniform(-extent[1], extent[1], P),
            rng.uniform(-extent[2], extent[2], P),
        ],
        axis=-1,
    ).astype(np.float32)
    desc = rng.normal(size=(P, desc_dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return SyntheticWorld(pts, desc, rng.random(P).astype(np.float32))


def make_trajectory(num_frames, dt=0.1, radius=4.0, angular_rate=0.08, height=0.0):
    """Planar arc (constant height): a wheeled-robot-like path.

    Camera faces the direction of travel. Returns (ts, R, t) with
    camera-to-world poses; world frame equals the first camera frame
    up to a translation.
    """
    ts = np.arange(num_frames) * dt
    theta = angular_rate * ts
    # Position on a circle in the (x, z) plane at fixed y (height).
    px = radius * np.sin(theta)
    pz = radius * (1.0 - np.cos(theta))
    pos = np.stack([px, np.full_like(px, height), pz], axis=-1).astype(np.float32)
    # Heading: derivative direction -> camera z axis (forward).
    fwd = np.stack([np.cos(theta), np.zeros_like(theta), np.sin(theta)], -1)
    up_world = np.array([0.0, 1.0, 0.0])  # +y is down in camera terms
    right = np.cross(up_world, fwd)
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=-1).astype(np.float32)  # columns
    return ts.astype(np.float64), R, pos


def observe(
    world: SyntheticWorld,
    R,
    t,
    fx,
    fy,
    cx,
    cy,
    width,
    height,
    max_keypoints=400,
    rng: Optional[np.random.Generator] = None,
    pixel_noise=0.3,
    desc_noise=0.02,
    depth_noise=0.005,
    depth_range=(0.3, 10.0),
    dropout=0.05,
):
    """Project landmarks into one camera; keep up to K by persistent
    priority (stable across frames, so covisible landmarks match)."""
    rng = rng or np.random.default_rng(0)
    Rcw = R.T
    tcw = -Rcw @ t
    pc = world.landmarks @ Rcw.T + tcw
    z = pc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = fx * pc[:, 0] / z + cx
        v = fy * pc[:, 1] / z + cy
    vis = (
        (z > depth_range[0])
        & (z < depth_range[1])
        & (u >= 1)
        & (u < width - 1)
        & (v >= 1)
        & (v < height - 1)
    )
    vis &= rng.random(len(z)) > dropout
    ids = np.nonzero(vis)[0]
    order = np.argsort(world.priority[ids])[:max_keypoints]
    ids = ids[order]
    K = max_keypoints
    kp_xy = np.zeros((K, 2), np.float32)
    kp_desc = np.zeros((K, world.descriptors.shape[1]), np.float32)
    kp_depth = np.zeros(K, np.float32)
    kp_valid = np.zeros(K, bool)
    kp_lm = np.full(K, -1, np.int32)
    n = len(ids)
    kp_xy[:n, 0] = u[ids] + rng.normal(0, pixel_noise, n)
    kp_xy[:n, 1] = v[ids] + rng.normal(0, pixel_noise, n)
    d = world.descriptors[ids] + rng.normal(0, desc_noise, (n, world.descriptors.shape[1]))
    kp_desc[:n] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    kp_depth[:n] = z[ids] * (1.0 + rng.normal(0, depth_noise, n))
    kp_valid[:n] = True
    kp_lm[:n] = ids
    return kp_xy, kp_desc, kp_depth, kp_valid, kp_lm


def make_sequence(
    num_frames=60,
    max_keypoints=400,
    desc_dim=256,
    fx=525.0,
    fy=525.0,
    cx=319.5,
    cy=239.5,
    width=640,
    height=480,
    seed=0,
    dt=0.1,
    pixel_noise=0.3,
    desc_noise=0.02,
    depth_noise=0.005,
    num_landmarks=4000,
    rgbd=True,
) -> SyntheticSequence:
    rng = np.random.default_rng(seed)
    world = make_world(rng, num_landmarks=num_landmarks, desc_dim=desc_dim)
    ts, R, t = make_trajectory(num_frames, dt=dt)

    obs = [
        observe(
            world, R[i], t[i], fx, fy, cx, cy, width, height,
            max_keypoints=max_keypoints, rng=rng,
            pixel_noise=pixel_noise, desc_noise=desc_noise,
            depth_noise=depth_noise,
        )
        for i in range(num_frames)
    ]
    kp_xy = np.stack([o[0] for o in obs])
    kp_desc = np.stack([o[1] for o in obs])
    kp_depth = np.stack([o[2] for o in obs])
    kp_valid = np.stack([o[3] for o in obs])
    kp_lm = np.stack([o[4] for o in obs])
    if not rgbd:
        kp_depth = np.zeros_like(kp_depth)

    # Accelerometer at 10x frame rate: gravity in camera frame + vibration.
    # A moving wheeled robot vibrates: noise std scales with speed so the
    # reference's stationarity detector (accel std < 0.15,
    # `src/Slam.cpp:1621-1651`) fires only when actually stopped.
    g_world = np.array([0.0, 9.81, 0.0])
    vel = np.gradient(t, axis=0) / dt
    speed = np.linalg.norm(vel, axis=-1)
    arate = 10
    acc_rows = []
    for i in range(num_frames):
        sigma = 0.03 + 1.2 * speed[i]
        for j in range(arate):
            tau = ts[i] + (j / arate) * dt
            a_cam = R[min(i, num_frames - 1)].T @ g_world + rng.normal(0, sigma, 3)
            acc_rows.append([tau, *a_cam])
    accel = np.asarray(acc_rows)

    return SyntheticSequence(
        timestamps=ts, R=R, t=t,
        kp_xy=kp_xy, kp_desc=kp_desc, kp_depth=kp_depth,
        kp_valid=kp_valid, kp_landmark=kp_lm,
        accel=accel, world=world,
        fx=fx, fy=fy, cx=cx, cy=cy, width=width, height=height,
    )


def make_room_sequence(num_frames=40, seed=0, **kw):
    """Like make_sequence but with landmarks on the analytic room surfaces
    and a trajectory inside the room — depth maps rendered by
    `render_depth_room` agree with landmark observations."""
    defaults = dict(
        max_keypoints=400, desc_dim=256, fx=525.0, fy=525.0, cx=319.5,
        cy=239.5, width=640, height=480, dt=0.1, pixel_noise=0.3,
        desc_noise=0.02, depth_noise=0.0, num_landmarks=4000,
    )
    defaults.update(kw)
    kw = defaults
    rng = np.random.default_rng(seed)
    world = make_room_world(
        rng, num_landmarks=kw["num_landmarks"], desc_dim=kw["desc_dim"]
    )
    ts, R, t = make_trajectory(num_frames, dt=kw["dt"], radius=3.0)

    obs = [
        observe(
            world, R[i], t[i], kw["fx"], kw["fy"], kw["cx"], kw["cy"],
            kw["width"], kw["height"], max_keypoints=kw["max_keypoints"],
            rng=rng, pixel_noise=kw["pixel_noise"], desc_noise=kw["desc_noise"],
            depth_noise=kw["depth_noise"],
        )
        for i in range(num_frames)
    ]
    g_world = np.array([0.0, 9.81, 0.0])
    vel = np.gradient(t, axis=0) / kw["dt"]
    speed = np.linalg.norm(vel, axis=-1)
    acc_rows = []
    for i in range(num_frames):
        sigma = 0.03 + 1.2 * speed[i]
        for j in range(10):
            tau = ts[i] + (j / 10) * kw["dt"]
            a_cam = R[i].T @ g_world + rng.normal(0, sigma, 3)
            acc_rows.append([tau, *a_cam])

    return SyntheticSequence(
        timestamps=ts, R=R, t=t,
        kp_xy=np.stack([o[0] for o in obs]),
        kp_desc=np.stack([o[1] for o in obs]),
        kp_depth=np.stack([o[2] for o in obs]),
        kp_valid=np.stack([o[3] for o in obs]),
        kp_landmark=np.stack([o[4] for o in obs]),
        accel=np.asarray(acc_rows), world=world,
        fx=kw["fx"], fy=kw["fy"], cx=kw["cx"], cy=kw["cy"],
        width=kw["width"], height=kw["height"],
    )


def write_tum_sequence(out_dir, seq: SyntheticSequence, write_cache=None, textured=False):
    """Materialize a synthetic sequence as a TUM-format dataset directory:
    rgb/ + depth/ 16-bit PNGs (written by cv2), rgb.txt / depth.txt /
    associations.txt, groundtruth.txt (quaternions from
    `ops.se3.quat_from_matrix` in f32), accelerometer.txt: the bytes the
    JAX package writes. Optionally writes a feature cache (.npz or SPCF
    .bin) replaying the synthetic observations (the reference's
    deterministic sp_cache.bin mode)."""
    import os

    import cv2
    import torch

    from vslam_tpu_torch.io import feature_cache as fc
    from vslam_tpu_torch.ops import se3 as se3_ops

    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    rgb_lines, depth_lines, assoc = [], [], []
    N = len(seq.timestamps)
    for i in range(N):
        ts = seq.timestamps[i]
        depth = render_depth_room(
            seq.R[i].astype(np.float64), seq.t[i].astype(np.float64),
            seq.fx, seq.fy, seq.cx, seq.cy, seq.width, seq.height,
        )
        render = render_textured if textured else render_gray
        img = render(seq.world, seq.R[i], seq.t[i], seq.fx, seq.fy,
                     seq.cx, seq.cy, seq.width, seq.height)
        rp, dp = f"rgb/{ts:.6f}.png", f"depth/{ts:.6f}.png"
        cv2.imwrite(os.path.join(out_dir, rp),
                    (np.stack([img] * 3, -1) * 255).astype(np.uint8))
        cv2.imwrite(os.path.join(out_dir, dp),
                    np.clip(depth * 5000.0, 0, 65535).astype(np.uint16))
        rgb_lines.append(f"{ts:.6f} {rp}")
        depth_lines.append(f"{ts:.6f} {dp}")
        assoc.append(f"{ts:.6f} {rp} {ts:.6f} {dp}")

    with open(os.path.join(out_dir, "rgb.txt"), "w") as f:
        f.write("# color images\n" + "\n".join(rgb_lines) + "\n")
    with open(os.path.join(out_dir, "depth.txt"), "w") as f:
        f.write("# depth images\n" + "\n".join(depth_lines) + "\n")
    with open(os.path.join(out_dir, "associations.txt"), "w") as f:
        f.write("\n".join(assoc) + "\n")

    q = se3_ops.quat_from_matrix(torch.from_numpy(seq.R.astype(np.float32))).numpy()
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write("# ground truth trajectory\n")
        for i in range(N):
            t = seq.t[i]
            f.write(
                f"{seq.timestamps[i]:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[i, 0]:.6f} {q[i, 1]:.6f} {q[i, 2]:.6f} {q[i, 3]:.6f}\n"
            )
    with open(os.path.join(out_dir, "accelerometer.txt"), "w") as f:
        f.write("# accelerometer data\n")
        for row in seq.accel:
            f.write(f"{row[0]:.6f} {row[1]:.6f} {row[2]:.6f} {row[3]:.6f}\n")

    if write_cache:
        ones = np.ones(seq.kp_xy.shape[:2], np.float32)
        if write_cache.endswith(".npz"):
            fc.save_npz(os.path.join(out_dir, write_cache), seq.kp_xy, ones, seq.kp_desc,
                        seq.kp_valid)
        else:
            fc.save_spcf(os.path.join(out_dir, write_cache),
                         fc.from_padded(seq.kp_xy, ones, seq.kp_desc, seq.kp_valid))


def make_image_sequence(
    num_frames,
    width=640,
    height=480,
    fx=525.0,
    fy=525.0,
    cx=319.5,
    cy=239.5,
    seed=0,
    num_landmarks=6000,
    radius=3.0,
    dt=0.1,
    with_rgb=True,
    depth_scale=5000.0,
    family="v1",
):
    """Rasterized pixels-in sequence: textured room renders + analytic
    depth along a planar trajectory, in the TUM storage formats (gray
    uint8, depth uint16 at 1/depth_scale m).

    `family`: "v1" = the training-distribution renderer
    (`render_textured`); "v2" = the held-out family
    (`render_textured_v2`), used only for evaluation.

    Returns a dict: timestamps (N,), R (N,3,3), t (N,3) ground truth;
    gray (N,H,W) u8; depth_u16 (N,H,W) u16; rgb (N,H,W,3) u8 or None.
    """
    rng = np.random.default_rng(seed)
    world = make_room_world(rng, num_landmarks=num_landmarks, desc_dim=8)
    ts, R, t = make_trajectory(num_frames, dt=dt, radius=radius)
    gray = np.zeros((num_frames, height, width), np.uint8)
    depth = np.zeros((num_frames, height, width), np.uint16)
    for i in range(num_frames):
        if family == "v2":
            img = render_textured_v2(world, R[i], t[i], fx, fy, cx, cy, width, height,
                                     frame_seed=i)
        else:
            img = render_textured(world, R[i], t[i], fx, fy, cx, cy, width, height)
        gray[i] = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        d = render_depth_room(
            R[i].astype(np.float64), t[i].astype(np.float64),
            fx, fy, cx, cy, width, height,
        )
        depth[i] = np.clip(d * depth_scale, 0, 65535).astype(np.uint16)
    rgb = np.repeat(gray[..., None], 3, -1) if with_rgb else None
    return dict(
        timestamps=ts, R=R, t=t, gray=gray, depth_u16=depth, rgb=rgb,
        world=world,
    )


def make_stress_trajectory(num_frames, dt=0.1, loops=1.0, step_m=0.024, pause=(0.45, 0.07)):
    """Closed circle driven `loops` times (late frames revisit early scene
    regions, so loops can close), with a stationary stretch `pause` =
    (start fraction, length fraction) of the run and `step_m` per moving
    frame. Returns (ts, R, t, moving) with `moving` (N,) bool."""
    ts = np.arange(num_frames) * dt
    p0 = int(num_frames * pause[0])
    p1 = min(int(num_frames * (pause[0] + pause[1])), num_frames)
    moving = np.ones(num_frames, bool)
    moving[p0:p1] = False
    # Progress: arc length accumulated only while moving.
    prog = np.concatenate([[0.0], np.cumsum(moving.astype(np.float64))[:-1]])
    n_moving = max(moving.sum(), 1)
    theta_total = 2.0 * np.pi * loops
    theta = theta_total * prog / n_moving
    radius = step_m * n_moving / theta_total
    px = radius * np.sin(theta)
    pz = radius * (1.0 - np.cos(theta))
    pos = np.stack([px, np.zeros_like(px), pz], axis=-1).astype(np.float32)
    fwd = np.stack([np.cos(theta), np.zeros_like(theta), np.sin(theta)], -1)
    up_world = np.array([0.0, 1.0, 0.0])
    right = np.cross(up_world, fwd)
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=-1).astype(np.float32)
    return ts.astype(np.float64), R, pos, moving


def make_stress_image_sequence(
    num_frames,
    width=640,
    height=480,
    fx=525.0,
    fy=525.0,
    cx=319.5,
    cy=239.5,
    seed=0,
    num_landmarks=6000,
    dt=0.1,
    loops=1.0,
    pause=(0.45, 0.07),
    dropout=(0.72, 0.028),
    dropout_keep=0.03,
    depth_scale=5000.0,
):
    """The stress world: `make_stress_trajectory` rendered like
    `make_image_sequence`, with a texture dropout (frames in the
    `dropout` fractions see only a persistent `dropout_keep` share of the
    landmarks, so matching collapses and the bridge and recovery branches
    must carry the run) and accelerometer rows at ten times the frame
    rate whose noise grows with speed (so the stationary pause is
    detectable). Returns the `make_image_sequence` dict plus `accel`
    (10 N, 4) rows (time, a_x, a_y, a_z in the camera frame) and `moving`
    (N,) bool."""
    rng = np.random.default_rng(seed)
    world = make_room_world(rng, num_landmarks=num_landmarks, desc_dim=8)
    ts, R, t, moving = make_stress_trajectory(num_frames, dt=dt, loops=loops, pause=pause)
    d0 = int(num_frames * dropout[0])
    d1 = min(int(num_frames * (dropout[0] + dropout[1])), num_frames)
    keep = rng.random(num_landmarks) < dropout_keep
    sparse_world = SyntheticWorld(world.landmarks[keep], world.descriptors[keep],
                                  world.priority[keep])
    gray = np.zeros((num_frames, height, width), np.uint8)
    depth = np.zeros((num_frames, height, width), np.uint16)
    for i in range(num_frames):
        w = sparse_world if d0 <= i < d1 else world
        img = render_textured(w, R[i], t[i], fx, fy, cx, cy, width, height)
        gray[i] = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        d = render_depth_room(
            R[i].astype(np.float64), t[i].astype(np.float64),
            fx, fy, cx, cy, width, height,
        )
        depth[i] = np.clip(d * depth_scale, 0, 65535).astype(np.uint16)

    g_world = np.array([0.0, 9.81, 0.0])
    vel = np.gradient(t, axis=0) / dt
    speed = np.linalg.norm(vel, axis=-1)
    acc_rows = []
    for i in range(num_frames):
        sigma = 0.03 + 1.2 * speed[i]
        for j in range(10):
            tau = ts[i] + (j / 10) * dt
            a_cam = R[i].T @ g_world + rng.normal(0, sigma, 3)
            acc_rows.append([tau, *a_cam])

    return dict(
        timestamps=ts, R=R, t=t, gray=gray, depth_u16=depth, rgb=None,
        world=world, accel=np.asarray(acc_rows), moving=moving,
    )


def apply_sensor_noise(
    d,
    seed=0,
    gray_sigma=2.0,
    depth_k=(0.0012, 0.0019),
    depth_dropout=0.02,
    depth_scale=5000.0,
):
    """Kinect-style sensor noise on a rendered sequence dict (a
    post-process on rendered frames).

      * gray: additive Gaussian read noise (sigma in 8-bit counts);
      * depth: per-pixel Gaussian with the Kinect error model
        sigma(z) = k0 + k1 (z - 0.4)^2 (Khoshelham & Elberink 2012:
        ~1.5 mm at 0.5 m growing to ~3 cm at 3 m), plus `depth_dropout`
        random invalid holes — the failure mode TUM RGB-D depth maps show
        at grazing angles / IR shadows. u16 storage re-quantizes.

    Returns a new dict; only gray/depth_u16 are replaced.
    """
    rng = np.random.default_rng(seed + 77)
    gray = d["gray"]
    depth = d["depth_u16"]
    gray_n = np.empty_like(gray)
    depth_n = np.empty_like(depth)
    for i in range(gray.shape[0]):  # per-frame: caps peak memory at ~4 MB
        g = gray[i].astype(np.float32) + rng.normal(
            0.0, gray_sigma, gray[i].shape
        ).astype(np.float32)
        gray_n[i] = np.clip(g, 0, 255).astype(np.uint8)
        z = depth[i].astype(np.float32) / depth_scale
        sigma = depth_k[0] + depth_k[1] * np.square(z - 0.4)
        z = z + rng.normal(0.0, 1.0, z.shape).astype(np.float32) * sigma
        holes = rng.random(z.shape) < depth_dropout
        z = np.where((depth[i] == 0) | holes, 0.0, z)
        depth_n[i] = np.clip(z * depth_scale, 0, 65535).astype(np.uint16)
    out = dict(d)
    out["gray"] = gray_n
    out["depth_u16"] = depth_n
    return out


def render_depth_room(R, t, fx, fy, cx, cy, width, height, floor_y=1.5, wall_dist=8.0):
    """Ray-cast a simple axis-aligned room (floor plane + 4 walls) ->
    (H, W) float32 depth in meters. Vectorized NumPy (host-side data gen)."""
    vs, us = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    rays_cam = np.stack(
        [(us - cx) / fx, (vs - cy) / fy, np.ones_like(us, dtype=np.float64)], axis=-1
    )
    rays_w = rays_cam @ R.T  # direction in world
    o = t  # origin

    depth = np.full((height, width), np.inf)

    def plane_hit(n, d):
        """Plane n.x = d; returns ray parameter s (camera-frame z)."""
        denom = rays_w @ n
        s = (d - o @ n) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        return np.where((denom != 0) & (s > 0.1), s, np.inf)

    for n, d in [
        (np.array([0.0, 1.0, 0.0]), floor_y),  # floor (y down => y = +floor)
        (np.array([1.0, 0.0, 0.0]), wall_dist),
        (np.array([-1.0, 0.0, 0.0]), wall_dist),
        (np.array([0.0, 0.0, 1.0]), wall_dist),
        (np.array([0.0, 0.0, -1.0]), wall_dist),
    ]:
        depth = np.minimum(depth, plane_hit(n, d))

    # convert ray parameter to camera z-depth: s * z-component of ray_cam
    zfac = rays_cam[..., 2]
    z = depth * zfac
    z[~np.isfinite(z)] = 0.0
    return z.astype(np.float32)


def _visible_patch_order(world, R, t, fx, fy, cx, cy, width, height, patch):
    """Project landmarks, keep splat-safe in-bounds ones, order far-to-near
    (so near landmarks overwrite). Returns (ids, u, v)."""
    Rcw = R.T
    pc = world.landmarks @ Rcw.T + (-Rcw @ t)
    z = pc[:, 2]
    vis = z > 0.3
    ids = np.nonzero(vis)[0]
    u = fx * pc[ids, 0] / z[ids] + cx
    v = fy * pc[ids, 1] / z[ids] + cy
    r = patch // 2
    inb = (u >= r + 2) & (u < width - r - 2) & (v >= r + 2) & (v < height - r - 2)
    ids, u, v = ids[inb], u[inb], v[inb]
    order = np.argsort(-z[ids])
    return ids[order], u[order], v[order]


def _splat_subpixel(img, P_sel, u, v, patch, width):
    """Scatter pre-selected patch textures (N, patch, patch) at subpixel
    centers (u, v) into `img` in the given order (later writes win) with
    4-tap bilinear shifting + coverage blending at the borders."""
    r = patch // 2
    ax = u - r
    ay = v - r
    x0 = np.floor(ax).astype(np.int64)
    y0 = np.floor(ay).astype(np.int64)
    fx_ = (ax - x0).astype(np.float32)[:, None, None]
    fy_ = (ay - y0).astype(np.float32)[:, None, None]
    Q = np.pad(P_sel, ((0, 0), (1, 1), (1, 1)))
    ones = np.pad(
        np.ones((1, patch, patch), np.float32), ((0, 0), (1, 1), (1, 1))
    )

    def taps(A):
        return (
            (1 - fy_) * (1 - fx_) * A[:, 1:, 1:]
            + (1 - fy_) * fx_ * A[:, 1:, :-1]
            + fy_ * (1 - fx_) * A[:, :-1, 1:]
            + fy_ * fx_ * A[:, :-1, :-1]
        )

    S = taps(Q)
    W = taps(ones)
    dy, dx = np.mgrid[0 : patch + 1, 0 : patch + 1]
    flat = (y0[:, None, None] + dy) * width + (x0[:, None, None] + dx)
    existing = img.reshape(-1)[flat]
    img.reshape(-1)[flat.reshape(-1)] = (S + (1.0 - W) * existing).reshape(-1)
    return img


def _bandlimit(patches):
    """Separable binomial blur (see render_textured: stabilizes
    descriptors across subpixel phases, like a band-limited camera)."""
    ep = np.pad(patches, ((0, 0), (1, 1), (1, 1)), mode="edge")
    patches = 0.25 * ep[:, :-2, 1:-1] + 0.5 * ep[:, 1:-1, 1:-1] + 0.25 * ep[:, 2:, 1:-1]
    ep = np.pad(patches, ((0, 0), (0, 0), (1, 1)), mode="edge")
    return 0.25 * ep[:, :, :-2] + 0.5 * ep[:, :, 1:-1] + 0.25 * ep[:, :, 2:]


def render_textured(world, R, t, fx, fy, cx, cy, width, height, patch=9, seed=123):
    """Rasterize landmarks as UNIQUE random texture patches (so image-level
    descriptors are distinctive, unlike identical Gaussian spots) over a
    gradient background -> (H, W) float32 grayscale in [0, 1].

    Patches are splatted at their SUBPIXEL projections (separable
    bilinear shift of the patch texture): an integer-snapped splat
    quantizes the scene's true feature positions to +-0.5 px, which puts
    a ~0.7 px floor under two-view flow no detector can beat — measured
    as the dominant coupled-ATE term (round-3 diagnosis). Real cameras
    sample continuous scenes; so does this renderer.

    Vectorized: all patches scatter through one flat assignment in
    far-to-near order (later writes win), identical to drawing each patch
    back-to-front. ~10 ms/frame, fast enough to rasterize whole
    848-frame benchmark sequences on the host."""
    rng = np.random.default_rng(seed)  # fixed: patches persistent per landmark
    P = len(world.landmarks)
    patches = rng.uniform(0.05, 1.0, (P, patch, patch)).astype(np.float32)
    # Band-limit the texture ONCE (separable binomial blur): raw white
    # noise shifted bilinearly changes sharpness with the subpixel phase
    # (crisp at f=0, soft at f=0.5), which destabilizes descriptors
    # frame-to-frame; pre-blurred texture looks the same under any
    # fractional shift, like a real band-limited camera image.
    patches = _bandlimit(patches)

    img = np.tile(np.linspace(0.15, 0.3, width, dtype=np.float32), (height, 1))
    ids, u, v = _visible_patch_order(
        world, R, t, fx, fy, cx, cy, width, height, patch
    )
    img = _splat_subpixel(img, patches[ids], u, v, patch, width)
    return np.clip(img, 0.0, 1.0)


def render_textured_v2(world, R, t, fx, fy, cx, cy, width, height,
                       patch=11, seed=123, frame_seed=0):
    """HELD-OUT world family: same room geometry, DIFFERENT image
    statistics — the renderer-overfit hedge (the learned frontend is
    trained only on `render_textured` v1 scenes; this family is used for
    EVALUATION ONLY, never training).

    Deltas from v1 (all affect the statistics SuperPoint + the matcher
    see, none affect scene geometry):
      * structured patch textures — oriented sinusoidal gratings,
        checkerboards, radial blobs with per-landmark contrast jitter —
        instead of band-limited white noise;
      * larger patches (11 px vs 9);
      * a low-frequency 2-D illumination field background instead of the
        horizontal linear gradient;
      * radial vignetting and per-frame gamma + exposure wander
        (`frame_seed` varies the photometrics frame to frame, like auto
        exposure hunting on a real camera).
    """
    rng = np.random.default_rng(seed + 7)  # patches persistent per landmark
    P = len(world.landmarks)
    yy, xx = np.mgrid[0:patch, 0:patch].astype(np.float32)
    xc = xx - patch // 2
    yc = yy - patch // 2
    kind = rng.integers(0, 3, P)
    theta = rng.uniform(0, np.pi, P).astype(np.float32)
    freq = rng.uniform(0.15, 0.45, P).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, P).astype(np.float32)
    proj = (
        xc[None] * np.cos(theta)[:, None, None]
        + yc[None] * np.sin(theta)[:, None, None]
    )
    grating = 0.5 + 0.45 * np.sin(
        2 * np.pi * freq[:, None, None] * proj + phase[:, None, None]
    )
    cell = rng.uniform(1.5, 3.5, P).astype(np.float32)[:, None, None]
    checker = np.where(
        (np.floor(xc[None] / cell) + np.floor(yc[None] / cell)) % 2 < 1,
        0.15, 0.9,
    ).astype(np.float32)
    sig = rng.uniform(1.5, 3.0, P).astype(np.float32)[:, None, None]
    blob = 0.85 * np.exp(-(xc[None] ** 2 + yc[None] ** 2) / (2 * sig**2)) + 0.1
    patches = np.where(
        (kind == 0)[:, None, None], grating,
        np.where((kind == 1)[:, None, None], checker, blob),
    ).astype(np.float32)
    contrast = rng.uniform(0.6, 1.0, P).astype(np.float32)[:, None, None]
    offset = rng.uniform(0.0, 0.25, P).astype(np.float32)[:, None, None]
    patches = np.clip(patches * contrast + offset, 0.0, 1.0)
    patches = _bandlimit(patches)

    # Low-frequency illumination field background (per-world, persistent).
    gx = np.linspace(0, 1, width, dtype=np.float32)[None, :]
    gy = np.linspace(0, 1, height, dtype=np.float32)[:, None]
    img = np.full((height, width), 0.22, np.float32)
    for _ in range(3):
        fx2, fy2 = rng.uniform(0.5, 2.0, 2)
        ph2x, ph2y = rng.uniform(0, 2 * np.pi, 2)
        amp = rng.uniform(0.02, 0.06)
        img = img + amp * np.sin(2 * np.pi * fx2 * gx + ph2x) * np.sin(
            2 * np.pi * fy2 * gy + ph2y
        )
    img = img.astype(np.float32).copy()

    ids, u, v = _visible_patch_order(
        world, R, t, fx, fy, cx, cy, width, height, patch
    )
    img = _splat_subpixel(img, patches[ids], u, v, patch, width)

    # Per-frame photometrics: vignette (persistent strength) + gamma and
    # exposure wander (frame-varying).
    frng = np.random.default_rng(seed + 1009 * (frame_seed + 1))
    vstr = 0.3
    r2 = ((gx - 0.5) * 2) ** 2 + ((gy - 0.5) * 2) ** 2
    img = img * (1.0 - vstr * (r2 / 2.0))
    gamma = frng.uniform(0.8, 1.3)
    gain = frng.uniform(0.9, 1.1)
    img = np.clip(img * gain, 0.0, 1.0) ** gamma
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def render_gray(world, R, t, fx, fy, cx, cy, width, height, spot_sigma=1.5):
    """Rasterize landmarks as Gaussian spots on a gradient background ->
    (H, W) float32 grayscale in [0, 1]. Image-level test input."""
    img = np.tile(np.linspace(0.2, 0.35, width, dtype=np.float32), (height, 1))
    Rcw = R.T
    pc = world.landmarks @ Rcw.T + (-Rcw @ t)
    z = pc[:, 2]
    vis = z > 0.3
    u = fx * pc[vis, 0] / z[vis] + cx
    v = fy * pc[vis, 1] / z[vis] + cy
    inb = (u >= 2) & (u < width - 2) & (v >= 2) & (v < height - 2)
    u, v = u[inb], v[inb]
    amp = 0.65
    rad = int(3 * spot_sigma)
    for ui, vi in zip(u, v):
        x0, y0 = int(ui), int(vi)
        xs = np.arange(x0 - rad, x0 + rad + 1)
        ys = np.arange(y0 - rad, y0 + rad + 1)
        xs = xs[(xs >= 0) & (xs < width)]
        ys = ys[(ys >= 0) & (ys < height)]
        gx = np.exp(-((xs - ui) ** 2) / (2 * spot_sigma**2))
        gy = np.exp(-((ys - vi) ** 2) / (2 * spot_sigma**2))
        img[np.ix_(ys, xs)] += amp * gy[:, None] * gx[None, :]
    return np.clip(img, 0.0, 1.0)
