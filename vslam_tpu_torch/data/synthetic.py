"""Synthetic RGB-D sequences with exact ground truth (numpy).

The port's own copy of the pixels-in generator of
`vslam_tpu/data/synthetic.py` (lines 57-125, 370-545, 596-722): a room of
textured landmarks on the floor and four walls, a planar arc trajectory
or the stress world's closed circle with a stationary pause and a texture
dropout, textured gray renders and analytic depth in the TUM storage
formats, and the stress world's accelerometer rows. It feeds the port on
the card, where the JAX package is not imported; the output is identical
to the JAX package's generator for the same arguments (its family "v1").

Conventions: camera x right, y down, z forward; world = first camera
frame; poses are camera-to-world.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

@dataclass
class SyntheticWorld:
    landmarks: np.ndarray  # (P, 3) world points
    descriptors: np.ndarray  # (P, D) unit descriptors
    priority: np.ndarray  # (P,) persistent selection priority



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
):
    """Rasterized pixels-in sequence: textured room renders + analytic
    depth along a planar trajectory, in the TUM storage formats (gray
    uint8, depth uint16 at 1/depth_scale m).

    Returns a dict: timestamps (N,), R (N,3,3), t (N,3) ground truth;
    gray (N,H,W) u8; depth_u16 (N,H,W) u16; rgb (N,H,W,3) u8 or None.
    """
    rng = np.random.default_rng(seed)
    world = make_room_world(rng, num_landmarks=num_landmarks, desc_dim=8)
    ts, R, t = make_trajectory(num_frames, dt=dt, radius=radius)
    gray = np.zeros((num_frames, height, width), np.uint8)
    depth = np.zeros((num_frames, height, width), np.uint16)
    for i in range(num_frames):
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
