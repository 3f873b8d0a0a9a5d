"""The benchmark's world generator: a frozen numpy copy.

Copied from `vslam_tpu_torch/data/synthetic.py` at commit a3a4213
(`make_room_world`, `make_trajectory`, `render_depth_room`,
`_visible_patch_order`, `_splat_subpixel`, `_bandlimit`,
`render_textured`, `make_image_sequence` with `family="v1"`). The output
is bit for bit the port's generator for the same arguments; it is kept
here so that no later change to the program can change what the
benchmark feeds it. One departure that leaves the output unchanged: the
landmark textures are drawn once per world, not once per frame.

Conventions: camera x right, y down, z forward; poses camera-to-world.
"""

from __future__ import annotations

import multiprocessing

import numpy as np


def make_room_world(rng, num_landmarks=6000, desc_dim=8, floor_y=1.5, wall_dist=8.0):
    """Landmarks on the room's floor and four walls: (points (P, 3) f32,
    unused descriptors and weights drawn so the stream of `rng` matches)."""
    P = num_landmarks
    plane = rng.integers(0, 5, P)
    u = rng.uniform(-wall_dist, wall_dist, P)
    v = rng.uniform(-wall_dist, wall_dist, P)
    ys = rng.uniform(-2.0, floor_y - 0.05, P)
    pts = np.zeros((P, 3), np.float32)
    m = plane == 0
    pts[m] = np.stack([u[m], np.full(m.sum(), floor_y), v[m]], -1)
    m = plane == 1
    pts[m] = np.stack([np.full(m.sum(), wall_dist), ys[m], v[m]], -1)
    m = plane == 2
    pts[m] = np.stack([np.full(m.sum(), -wall_dist), ys[m], v[m]], -1)
    m = plane == 3
    pts[m] = np.stack([u[m], ys[m], np.full(m.sum(), wall_dist)], -1)
    m = plane == 4
    pts[m] = np.stack([u[m], ys[m], np.full(m.sum(), -wall_dist)], -1)
    pts = pts.astype(np.float32) * 0.999
    desc = rng.normal(size=(P, desc_dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    rng.random(P)
    return pts


def make_trajectory(num_frames, dt=0.1, radius=3.0, angular_rate=0.08, height=0.0):
    """Planar arc, camera facing the direction of travel: (ts f64, R, t)."""
    ts = np.arange(num_frames) * dt
    theta = angular_rate * ts
    px = radius * np.sin(theta)
    pz = radius * (1.0 - np.cos(theta))
    pos = np.stack([px, np.full_like(px, height), pz], axis=-1).astype(np.float32)
    fwd = np.stack([np.cos(theta), np.zeros_like(theta), np.sin(theta)], -1)
    up_world = np.array([0.0, 1.0, 0.0])
    right = np.cross(up_world, fwd)
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=-1).astype(np.float32)
    return ts.astype(np.float64), R, pos


def render_depth_room(R, t, fx, fy, cx, cy, width, height, floor_y=1.5, wall_dist=8.0):
    """Ray-cast the room's floor and walls: (H, W) f32 camera-z depth (m)."""
    vs, us = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    rays_cam = np.stack(
        [(us - cx) / fx, (vs - cy) / fy, np.ones_like(us, dtype=np.float64)], axis=-1)
    rays_w = rays_cam @ R.T
    o = t
    depth = np.full((height, width), np.inf)

    def plane_hit(n, d):
        denom = rays_w @ n
        s = (d - o @ n) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        return np.where((denom != 0) & (s > 0.1), s, np.inf)

    for n, d in [
        (np.array([0.0, 1.0, 0.0]), floor_y),
        (np.array([1.0, 0.0, 0.0]), wall_dist),
        (np.array([-1.0, 0.0, 0.0]), wall_dist),
        (np.array([0.0, 0.0, 1.0]), wall_dist),
        (np.array([0.0, 0.0, -1.0]), wall_dist),
    ]:
        depth = np.minimum(depth, plane_hit(n, d))
    z = depth * rays_cam[..., 2]
    z[~np.isfinite(z)] = 0.0
    return z.astype(np.float32)


def _visible_patch_order(pts, R, t, fx, fy, cx, cy, width, height, patch):
    Rcw = R.T
    pc = pts @ Rcw.T + (-Rcw @ t)
    z = pc[:, 2]
    ids = np.nonzero(z > 0.3)[0]
    u = fx * pc[ids, 0] / z[ids] + cx
    v = fy * pc[ids, 1] / z[ids] + cy
    r = patch // 2
    inb = (u >= r + 2) & (u < width - r - 2) & (v >= r + 2) & (v < height - r - 2)
    ids, u, v = ids[inb], u[inb], v[inb]
    order = np.argsort(-z[ids])
    return ids[order], u[order], v[order]


def _splat_subpixel(img, P_sel, u, v, patch, width):
    r = patch // 2
    ax = u - r
    ay = v - r
    x0 = np.floor(ax).astype(np.int64)
    y0 = np.floor(ay).astype(np.int64)
    fx_ = (ax - x0).astype(np.float32)[:, None, None]
    fy_ = (ay - y0).astype(np.float32)[:, None, None]
    Q = np.pad(P_sel, ((0, 0), (1, 1), (1, 1)))
    ones = np.pad(np.ones((1, patch, patch), np.float32), ((0, 0), (1, 1), (1, 1)))

    def taps(A):
        return ((1 - fy_) * (1 - fx_) * A[:, 1:, 1:] + (1 - fy_) * fx_ * A[:, 1:, :-1]
                + fy_ * (1 - fx_) * A[:, :-1, 1:] + fy_ * fx_ * A[:, :-1, :-1])

    S = taps(Q)
    W = taps(ones)
    dy, dx = np.mgrid[0:patch + 1, 0:patch + 1]
    flat = (y0[:, None, None] + dy) * width + (x0[:, None, None] + dx)
    existing = img.reshape(-1)[flat]
    img.reshape(-1)[flat.reshape(-1)] = (S + (1.0 - W) * existing).reshape(-1)
    return img


def _bandlimit(patches):
    ep = np.pad(patches, ((0, 0), (1, 1), (1, 1)), mode="edge")
    patches = 0.25 * ep[:, :-2, 1:-1] + 0.5 * ep[:, 1:-1, 1:-1] + 0.25 * ep[:, 2:, 1:-1]
    ep = np.pad(patches, ((0, 0), (0, 0), (1, 1)), mode="edge")
    return 0.25 * ep[:, :, :-2] + 0.5 * ep[:, :, 1:-1] + 0.25 * ep[:, :, 2:]


def landmark_textures(num_landmarks, patch=9, seed=123):
    """The band-limited texture patch of every landmark (fixed seed)."""
    rng = np.random.default_rng(seed)
    return _bandlimit(rng.uniform(0.05, 1.0, (num_landmarks, patch, patch)).astype(np.float32))


def render_textured(pts, patches, R, t, fx, fy, cx, cy, width, height, patch=9):
    """Landmark patches splatted far to near at subpixel positions over a
    gradient background: (H, W) f32 gray in [0, 1]."""
    img = np.tile(np.linspace(0.15, 0.3, width, dtype=np.float32), (height, 1))
    ids, u, v = _visible_patch_order(pts, R, t, fx, fy, cx, cy, width, height, patch)
    img = _splat_subpixel(img, patches[ids], u, v, patch, width)
    return np.clip(img, 0.0, 1.0)


def _render_frames(args):
    seed, frames, cam, num_landmarks, radius, dt, total = args
    fx, fy, cx, cy, width, height = cam
    pts = make_room_world(np.random.default_rng(seed), num_landmarks=num_landmarks)
    patches = landmark_textures(num_landmarks)
    _, R, t = make_trajectory(total, dt=dt, radius=radius)
    out = np.zeros((len(frames), height, width), np.uint8)
    for j, i in enumerate(frames):
        img = render_textured(pts, patches, R[i], t[i], fx, fy, cx, cy, width, height)
        out[j] = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    return out


def render_depth_u16(total, cam, radius, dt, depth_scale, frames=None):
    """(N, H, W) uint16 depth along the trajectory of orbit `radius`."""
    fx, fy, cx, cy, width, height = cam
    _, R, t = make_trajectory(total, dt=dt, radius=radius)
    frames = range(total) if frames is None else frames
    out = np.zeros((len(frames), height, width), np.uint16)
    for j, i in enumerate(frames):
        d = render_depth_room(R[i].astype(np.float64), t[i].astype(np.float64),
                              fx, fy, cx, cy, width, height)
        out[j] = np.clip(d * depth_scale, 0, 65535).astype(np.uint16)
    return out


def _depth_frames(args):
    return render_depth_u16(*args)


def make_worlds(seeds, num_frames, cam, num_landmarks=6000, radii=(3.0,), dt=0.1,
                depth_scale=5000.0, workers=1):
    """The image sequences of worlds `seeds`, world w on the orbit of
    radius `radii[w]`: `make_image_sequence(num_frames, ..., seed=s,
    radius=r, with_rgb=False)` of the port. Rendered by `workers`
    processes (spawned) over slices of the frames. Returns
    dict(timestamps (N,), R (W, N, 3, 3), t (W, N, 3), gray (W, N, H, W)
    uint8, depth_u16 (W, N, H, W) uint16)."""
    if len(radii) != len(seeds):
        raise ValueError("one orbit radius per world")
    n_parts = max(1, min(workers, num_frames))
    parts = [list(range(k, num_frames, n_parts)) for k in range(n_parts)]
    jobs = [(s, p, cam, num_landmarks, r, dt, num_frames) for s, r in zip(seeds, radii)
            for p in parts]
    djobs = [(num_frames, cam, r, dt, depth_scale, p) for r in radii for p in parts]
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(workers) as pool:
            dres = pool.map_async(_depth_frames, djobs)
            gres = pool.map(_render_frames, jobs)
            dparts = dres.get()
            pool.close()
            pool.join()
    else:
        gres = [_render_frames(j) for j in jobs]
        dparts = [_depth_frames(j) for j in djobs]
    height, width = cam[5], cam[4]
    gray = np.zeros((len(seeds), num_frames, height, width), np.uint8)
    depth = np.zeros((len(seeds), num_frames, height, width), np.uint16)
    for w in range(len(seeds)):
        for k in range(n_parts):
            gray[w, k::n_parts] = gres[w * n_parts + k]
            depth[w, k::n_parts] = dparts[w * n_parts + k]
    traj = [make_trajectory(num_frames, dt=dt, radius=r) for r in radii]
    return dict(timestamps=traj[0][0], R=np.stack([x[1] for x in traj]),
                t=np.stack([x[2] for x in traj]), gray=gray, depth_u16=depth)
