"""Disk cache for rasterized synthetic worlds.

Port of `vslam_tpu/data/worldcache.py`. Rasterizing a long room sequence
costs minutes of single-core host time, and worlds are pure functions of
their generation parameters, so they are cached as npz keyed by every
parameter and `synthetic.DATA_VERSION` (the same tags, the same
`_kw_hash` and the same keys as the JAX package).

The port keeps its own directory (`~/.cache/vslam_worlds_torch`): a world the JAX package rendered never stands in
for one the port's renderer makes, which would hide a divergence between
the two renderers.

`apps/pregen_worlds.py` fills the cache out of band.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from vslam_tpu_torch.data import synthetic

CACHE_DIR = os.path.expanduser("~/.cache/vslam_worlds_torch")

# Keys persisted per world (the rest of make_*_sequence's output, e.g. the
# landmark world object, is not needed by consumers).
IMAGE_KEYS = ("timestamps", "R", "t", "gray", "depth_u16")
STRESS_KEYS = IMAGE_KEYS + ("accel", "moving")


def _path(tag: str) -> str:
    return os.path.join(CACHE_DIR, f"v{synthetic.DATA_VERSION}_{tag}.npz")


def is_cached(tag: str) -> bool:
    return os.path.exists(_path(tag))


def _load_or_make(tag, keys, maker):
    path = _path(tag)
    if os.path.exists(path):
        try:
            with np.load(path, allow_pickle=False) as z:
                return {k: z[k] for k in z.files}
        except Exception:
            # A torn or corrupt file (a killed writer): drop it and render
            # again; a bad entry must never fail the caller.
            try:
                os.remove(path)
            except OSError:
                pass
    d = maker()
    out = {k: np.asarray(d[k]) for k in keys if d.get(k) is not None}
    try:
        os.makedirs(CACHE_DIR, exist_ok=True)
        # PID-unique temporary file: concurrent writers must not
        # interleave into one; ends in .npz so np.savez adds no suffix.
        tmp = f"{path}.tmp{os.getpid()}.npz"
        np.savez(tmp, **out)
        os.replace(tmp, path)
    except OSError:
        pass  # the cache is best-effort
    return out


def _kw_hash(kw: dict) -> str:
    """Deterministic short hash of generation kwargs, so every parameter
    keys the cache: a changed intrinsic or stress knob must never serve a
    stale world under an unchanged variant name."""
    s = repr(sorted((k, repr(v)) for k, v in kw.items()))
    return hashlib.sha1(s.encode()).hexdigest()[:10]


def image_world_tag(n, width, height, seed, num_landmarks, radius,
                    fx, fy, cx, cy, family="v1") -> str:
    cam = _kw_hash(dict(fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy)))
    fam = "" if family == "v1" else f"_f{family}"
    return f"img_n{n}_{width}x{height}_s{seed}_lm{num_landmarks}_r{radius}_c{cam}{fam}"


def stress_world_tag(n, width, height, num_landmarks, variant: str, **kw) -> str:
    """`variant` is the human-readable label; `kw` (all generation kwargs,
    intrinsics included) is hashed into the key."""
    return f"stress_n{n}_{width}x{height}_lm{num_landmarks}_{variant}_h{_kw_hash(kw)}"


def image_world(n, *, width, height, fx, fy, cx, cy, seed, num_landmarks, radius,
                family="v1"):
    """Disk-cached `synthetic.make_image_sequence` (gray only)."""
    tag = image_world_tag(n, width, height, seed, num_landmarks, radius, fx, fy, cx, cy,
                          family=family)
    return _load_or_make(tag, IMAGE_KEYS, lambda: synthetic.make_image_sequence(
        n, width=width, height=height, fx=fx, fy=fy, cx=cx, cy=cy, seed=seed,
        num_landmarks=num_landmarks, radius=radius, with_rgb=False, family=family))


def stress_world(variant, n, *, width, height, fx, fy, cx, cy, num_landmarks, **kw):
    """Disk-cached `synthetic.make_stress_image_sequence`."""
    tag = stress_world_tag(n, width, height, num_landmarks, variant, fx=float(fx),
                           fy=float(fy), cx=float(cx), cy=float(cy), **kw)
    return _load_or_make(tag, STRESS_KEYS, lambda: synthetic.make_stress_image_sequence(
        n, width=width, height=height, fx=fx, fy=fy, cx=cx, cy=cy,
        num_landmarks=num_landmarks, **kw))
