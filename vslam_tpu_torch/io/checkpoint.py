"""Checkpoint / resume of the tracking state.

Port of `vslam_tpu/io/checkpoint.py`: a `TrackState` (map store,
keyframe ring, EKF, loop constraints) plus JSON metadata in one
compressed npz, restored to resume tracking mid-sequence. The file
layout is the JAX package's: `leaf_<i>` in the order `jax.tree.flatten`
visits the state (NamedTuple fields in order, depth first, None fields
left out), bf16 leaves widened to f32, and a `__meta__` JSON blob. So a
checkpoint written by either package loads into the other.
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np
import torch

from vslam_tpu_torch.config import SlamConfig
from vslam_tpu_torch.core.state import TrackState, init_state

_FORMAT_VERSION = 1


def _leaves(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [] if tree is None else [tree]


def _unflatten(template, leaves):
    """`template`'s structure with its leaves taken in order from the
    iterator `leaves`."""
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(v, leaves) for v in template))
    return None if template is None else next(leaves)


def save_state(path: str, state: TrackState, metadata: Optional[dict] = None):
    """Snapshot a TrackState (+ JSON metadata) to one npz file."""
    leaves = _leaves(state)

    def to_np(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    arrays = {f"leaf_{i}": to_np(x) for i, x in enumerate(leaves)}
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"format_version": _FORMAT_VERSION, "num_leaves": len(leaves),
                    "metadata": metadata or {}}).encode(),
        dtype=np.uint8,
    )
    np.savez_compressed(path, **arrays)


def load_state(path: str, config: SlamConfig, device="cuda") -> Tuple[TrackState, dict]:
    """Restore a TrackState on `device`; shapes must match the config's
    capacities. Leaves take the dtypes of `init_state(config)`."""
    template = init_state(config, device=device)
    ref = _leaves(template)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        if meta["format_version"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {meta['format_version']}")
        if meta["num_leaves"] != len(ref):
            raise ValueError(f"checkpoint has {meta['num_leaves']} leaves, config expects "
                             f"{len(ref)}")
        restored = []
        for i, r in enumerate(ref):
            arr = z[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(r.shape):
                raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != config shape "
                                 f"{tuple(r.shape)}")
            restored.append(torch.from_numpy(np.array(arr)).to(device=r.device, dtype=r.dtype))
    return _unflatten(template, iter(restored)), meta["metadata"]
