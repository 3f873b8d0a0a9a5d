"""SuperPoint weights: the committed Flax checkpoint -> the port's module.

The JAX package trains SuperPoint on synthetic scenes and commits the
result as `vslam_tpu/models/checkpoints/superpoint_synth.npz`: flat
`layer/leaf` keys (`conv1a/kernel`, `conv1a/bias`, ...), HWIO kernels,
f16 storage (`vslam_tpu/models/weights.py:177-200`). The port reads that
file by path as data and maps HWIO kernels to OIHW (SAME padding: 1 for
3x3, 0 for 1x1 — the padding lives in the module).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from vslam_tpu_torch.models.superpoint import LAYERS, SuperPoint

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TRAINED_SP_NPZ = os.path.join(
    _REPO, "vslam_tpu", "models", "checkpoints", "superpoint_synth.npz"
)


def load_superpoint_npz(path: str) -> dict:
    """Read a flat `layer/leaf` npz into {layer: {leaf: f32 array}}."""
    params: dict = {}
    with np.load(path) as z:
        for key in z.files:
            layer, leaf = key.split("/")
            params.setdefault(layer, {})[leaf] = z[key].astype(np.float32)
    return params


def superpoint_state_dict_from_flax(params) -> dict:
    """Flax {layer: {kernel (HWIO), bias}} -> torch state_dict (OIHW)."""
    sd = {}
    for name, *_ in LAYERS:
        k = np.asarray(params[name]["kernel"], dtype=np.float32)
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        sd[f"{name}.bias"] = torch.from_numpy(np.asarray(params[name]["bias"], dtype=np.float32))
    return sd


def load_superpoint(path: str = TRAINED_SP_NPZ, device="cuda",
                    compute_dtype=torch.bfloat16) -> SuperPoint:
    """SuperPoint module on `device` with the npz checkpoint's weights."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"SuperPoint checkpoint not found: {path}")
    model = SuperPoint(compute_dtype=compute_dtype, device=device)
    model.load_state_dict(superpoint_state_dict_from_flax(load_superpoint_npz(path)))
    return model.eval()
