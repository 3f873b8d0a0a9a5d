"""Network weights: the committed Flax checkpoints -> the port's modules.

The JAX package trains SuperPoint and DepthNet on synthetic scenes and
commits the results as `vslam_tpu/models/checkpoints/superpoint_synth.npz`
and `depthnet_synth.npz`: flat `layer/leaf` keys (`conv1a/kernel`,
`conv1a/bias`, ...), HWIO kernels, f16 storage
(`vslam_tpu/models/weights.py:177-220`). The port reads those files by
path as data and maps HWIO kernels to OIHW (the padding lives in the
modules).

DepthNet has no random-init stand-in: the JAX package treats a random
net as no depth capability (`vslam_tpu/models/weights.py:225-244`), so a
missing checkpoint raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from vslam_tpu_torch.models import depthnet
from vslam_tpu_torch.models.superpoint import LAYERS, SuperPoint

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CKPT = os.path.join(_REPO, "vslam_tpu", "models", "checkpoints")
TRAINED_SP_NPZ = os.path.join(_CKPT, "superpoint_synth.npz")
TRAINED_DN_NPZ = os.path.join(_CKPT, "depthnet_synth.npz")


def load_flax_npz(path: str) -> dict:
    """Read a flat `layer/leaf` npz into {layer: {leaf: f32 array}}."""
    params: dict = {}
    with np.load(path) as z:
        for key in z.files:
            layer, leaf = key.split("/")
            params.setdefault(layer, {})[leaf] = z[key].astype(np.float32)
    return params


def _state_dict_from_flax(params, names) -> dict:
    """Flax {layer: {kernel (HWIO), bias}} -> torch state_dict (OIHW)."""
    sd = {}
    for name in names:
        k = np.asarray(params[name]["kernel"], dtype=np.float32)
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        sd[f"{name}.bias"] = torch.from_numpy(np.array(params[name]["bias"], dtype=np.float32))
    return sd


def superpoint_state_dict_from_flax(params) -> dict:
    return _state_dict_from_flax(params, [name for name, *_ in LAYERS])


def depthnet_state_dict_from_flax(params) -> dict:
    return _state_dict_from_flax(params, [name for name, *_ in depthnet.LAYERS])


def load_superpoint(path: str = TRAINED_SP_NPZ, device="cuda",
                    compute_dtype=torch.bfloat16) -> SuperPoint:
    """SuperPoint module on `device` with the npz checkpoint's weights."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"SuperPoint checkpoint not found: {path}")
    model = SuperPoint(compute_dtype=compute_dtype, device=device)
    model.load_state_dict(superpoint_state_dict_from_flax(load_flax_npz(path)))
    return model.eval()


def load_depthnet(path: str = TRAINED_DN_NPZ, device="cuda",
                  compute_dtype=torch.bfloat16) -> depthnet.DepthNet:
    """DepthNet module on `device` with the npz checkpoint's weights."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"DepthNet checkpoint not found: {path}")
    model = depthnet.DepthNet(compute_dtype=compute_dtype, device=device)
    model.load_state_dict(depthnet_state_dict_from_flax(load_flax_npz(path)))
    return model.eval()
