"""Network weights: the committed Flax checkpoints -> the port's modules.

The JAX package trains SuperPoint and DepthNet on synthetic scenes and
commits the results as `vslam_tpu/models/checkpoints/superpoint_synth.npz`
and `depthnet_synth.npz`: flat `layer/leaf` keys (`conv1a/kernel`,
`conv1a/bias`, ...), HWIO kernels, f16 storage
(`vslam_tpu/models/weights.py:177-220`). The port reads those files by
path as data and maps HWIO kernels to OIHW (the padding lives in the
modules).

The writers (`save_superpoint_npz`, `save_depthnet_npz`) write the same
format back from the port's modules (OIHW -> HWIO), so a checkpoint the
port trains is read by the JAX package's own reader. No default path of
the port points into the JAX package's checkpoint directory: the
committed files are read, never written.

DepthNet has no random-init stand-in: the JAX package treats a random
net as no depth capability (`vslam_tpu/models/weights.py:225-244`), so a
missing checkpoint raises. SuperPoint falls back to random init
(`superpoint.init_params`), as the JAX package does.

Depth Anything V2 Small (`models.depth_anything`) is trained by the
port itself (`models.train_depth_anything`) and committed under the
port's own checkpoint directory as bf16 (`TRAINED_DA2_NPZ`, written by
`save_depth_anything_npz`); `load_depth_anything` reads that file or a
published `depth_anything_v2_metric_hypersim_vits.pth` (the module
carries the published names), and raises without either: a random
net's depth would poison the monocular scale chain, as DepthNet's would.

MiDaS (`models.midas`) loads the public `midas_v21_small_256.pt` state
dict as it is (the module carries its key names,
`midas_params_from_pth`) when one is found, else Flax-style random-init
parameters (`midas.init_params`); `midas_state_dict_from_flax` carries
a JAX package parameter tree across (no checkpoint is in the repository,
so the tests hold the port to random-init Flax parameters).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from vslam_tpu_torch.models import depth_anything, depthnet, midas
from vslam_tpu_torch.models.superpoint import LAYERS, SuperPoint

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CKPT = os.path.join(_REPO, "vslam_tpu", "models", "checkpoints")
# The directory of the committed trained checkpoints (read, never written).
TRAINED_SP_DIR = _CKPT
TRAINED_SP_NPZ = os.path.join(_CKPT, "superpoint_synth.npz")
TRAINED_DN_NPZ = os.path.join(_CKPT, "depthnet_synth.npz")
# The port's own trained checkpoints (written by the port's trainers).
PORT_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "checkpoints")
TRAINED_DA2_NPZ = os.path.join(PORT_CKPT, "depth_anything_v2_small_synth.npz")
DA2_PTH_NAMES = ("depth_anything_v2_metric_hypersim_vits.pth",)


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


def _flax_tree_from_state_dict(sd, names) -> dict:
    """torch state_dict (OIHW) -> {layer: {kernel (HWIO), bias}} numpy."""
    return {name: {"kernel": sd[f"{name}.weight"].detach().cpu().float().numpy().transpose(2, 3, 1, 0),
                   "bias": sd[f"{name}.bias"].detach().cpu().float().numpy()}
            for name in names}


def _save_npz(path, model_or_sd, names, dtype):
    sd = model_or_sd.state_dict() if hasattr(model_or_sd, "state_dict") else model_or_sd
    flat = {f"{layer}/{leaf}": np.asarray(v).astype(dtype)
            for layer, leaves in _flax_tree_from_state_dict(sd, names).items()
            for leaf, v in leaves.items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **flat)


_SP_NAMES = [name for name, *_ in LAYERS]
_DN_NAMES = [name for name, *_ in depthnet.LAYERS]


def save_superpoint_npz(path, model_or_sd, dtype=np.float16):
    """Write a SuperPoint module (or its state dict) in the JAX package's
    format: flat `layer/kernel` (HWIO) and `layer/bias` keys, f16."""
    _save_npz(path, model_or_sd, _SP_NAMES, dtype)


def save_depthnet_npz(path, model_or_sd, dtype=np.float16):
    """Write a DepthNet module (or its state dict) as `save_superpoint_npz`."""
    _save_npz(path, model_or_sd, _DN_NAMES, dtype)


def superpoint_params_from_npz(path) -> dict:
    """The port's SuperPoint state dict from a flat `layer/leaf` npz."""
    return superpoint_state_dict_from_flax(load_flax_npz(path))


def depthnet_params_from_npz(path) -> dict:
    """The port's DepthNet state dict from a flat `layer/leaf` npz."""
    return depthnet_state_dict_from_flax(load_flax_npz(path))


def superpoint_params_from_pth(path) -> dict:
    """The public MagicLeap `superpoint_v1.pth` state dict (`conv1a.weight`,
    ... OIHW) as the port's SuperPoint state dict: the module carries the
    same layer names, so this keeps its twelve layers as f32."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {f"{n}.{leaf}": sd[f"{n}.{leaf}"].float() for n in _SP_NAMES for leaf in ("weight", "bias")}


SP_PTH_NAMES = ("superpoint_v1.pth", "superpoint.pth")


def load_or_init_superpoint(search_dirs=("models", "weights"), device="cuda",
                            compute_dtype=torch.bfloat16, seed: int = 0):
    """(SuperPoint on `device`, source), preferring (1) a public `.pth`
    found in `search_dirs`, (2) a `superpoint_synth.npz` there or the JAX
    package's committed one, then (3) deterministic random init
    ("random-init")."""
    from vslam_tpu_torch.models import superpoint

    ckpt = find_checkpoint(search_dirs, SP_PTH_NAMES)
    npz = find_checkpoint(tuple(search_dirs) + (_CKPT,), ("superpoint_synth.npz",))
    if ckpt is not None:
        sd, src = superpoint_params_from_pth(ckpt), ckpt
    elif npz is not None:
        sd, src = superpoint_params_from_npz(npz), npz
    else:
        sd, src = superpoint.init_params(seed=seed), "random-init"
    model = SuperPoint(compute_dtype=compute_dtype, device=device)
    model.load_state_dict(sd)
    return model.eval(), src


def load_or_init_depthnet(search_dirs=("models", "weights"), device="cuda",
                          compute_dtype=torch.bfloat16):
    """(DepthNet on `device`, source): the first `depthnet_synth.npz` in
    `search_dirs` or the JAX package's committed one. Raises
    FileNotFoundError when there is none: a random DepthNet's depth would
    poison the monocular scale chain, so there is no random stand-in."""
    npz = find_checkpoint(tuple(search_dirs) + (_CKPT,), ("depthnet_synth.npz",))
    if npz is None:
        raise FileNotFoundError(f"no depthnet_synth.npz in {tuple(search_dirs) + (_CKPT,)}")
    return load_depthnet(npz, device=device, compute_dtype=compute_dtype), npz


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


MIDAS_NAMES = ("midas_v21_small_256.pt", "midas_v21_small.pt", "midas_small.pt")


def find_checkpoint(search_dirs, names):
    """The first `dir/name` that exists, else None."""
    for d in search_dirs:
        for n in names:
            p = os.path.join(d, n)
            if os.path.exists(p):
                return p
    return None


def midas_state_dict_from_flax(variables) -> dict:
    """A JAX package MiDaS variable tree ({"params", "batch_stats"} of
    numpy-convertible leaves) -> the checkpoint's state dict: conv kernels
    HWIO -> OIHW (depthwise (k, k, 1, C) -> (C, 1, k, k)), BatchNorm
    scale/bias + mean/var -> weight/bias + running_mean/running_var."""
    p, s = variables["params"], variables["batch_stats"]
    sd = {}

    def conv(key, leaf, bias=False):
        sd[key + ".weight"] = torch.from_numpy(
            np.array(np.asarray(leaf["kernel"], np.float32).transpose(3, 2, 0, 1), order="C"))
        if bias:
            sd[key + ".bias"] = torch.from_numpy(np.array(leaf["bias"], np.float32))

    def bn(prefix, pp, ss):
        for dst, src in (("weight", pp["scale"]), ("bias", pp["bias"]),
                         ("running_mean", ss["mean"]), ("running_var", ss["var"])):
            sd[f"{prefix}.{dst}"] = torch.from_numpy(np.array(src, np.float32))

    enc_p, enc_s = p["encoder"], s["encoder"]
    conv("pretrained.layer1.0", enc_p["stem_conv"])
    bn("pretrained.layer1.1", enc_p["stem_bn"], enc_s["stem_bn"])
    for si, bi, tp, e, *_ in midas.encoder_blocks():
        bp, bs = enc_p[f"s{si}_b{bi}"], enc_s[f"s{si}_b{bi}"]
        if e == 1:
            conv(tp + ".conv_dw", bp["dw_conv"])
            bn(tp + ".bn1", bp["bn1"], bs["bn1"])
            conv(tp + ".conv_pw", bp["project_conv"])
            bn(tp + ".bn2", bp["bn2"], bs["bn2"])
        else:
            conv(tp + ".conv_pw", bp["expand_conv"])
            bn(tp + ".bn1", bp["bn0"], bs["bn0"])
            conv(tp + ".conv_dw", bp["dw_conv"])
            bn(tp + ".bn2", bp["bn1"], bs["bn1"])
            conv(tp + ".conv_pwl", bp["project_conv"])
            bn(tp + ".bn3", bp["bn2"], bs["bn2"])
    for i in range(1, 5):
        conv(f"scratch.layer{i}_rn", p[f"scratch_rn{i}"])
        tp, blk = f"scratch.refinenet{i}", p[f"refine{i}"]
        conv(tp + ".resConfUnit2.conv1", blk["rcu2"]["conv1"], bias=True)
        conv(tp + ".resConfUnit2.conv2", blk["rcu2"]["conv2"], bias=True)
        conv(tp + ".out_conv", blk["out_conv"], bias=True)
        if i != 4:
            conv(tp + ".resConfUnit1.conv1", blk["rcu1"]["conv1"], bias=True)
            conv(tp + ".resConfUnit1.conv2", blk["rcu1"]["conv2"], bias=True)
    conv("scratch.output_conv.0", p["head_conv1"], bias=True)
    conv("scratch.output_conv.2", p["head_conv2"], bias=True)
    conv("scratch.output_conv.4", p["head_conv3"], bias=True)
    return sd


def midas_params_from_pth(path: str) -> dict:
    """The public MiDaS v2.1-small checkpoint (`midas_v21_small_256.pt`, a
    `MidasNet_small` state dict over timm's `tf_efficientnet_lite3`) as the
    port's MiDaS state dict: the module carries the checkpoint's names, so
    this keeps the tensors it uses as f32, without BatchNorm's
    `num_batches_tracked` counters and the top fusion block's unused skip
    unit (`refinenet4.resConfUnit1`)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float() for k, v in sd.items() if k in midas.PARAM_SHAPES}


def load_or_init_midas(search_dirs=("models", "weights"), device="cuda",
                       compute_dtype=torch.bfloat16, size: int = 256, seed: int = 7):
    """(MidasSmall on `device`, source): the first MiDaS checkpoint found
    in `search_dirs`, else `midas.init_params(seed=seed, size=size)`
    ("random-init"), as the JAX package falls back to `init_params(
    PRNGKey(7), size)`. The search directories are relative to the working
    directory; pass others explicitly."""
    ckpt = find_checkpoint(search_dirs, MIDAS_NAMES)
    if ckpt is not None:
        sd, src = midas_params_from_pth(ckpt), ckpt
    else:
        sd, src = midas.init_params(seed=seed, size=size), "random-init"
    return midas.MidasSmall(sd, compute_dtype=compute_dtype, device=device).eval(), src


def save_depth_anything_npz(path, model_or_sd):
    """Write a Depth Anything V2 module (or its state dict) as bf16 under
    the published names: each tensor's bf16 bits as a (2, *shape) uint8
    array, the high bytes (sign, exponent) in plane 0 and the low bytes in
    plane 1, compressed (the planes compress apart: the high bytes take
    few values)."""
    sd = model_or_sd.state_dict() if hasattr(model_or_sd, "state_dict") else model_or_sd
    flat = {}
    for key in depth_anything.PARAM_SHAPES:
        bits = sd[key].detach().cpu().to(torch.bfloat16).contiguous().view(torch.int16)
        bits = bits.numpy().view(np.uint16)
        flat[key] = np.stack([(bits >> 8).astype(np.uint8), (bits & 0xFF).astype(np.uint8)])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **flat)


def depth_anything_params_from_npz(path) -> dict:
    """The f32 state dict of a `save_depth_anything_npz` file."""
    sd = {}
    with np.load(path) as z:
        for key in z.files:
            planes = z[key]
            bits = (planes[0].astype(np.uint16) << 8) | planes[1].astype(np.uint16)
            sd[key] = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16).float()
    return sd


def depth_anything_params_from_pth(path) -> dict:
    """A published Depth Anything V2 checkpoint's state dict (the module's
    own names) as f32."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float() for k, v in sd.items() if k in depth_anything.PARAM_SHAPES}


def load_depth_anything(path: str = None, device="cuda", compute_dtype=torch.bfloat16,
                        search_dirs=("models", "weights"),
                        input_size: int = depth_anything.INPUT_SIZE):
    """DepthAnythingV2 on `device` from `path` (`.npz` as
    `save_depth_anything_npz` writes, or a published `.pth`); without a
    path, a published `.pth` found in `search_dirs`, else the committed
    `TRAINED_DA2_NPZ`. Raises FileNotFoundError without a checkpoint,
    KeyError or ValueError on a tensor missing or of another shape than
    `PARAM_SHAPES`."""
    if path is None:
        path = find_checkpoint(search_dirs, DA2_PTH_NAMES) or TRAINED_DA2_NPZ
    if not os.path.exists(path):
        raise FileNotFoundError(f"Depth Anything V2 checkpoint not found: {path}")
    sd = (depth_anything_params_from_pth(path) if path.endswith((".pth", ".pt"))
          else depth_anything_params_from_npz(path))
    missing = sorted(set(depth_anything.PARAM_SHAPES) - set(sd))
    if missing:
        raise KeyError(f"{path} lacks {missing[:4]} ...")
    for key, shape in depth_anything.PARAM_SHAPES.items():
        if tuple(sd[key].shape) != shape:
            raise ValueError(f"{key}: shape {tuple(sd[key].shape)}, want {shape}")
    model = depth_anything.DepthAnythingV2(compute_dtype=compute_dtype, device=device,
                                           input_size=input_size)
    model.load_state_dict(sd)
    return model.eval()
