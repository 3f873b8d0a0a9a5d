"""Feature frontends: batched SuperPoint (or ORB) over frame stacks,
keypoint depth, and the app's whole-sequence extraction with its replay
cache.

Ports `vslam_tpu/core/frontend.py` (`SuperPointFrontend`, `OrbFrontend`,
`orb_parity_config`, `make_frontend`, `sample_depth_at_keypoints`,
`extract_sequence`) and the frontend half of
`vslam_tpu/core/coupled.py:42-64` and `:108-115` (the uint8 chunk
frontend of `run_coupled` and the depth network's fill of keypoints
without sensor depth).

The app's frontends take host numpy frames (uint8 or float gray): the
`> 1.5` test that decides whether to divide by 255 is made on the host
array before upload, so it reads nothing back from the card.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch

from vslam_tpu_torch.config import SlamConfig
from vslam_tpu_torch.core.state import FrameFeatures
from vslam_tpu_torch.io import feature_cache as fcache
from vslam_tpu_torch.models import depthnet
from vslam_tpu_torch.models.superpoint import pad_to_multiple
from vslam_tpu_torch.ops import camera, device, nms, orb
from vslam_tpu_torch.utils import profiling


def sample_depth_at_keypoints(depth_maps, kp_xy):
    """Nearest-pixel depth per keypoint: depth_maps (B, H, W) meters,
    kp_xy (B, K, 2) -> (B, K). Rounds half to even, as jnp.round does."""
    B, H, W = depth_maps.shape
    u = torch.clamp(torch.round(kp_xy[..., 0]).to(torch.int64), 0, W - 1)
    v = torch.clamp(torch.round(kp_xy[..., 1]).to(torch.int64), 0, H - 1)
    return torch.gather(depth_maps.reshape(B, H * W), 1, v * W + u)


def extract_chunk(model, gray_u8, config):
    """(C, H, W) uint8 -> (Keypoints, descriptors (C, K, D)): the whole
    SuperPoint frontend. Small-descriptor configs truncate and
    renormalize, as the JAX package does."""
    fc = config.frontend
    images = camera.unit_gray(gray_u8)[..., None]
    with torch.no_grad():
        semi, desc_c = model(images)
    kps, desc = nms.extract_keypoints(
        semi, desc_c, max_keypoints=fc.max_keypoints,
        radius=fc.sp_nms_radius, conf=fc.sp_confidence_threshold,
    )
    if desc.shape[-1] != fc.descriptor_dim:
        desc = desc[..., : fc.descriptor_dim]
        desc = desc / torch.clamp(device.sqrt(torch.sum(desc * desc, -1, keepdim=True)), min=1e-8)
    return kps, desc


def depth_meters(depth_u16, depth_scale):
    """Integer sensor depth -> meters (f32; `/ depth_scale` as XLA rounds
    it)."""
    return device.div_const(depth_u16.to(torch.float32), depth_scale)


def predicted_keypoint_depth(depth_model, gray_u8, kp_xy):
    """The depth network's metric depth (C, K) at the keypoints kp_xy
    (C, K, 2) of a chunk gray_u8 (C, H, W), asked through its
    `keypoint_depth` method (`DepthNet`, `DepthAnythingV2`); a module
    without one is read as a net on DepthNet's grid
    (`depthnet.keypoint_depth`). In the program span `frontend.depth`."""
    with profiling.span("frontend.depth", frames=int(gray_u8.shape[0])):
        if hasattr(depth_model, "keypoint_depth"):
            return depth_model.keypoint_depth(gray_u8, kp_xy)
        return depthnet.keypoint_depth(depth_model, gray_u8, kp_xy)


def frontend_features(model, gray_u8, depth_u16, timestamps, frame_ids, stationary,
                      config, depth_model=None) -> FrameFeatures:
    """One chunk of frames -> stacked FrameFeatures (C leading). With a
    `depth_model` (`models.depthnet.DepthNet`,
    `models.depth_anything.DepthAnythingV2`), a keypoint whose sensor
    depth is not above `camera.depth_min` takes the network's depth."""
    kps, desc = extract_chunk(model, gray_u8, config)
    depth_m = depth_meters(depth_u16, config.camera.depth_scale)
    kpd = sample_depth_at_keypoints(depth_m, kps.xy)
    if depth_model is not None:
        kpd_pred = predicted_keypoint_depth(depth_model, gray_u8, kps.xy)
        kpd = torch.where(kpd > config.camera.depth_min, kpd, kpd_pred)
    return FrameFeatures(
        xy=kps.xy, desc=desc, depth=kpd, valid=kps.valid,
        timestamp=timestamps, stationary=stationary, frame_id=frame_ids,
    )


def _host_gray(gray_batch: np.ndarray) -> np.ndarray:
    """(B, H, W) uint8 or float gray -> float32 in [0, 1], on the host."""
    img = np.asarray(gray_batch, np.float32)
    if img.size and float(img.max()) > 1.5:
        img = img / np.float32(255.0)
    return img


class SuperPointFrontend:
    """Batched SuperPoint extractor bound to a config and a model on
    `device` (by default the committed checkpoint,
    `models.weights.load_superpoint`)."""

    def __init__(self, config: SlamConfig, model=None, device="cuda"):
        from vslam_tpu_torch.models import weights

        self.config = config
        self.device = torch.device(device)
        if model is None:
            model = weights.load_superpoint(device=self.device)
            self.weight_source = weights.TRAINED_SP_NPZ
        else:
            self.weight_source = "provided"
        self.model = model

    def extract(self, gray_batch: np.ndarray):
        """(B, H, W) uint8/float grayscale -> (xy, score, valid, desc) on
        the frontend's device."""
        fc = self.config.frontend
        img = torch.from_numpy(_host_gray(gray_batch)).to(self.device)[..., None]
        img, _ = pad_to_multiple(img)
        with torch.no_grad():
            semi, desc_c = self.model(img)
        kps, desc = nms.extract_keypoints(
            semi, desc_c, max_keypoints=fc.max_keypoints,
            radius=fc.sp_nms_radius, conf=fc.sp_confidence_threshold,
        )
        return kps.xy, kps.score, kps.valid, desc


class OrbFrontend:
    """ORB fallback frontend with the SuperPointFrontend interface (the
    reference swaps in `cv::ORB::create(3000, 1.2, 8)` when the SuperPoint
    model is absent, `src/FeatureExtractor.cpp:12-15, 210-214`).

    Detection runs at the config's pyramid parameters over the whole
    frame stack at once (`ops.orb.detect_orb` is batched, as the JAX
    package's is under `vmap`). Descriptors are cut to
    `frontend.descriptor_dim` and renormalised; `orb_parity_config` runs
    the pipeline at the reference's 3000-keypoint budget."""

    def __init__(self, config: SlamConfig, num_levels: Optional[int] = None, device="cuda"):
        self.config = config
        self.device = torch.device(device)
        self.num_levels = num_levels or config.frontend.orb_num_levels
        self.weight_source = "orb-fallback"

    def extract(self, gray_batch: np.ndarray):
        fc = self.config.frontend
        imgs = torch.from_numpy(_host_gray(gray_batch)).to(self.device)
        xy, score, valid, desc = orb.detect_orb(
            imgs, max_keypoints=fc.max_keypoints, num_levels=self.num_levels,
            scale_factor=fc.orb_scale_factor, threshold=fc.orb_fast_threshold,
        )
        d = desc[..., : fc.descriptor_dim]
        d = d / torch.clamp(device.sqrt(torch.sum(d * d, dim=-1, keepdim=True)), min=1e-8)
        return xy, score, valid, d


def orb_parity_config(config: SlamConfig) -> SlamConfig:
    """Config adjusted to the reference's ORB-fallback run semantics
    (`include/Config.h:48-56`): 3000-keypoint capacity and L2 equivalents
    of the BF-Hamming gates. For +-1/sqrt(D) unit descriptors,
    L2^2 = 4*Hamming/D, so DISTANCE_THRESHOLD=30 bits -> L2 =
    2*sqrt(30/D) (~0.68 at D=256) and HAMMING_RATIO_THRESHOLD=0.8 on
    Hamming counts -> sqrt(0.8) on L2."""
    fc = config.frontend
    return config.replace(
        frontend=dataclasses.replace(
            fc,
            max_keypoints=fc.orb_max_keypoints,
            l2_ratio_threshold=math.sqrt(fc.orb_ratio_threshold),
            l2_max_distance=2.0 * math.sqrt(fc.orb_distance_threshold / fc.descriptor_dim),
        )
    )


def make_frontend(config: SlamConfig, kind: str = "auto", model=None, device="cuda"):
    """Frontend factory: 'orb', or 'superpoint' / 'auto' (SuperPoint with
    the committed checkpoint unless a model is given)."""
    if kind == "orb":
        return OrbFrontend(config, device=device)
    return SuperPointFrontend(config, model=model, device=device)


def extract_sequence(frontend, gray_frames: np.ndarray, depth_frames: Optional[np.ndarray],
                     timestamps: np.ndarray, stationary: Optional[np.ndarray] = None,
                     batch: Optional[int] = None, cache_path: Optional[str] = None,
                     frame_indices: Optional[np.ndarray] = None) -> FrameFeatures:
    """Run the frontend over a whole sequence -> stacked FrameFeatures on
    the frontend's device.

    If `cache_path` exists it is replayed instead of running inference
    (the reference's sp_cache.bin behavior, `src/main.cpp:1048-1051`);
    otherwise features are extracted and saved there (when given).
    `frame_indices` are the dataset frame ids of `gray_frames` rows, used
    to select cache entries when replaying a cache written at a different
    frame step."""
    cfg = frontend.config
    dev = frontend.device
    N = gray_frames.shape[0]
    K = cfg.frontend.max_keypoints
    D = cfg.frontend.descriptor_dim

    if cache_path and os.path.exists(cache_path):
        if cache_path.endswith(".npz"):
            xy, score, desc, valid, cache_ids = fcache.load_npz(cache_path)
        else:
            xy, score, desc, valid, cache_ids = fcache.to_padded(
                fcache.load_spcf(cache_path), K, D)
        # Reconcile by dataset frame id whenever possible: a cache written
        # at a different --frame-step must not silently associate features
        # with the wrong frames.
        need_reselect = xy.shape[0] != N or (
            frame_indices is not None
            and not np.array_equal(np.asarray(cache_ids, np.int64),
                                   np.asarray(frame_indices, np.int64))
        )
        if need_reselect:
            if frame_indices is None:
                raise ValueError(
                    f"feature cache has {xy.shape[0]} frames but the run has "
                    f"{N}; pass frame_indices to subselect (cache written at "
                    f"a different --frame-step?)"
                )
            id_to_row = {int(fid): i for i, fid in enumerate(cache_ids)}
            try:
                rows = np.asarray([id_to_row[int(i)] for i in frame_indices])
            except KeyError as e:
                raise ValueError(f"frame {e} not present in feature cache") from None
            xy, score, desc, valid = xy[rows], score[rows], desc[rows], valid[rows]
        xy, desc, valid = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                           for a in (xy, desc, valid))
    else:
        B = batch or cfg.runtime.inference_batch
        xs, ss, vs, ds = [], [], [], []
        for i in range(0, N, B):
            chunk = gray_frames[i: i + B]
            pad = B - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.zeros_like(chunk[:pad])])
            cxy, cs, cv, cd = frontend.extract(chunk)
            n = B - pad
            xs.append(cxy[:n])
            ss.append(cs[:n])
            vs.append(cv[:n])
            ds.append(cd[:n])
        xy, score, valid, desc = (torch.cat(a) for a in (xs, ss, vs, ds))
        if cache_path:
            # Key entries by DATASET frame id (not row index) so a replay at
            # a different --frame-step reselects correctly.
            ids = frame_indices if frame_indices is not None else np.arange(N)
            host = [a.cpu().numpy() for a in (xy, score, desc, valid)]
            if cache_path.endswith(".npz"):
                fcache.save_npz(cache_path, *host, frame_ids=ids)
            else:
                fcache.save_spcf(cache_path, fcache.from_padded(*host, frame_ids=ids))

    if depth_frames is not None:
        depth = sample_depth_at_keypoints(
            torch.from_numpy(np.ascontiguousarray(depth_frames, np.float32)).to(dev), xy)
    else:
        depth = torch.zeros((N, K), dtype=torch.float32, device=dev)
    if stationary is None:
        stationary = np.zeros(N, bool)
    return FrameFeatures(
        xy=xy, desc=desc, depth=depth, valid=valid,
        timestamp=torch.from_numpy(np.asarray(timestamps, np.float32)).to(dev),
        stationary=torch.from_numpy(np.asarray(stationary, bool)).to(dev),
        frame_id=torch.arange(N, dtype=torch.int32, device=dev),
    )
