"""The attribution apps (`vslam_tpu_torch.apps.bench_step_components`,
`bench_coupled_bisect`, `bench_frontend_components`,
`bench_conv_layers`) on the CPU at the tiny configuration, N 2.

Each app's `run` returns every row the JAX script prints (the bisect:
the programs it ports; its F, G and H probe XLA's dead-code elimination
and are not ported), each with a finite positive time and null device
activities (the CPU has none to count). Where a row computes a value, the
value is held against the JAX script's component on the same input:
- step components: the keypoints the local map matches on the last frame
  of the warm-up, through the fused path (on the CPU its plain version)
  and the plain one, equal to JAX's `_track_local_map` on the same state
  and frame;
- bisect: the fusion checksums (D without colors, E2 with, the cloud's
  point count) equal to JAX's `fuse_chunk_scan` on the same depths and
  ground-truth poses; the frontend checksum (A) within 1e-3 relative of
  JAX's `_frontend_chunk` + `_kp_depth` (both SuperPoints compute in
  bf16 and round apart: measured 5.7e-4); B's and C's positions the same
  run (no loop closes in it, so C's in-run correction never fires);
- conv layers: each layer's FLOPs as the JAX model's shapes give them.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vslam_tpu.config import tiny_test_config as j_tiny
from vslam_tpu.core import coupled as j_coupled
from vslam_tpu.core import tracking as j_tr
from vslam_tpu.core.state import FrameFeatures as JFrame
from vslam_tpu.core.state import init_state as j_init
from vslam_tpu.models import superpoint as j_sp
from vslam_tpu.models import weights as j_w
from vslam_tpu.ops import gridhash as j_gh
from vslam_tpu_torch.apps import (bench_conv_layers, bench_coupled_bisect,
                                  bench_frontend_components, bench_step_components)
from vslam_tpu_torch.config import tiny_test_config
from vslam_tpu_torch.core import pipeline as t_pl
from vslam_tpu_torch.core import state as t_state
from vslam_tpu_torch.core import tracking as t_tr

STEP_ROWS = (
    "full tracking_step", "full step (state threaded)", "real scan (fresh state, N frames)",
    "match_to_keyframe (400x400)", "3d3d RANSAC (128 hyp)", "svd3x3 batch-128",
    "orthonormalize (single)", "track_local_map (fused)", "track_local_map (XLA blocks)",
    "refine_pnp (GN + full)", "fuse_ekf", "make_keyframe (KF branch)",
    "ransac_pnp (cond branches)", "essential branch body")
BISECT_PROGRAMS = ("A_frontend", "B_fe_track", "D_fuse_nested", "E1_fe_track_full_outs",
                   "E2_fuse_nested_rgb", "C_full")
FRONTEND_ROWS = ("conv backbone + heads", "softmax+d2s+window NMS", "tiled top-k",
                 "bilinear desc sampling", "FULL extract pipeline")
CONV_STEPS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b",
              "convPa+Pb", "convDa+Db")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _times_and_nulls(times, acts, rows):
    assert tuple(times) == tuple(acts) == tuple(rows)
    for r in rows:
        assert math.isfinite(times[r]) and times[r] > 0, r
        assert acts[r] is None, r


def _jax_state(cfg_j, st):
    """The port's TrackState as the JAX package's (bf16 leaves from their
    bit view)."""
    leaves, treedef = jax.tree_util.tree_flatten(j_init(cfg_j))
    got = jax.tree_util.tree_leaves(t_state.to_numpy(st))
    assert len(got) == len(leaves)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(g.view(jnp.bfloat16) if w.dtype == jnp.bfloat16 else g)
        for g, w in zip(got, leaves)])


def test_step_components_rows_and_local_map_vs_jax():
    cfg = tiny_test_config()
    out = bench_step_components.run(bench_step_components.parse_args(["--cpu", "--n", "2"]), cfg)
    assert out["device"] == "cpu" and out["N"] == 2 and out["map_points"] > 0
    _times_and_nulls(out["us_per_iter"], out["activities_per_iter"], STEP_ROWS)
    assert out["harness_activities"] is None and out["radius_launches_per_call"] is None
    only = bench_step_components.run(
        bench_step_components.parse_args(["--cpu", "--n", "2", "--only", "svd,threaded"]), cfg)
    assert set(only["us_per_iter"]) == {"svd3x3 batch-128", "full step (state threaded)"}

    # The same warm state and frame through JAX's local-map tracking.
    seq = bench_step_components._world(cfg, 64, seed=0)
    frames = t_pl.features_from_synthetic(seq, device="cpu")
    gravity, h0 = t_pl.compute_gravity_direction(seq.accel, np.eye(3, dtype=np.float32))
    st = t_state.init_state(cfg, gravity=gravity, initial_height=h0, device="cpu")
    st, _ = t_tr.run_frames(st, frames, list(range(64)), cfg, seed=42)
    cfg_j = j_tiny()
    sj = _jax_state(cfg_j, st)
    fr = t_state.to_numpy(t_tr.frame_at(frames, 63))
    fj = j_init(cfg_j)  # only for the keyframe descriptors' dtype
    frame_j = JFrame(
        xy=jnp.asarray(fr.xy), desc=jnp.asarray(fr.desc).astype(fj.kf_desc.dtype),
        depth=jnp.asarray(fr.depth), valid=jnp.asarray(fr.valid),
        timestamp=jnp.asarray(fr.timestamp), stationary=jnp.asarray(fr.stationary),
        frame_id=jnp.asarray(fr.frame_id))
    _, kp_ok_j, _ = jax.jit(lambda s, f: j_tr._track_local_map(s, f, cfg_j, s.R, s.t))(
        sj, frame_j)
    n_j = int(jnp.sum(kp_ok_j))
    assert n_j > 0
    assert out["local_map_matches"] == {"fused": n_j, "plain": n_j}


@pytest.fixture(scope="module")
def bisect():
    args = bench_coupled_bisect.parse_args(["--cpu", "--frames", "4", "--chunk", "2",
                                            "--iters", "2"])
    return args, bench_coupled_bisect.run(args, tiny_test_config())


def test_bisect_rows(bisect):
    _, out = bisect
    for p in BISECT_PROGRAMS:
        assert math.isfinite(out[f"{p}_ms_per_frame"]) and out[f"{p}_ms_per_frame"] > 0, p
        assert out[f"{p}_activities_per_frame"] is None, p
    for p in ("F_full_poses_input", "G_full_scalar_out", "H_full_forced_checksum"):
        assert f"{p}_ms_per_frame" not in out
    assert out["tracking_delta_ms"] == pytest.approx(
        out["B_fe_track_ms_per_frame"] - out["A_frontend_ms_per_frame"])
    assert out["dense_delta_ms"] == pytest.approx(
        out["C_full_ms_per_frame"] - out["B_fe_track_ms_per_frame"])
    assert (out["chunk"], out["frames"]) == (2, 4)
    assert out["weights"].endswith("superpoint_synth.npz")
    assert np.asarray(out["C_t"]).shape == (4, 3) and math.isfinite(out["C_ate_raw_m"])
    # B and C run the same tracking
    assert out["checksums"]["B_fe_track"] == out["checksums"]["C_full"]
    assert np.isclose(np.asarray(out["C_t"]).sum(), out["checksums"]["C_full"], rtol=1e-6)


def test_bisect_checksums_vs_jax(bisect):
    args, out = bisect
    cfg_j = j_tiny()
    c = cfg_j.camera
    from vslam_tpu.data import synthetic as j_syn

    n = out["frames"]
    d0 = j_syn.make_image_sequence(n, width=c.width, height=c.height, fx=c.fx, fy=c.fy,
                                   cx=c.cx, cy=c.cy, seed=0, num_landmarks=6000, radius=3.0,
                                   with_rgb=True)
    params = j_w.superpoint_params_from_npz(out["weights"])
    model = j_sp.SuperPoint()

    @jax.jit
    def frontend(g, d16):
        kps, desc = j_coupled._frontend_chunk(params, model, g, cfg_j)
        kpd = j_coupled._kp_depth(d16.astype(jnp.float32) / c.depth_scale, kps.xy, cfg_j)
        return jnp.sum(kpd) + jnp.sum(kps.xy) * 1e-6 + jnp.sum(desc) * 1e-6

    C = args.chunk
    chk = sum(float(frontend(jnp.asarray(d0["gray"][s:s + C]), jnp.asarray(d0["depth_u16"][s:s + C])))
              for s in range(0, n, C))
    assert out["checksums"]["A_frontend"] == pytest.approx(chk, rel=1e-3)

    dn = cfg_j.dense
    fuse = jax.jit(lambda st, d16, rgb, R, t: j_gh.fuse_chunk_scan(
        st, d16.astype(jnp.float32) / c.depth_scale, rgb, R, t, c.fx, c.fy, c.cx, c.cy,
        pixel_step=dn.pixel_step,
        max_depth=dn.max_depth, voxel_size=dn.voxel_size,
        frames_per_step=math.gcd(C, dn.fuse_frames_per_insert)))
    for name, colors in (("D_fuse_nested", False), ("E2_fuse_nested_rgb", True)):
        st = j_gh.init_dense_map(dn.hash_capacity, dn.cloud_capacity)
        for s in range(0, n, C):
            st = fuse(st, jnp.asarray(d0["depth_u16"][s:s + C]),
                      jnp.asarray(d0["rgb"][s:s + C]) if colors else None,
                      jnp.asarray(d0["R"][s:s + C]), jnp.asarray(d0["t"][s:s + C]))
        assert out["checksums"][name] == int(st.cloud_count), name


def test_frontend_components_rows():
    out = bench_frontend_components.run(
        bench_frontend_components.parse_args(["--cpu", "--batch", "2", "--chunks", "2"]),
        tiny_test_config())
    assert (out["device"], out["batch"], out["chunks"]) == ("cpu", 2, 2)
    _times_and_nulls(out["us_per_frame"], out["activities_per_frame"], FRONTEND_ROWS)
    for r in FRONTEND_ROWS:
        assert out["fps"][r] == pytest.approx(1e6 / out["us_per_frame"][r])


def test_conv_layers_rows_and_flops():
    cfg = tiny_test_config()
    out = bench_conv_layers.run(bench_conv_layers.parse_args(["--cpu", "--batch", "2",
                                                              "--chunks", "2"]), cfg)
    _times_and_nulls(out["prefix_us_per_frame"], out["prefix_activities_per_frame"], CONV_STEPS)
    assert tuple(out["layer_us_per_frame"]) == CONV_STEPS
    assert sum(out["layer_us_per_frame"].values()) == pytest.approx(
        out["prefix_us_per_frame"]["convDa+Db"])
    # FLOPs from the Flax model's kernel shapes (HWIO) at each resolution
    p = j_sp.init_params(jax.random.PRNGKey(0), height=16, width=16)["params"]
    H, W = cfg.camera.height, cfg.camera.width

    def f(name, h, w):
        k, _, cin, cout = p[name]["kernel"].shape
        return 2 * h * w * cin * cout * k * k

    want = {}
    for i, s in enumerate(CONV_STEPS[:8]):
        level = i // 2
        want[s] = f(s, H >> level, W >> level)
    want["convPa+Pb"] = f("convPa", H >> 3, W >> 3) + f("convPb", H >> 3, W >> 3)
    want["convDa+Db"] = f("convDa", H >> 3, W >> 3) + f("convDb", H >> 3, W >> 3)
    assert out["layer_flops_per_frame"] == want
    for s in CONV_STEPS:
        t = out["layer_tflops"][s]
        us = out["layer_us_per_frame"][s]
        assert (t is None) == (us <= 0)
        if t is not None:
            assert t == pytest.approx(want[s] / (us * 1e-6) / 1e12)
    assert out["peak_tflops"] == 989.0
