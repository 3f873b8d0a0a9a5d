"""The port's end-to-end entry point (`vslam_tpu_torch.core.coupled.
run_coupled`) against the JAX package's `run_coupled`, each with its own
SuperPoint frontend, on the shapes of `tests/test_coupled.py` (tiny
configuration, 8 frames of the seed-0 world in chunks of 4, the committed
checkpoint), so the JAX compile matches one the suite already does.

Tolerance: both frontends compute SuperPoint in bf16, and the two
frameworks round at other places (see `tests/test_torch_frontend.py`), so
the keypoints of a frame are the same set up to a few that move or trade
places. The tracker's decisions stay the same: the bool outputs (keyframe,
3D-3D, tracking ok, bridge, recovery) are equal; the match and track
counts agree within 15% + 1 and the 3D-3D inlier counts, which follow
the 5 cm gate on points back-projected from the moved keypoints, within
25% + 1 (measured: 1 match of ~50 and 5 inliers of ~23 apart); positions
agree within 2 cm and rotations within 0.02 (measured 7 mm and 0.007),
and the two trajectories' raw ATE against the ground truth agree within
1 cm. The port's own wiring is held exactly:
`run_coupled` equals its frontend followed by the tracking loop.

Phase 2, dense fusion: the port's fused map is held against the JAX
package's `fuse_chunk_scan` fed the port's own poses and the same depths:
winners, counts and colors equal, points within 1e-5 m (see
`tests/test_torch_gridhash.py`).

The multi-sequence entry point `run_coupled_batched` is held, at B = 2 on
the tiny configuration, to the port's `run_coupled` of each member: the
frontend batches the chunk's C*B frames at once, the tracker and the
fusion run per member, and every output, state leaf and dense-map leaf
is equal.

Depth-assisted monocular (`depth_params`, the committed DepthNet, all-zero
sensor depth, `rgbd=False`) is held to JAX's run the same way, except for
the essential matrix's inlier count and with poses within 5 cm (see
`test_coupled_mono_depth_vs_jax`), and on JAX's own features count for
count.

The full-size twins (640x480, K 400, 128 frames of the 6000-landmark
worlds, and the smoke's side worlds) are marked `slow`.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from vslam_tpu.config import tiny_test_config as j_tiny
from vslam_tpu.core import coupled as j_coupled
from vslam_tpu.core.state import init_state as j_init
from vslam_tpu.models import weights as j_w
from vslam_tpu.ops import gridhash
from vslam_tpu_torch.config import SlamConfig, tiny_test_config
from vslam_tpu_torch.core import coupled as t_coupled
from vslam_tpu_torch.core import frontend as t_fe
from vslam_tpu_torch.core import pipeline as t_pl
from vslam_tpu_torch.core import tracking as t_tr
from vslam_tpu_torch.core.state import init_state as t_init
from vslam_tpu_torch.core.state import member, stack_trees, to_numpy
from vslam_tpu_torch.data import synthetic as t_syn
from vslam_tpu_torch.eval import ate as t_ate
from vslam_tpu_torch.models import weights as t_w
from vslam_tpu_torch.ops import gridhash as t_gh
from vslam_tpu_torch.parallel.mesh import replicate_state

N_FRAMES, CHUNK = 8, 4


def _inputs(cfg, n_frames, chunk, num_landmarks, radius, seed=0, with_rgb=False):
    c = cfg.camera
    d = t_syn.make_image_sequence(
        n_frames, width=c.width, height=c.height, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
        seed=seed, num_landmarks=num_landmarks, radius=radius, with_rgb=with_rgb,
    )
    S, H, W = n_frames // chunk, c.height, c.width
    return d, dict(
        gray=d["gray"].reshape(S, chunk, H, W),
        depth=d["depth_u16"].reshape(S, chunk, H, W),
        rgb=d["rgb"].reshape(S, chunk, H, W, 3) if with_rgb else None,
        ts=d["timestamps"].astype(np.float32).reshape(S, chunk),
        fid=np.arange(n_frames, dtype=np.int32).reshape(S, chunk),
        stat=np.zeros((S, chunk), bool),
    )


def _run_jax(cfg, x):
    params = j_w.superpoint_params_from_npz(t_w.TRAINED_SP_NPZ)
    dense = gridhash.init_dense_map(cfg.dense.hash_capacity, cfg.dense.cloud_capacity)
    _, _, outs = j_coupled.run_coupled(
        params, j_init(cfg), dense, jnp.asarray(x["gray"]), jnp.asarray(x["depth"]), None,
        jnp.asarray(x["ts"]), jnp.asarray(x["fid"]), jnp.asarray(x["stat"]), cfg,
    )
    return jax.tree.map(np.asarray, outs)


def _dense0(cfg):
    return t_gh.init_dense_map(cfg.dense.hash_capacity, cfg.dense.cloud_capacity, device="cpu")


def _run_torch(cfg, x, model=None, depth_params=None):
    model = model or t_w.load_superpoint(device="cpu")
    rgb = None if x.get("rgb") is None else torch.from_numpy(x["rgb"])
    return t_coupled.run_coupled(
        model, t_init(cfg, device="cpu"), _dense0(cfg), torch.from_numpy(x["gray"]),
        torch.from_numpy(x["depth"].astype(np.int32)), rgb, torch.from_numpy(x["ts"]),
        torch.from_numpy(x["fid"]), torch.from_numpy(x["stat"]), cfg,
        depth_params=depth_params, device="cpu",
    )


def _jax_fuse(cfg_j, x, R, t):
    """The JAX package's fusion of the run's depths at the given poses,
    chunk by chunk as its `run_coupled` phase 2 does."""
    c, dn = cfg_j.camera, cfg_j.dense
    S, C = x["depth"].shape[:2]
    st = gridhash.init_dense_map(dn.hash_capacity, dn.cloud_capacity)
    for s in range(S):
        k = slice(s * C, (s + 1) * C)
        st = gridhash.fuse_chunk_scan(
            st, jnp.asarray(x["depth"][s].astype(np.float32) / c.depth_scale),
            None if x.get("rgb") is None else jnp.asarray(x["rgb"][s]),
            jnp.asarray(R[k]), jnp.asarray(t[k]), c.fx, c.fy, c.cx, c.cy,
            pixel_step=dn.pixel_step, max_depth=dn.max_depth, voxel_size=dn.voxel_size,
            frames_per_step=math.gcd(C, dn.fuse_frames_per_insert))
    return [np.asarray(v) for v in st]


def _assert_dense_equal(got, want):
    """got, want: DenseMapState leaves as numpy (table, xyz, rgb, count, epoch)."""
    np.testing.assert_array_equal(got[0], want[0], err_msg="table_winner")
    assert int(got[3]) == int(want[3]) and int(got[4]) == int(want[4])
    n = int(got[3])
    np.testing.assert_allclose(got[1][:n], want[1][:n], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[2][:n], want[2][:n])
    return n


def _ate(d, t_est):
    return t_ate.compute_ate(d["timestamps"], t_est, d["timestamps"], d["t"],
                             with_scale=False).rmse


def _compare(oj, ot, d, per_frame_poses=True, inlier_rel=0.25, pose_atol=0.02):
    for name in ("is_keyframe", "used_3d3d", "tracking_ok", "bridged", "recovered"):
        np.testing.assert_array_equal(getattr(ot, name), getattr(oj, name), err_msg=name)
    for name, rel in (("num_matches", 0.15), ("num_tracked", 0.15), ("num_depth_ok", 0.15),
                      ("num_inliers", inlier_rel)):
        if rel is None:
            continue
        a, b = getattr(oj, name).astype(int), getattr(ot, name).astype(int)
        assert (np.abs(a - b) <= rel * a + 1).all(), (name, a, b)
    if per_frame_poses:
        np.testing.assert_allclose(ot.t, oj.t, atol=pose_atol)
        np.testing.assert_allclose(ot.R, oj.R, atol=pose_atol)
    ate_j, ate_t = _ate(d, oj.t), _ate(d, ot.t)
    assert abs(ate_t - ate_j) <= 0.01, (ate_t, ate_j)
    return ate_j, ate_t


def test_coupled_vs_jax():
    """Trajectory against JAX's run; the fused cloud (with colors) against
    JAX's fusion at the port's own poses."""
    cfg_j, cfg_t = j_tiny(), tiny_test_config()
    d, x = _inputs(cfg_t, N_FRAMES, CHUNK, num_landmarks=500, radius=2.0, with_rgb=True)
    oj = _run_jax(cfg_j, x)
    _, dense, ot = _run_torch(cfg_t, x)
    ot = to_numpy(ot)
    assert ot.t.shape == (N_FRAMES, 3) and np.isfinite(ot.t).all() and np.isfinite(ot.R).all()
    _compare(oj, ot, d)
    assert ot.tracking_ok.all() and ot.is_keyframe[0]
    got = [v.numpy() for v in dense]
    n = _assert_dense_equal(got, _jax_fuse(cfg_j, x, ot.R, ot.t))
    assert 0 < n <= cfg_t.dense.cloud_capacity and got[2][:n].any()


def test_coupled_is_frontend_then_tracking():
    cfg = tiny_test_config()
    _, x = _inputs(cfg, N_FRAMES, CHUNK, num_landmarks=500, radius=2.0)
    model = t_w.load_superpoint(device="cpu")
    t_tr.reset_stats()
    st_a, _, out_a = _run_torch(cfg, x, model)
    assert t_tr.STATS["track_frames"] == N_FRAMES - 1 and t_tr.STATS["branch_reads"] > 0
    st = t_init(cfg, device="cpu")
    outs = []
    for s in range(N_FRAMES // CHUNK):
        frames = t_fe.frontend_features(
            model, torch.from_numpy(x["gray"][s]), torch.from_numpy(x["depth"][s].astype(np.int32)),
            torch.from_numpy(x["ts"][s]), torch.from_numpy(x["fid"][s]),
            torch.from_numpy(x["stat"][s]), cfg,
        )
        st, o = t_tr.run_frames(st, frames, x["fid"][s].tolist(), cfg)
        outs.append(o)
    for a, b in zip(jax.tree.leaves(to_numpy(out_a)),
                    [np.concatenate(f) for f in zip(*(to_numpy(o) for o in outs))]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(to_numpy(st_a)), jax.tree.leaves(to_numpy(st))):
        np.testing.assert_array_equal(a, b)


def _batched_inputs(cfg, seeds, n_frames, chunk, num_landmarks, radius):
    """(S, C, B, ...) stacks of the members' worlds, and their ground truths."""
    ds, xs = zip(*(_inputs(cfg, n_frames, chunk, num_landmarks, radius, seed=s) for s in seeds))
    xb = {k: np.stack([x[k] for x in xs], axis=2) for k in ("gray", "depth", "ts", "fid", "stat")}
    return ds, xs, xb


def _run_torch_batched(cfg, xb, model, device="cpu"):
    B = xb["gray"].shape[2]
    return t_coupled.run_coupled_batched(
        model, replicate_state(cfg, B, device="cpu"), stack_trees([_dense0(cfg)] * B),
        torch.from_numpy(xb["gray"]), torch.from_numpy(xb["depth"].astype(np.int32)),
        torch.from_numpy(xb["ts"]), torch.from_numpy(xb["fid"]), torch.from_numpy(xb["stat"]),
        cfg, device=device,
    )


def test_coupled_batched_members_equal_single_runs():
    """B = 2 worlds (seeds 0 and 1): each member of `run_coupled_batched`
    equals `run_coupled` of its world alone: outputs, state and dense map."""
    cfg = tiny_test_config()
    _, xs, xb = _batched_inputs(cfg, (0, 1), N_FRAMES, CHUNK, num_landmarks=500, radius=2.0)
    model = t_w.load_superpoint(device="cpu")
    st_b, dense_b, out_b = _run_torch_batched(cfg, xb, model)
    assert out_b.t.shape == (N_FRAMES, 2, 3)
    for b, x in enumerate(xs):
        st, dense, out = _run_torch(cfg, x, model)
        for a, y in zip(jax.tree.leaves(to_numpy(out)),
                        jax.tree.leaves(to_numpy(type(out_b)(*(f[:, b] for f in out_b))))):
            np.testing.assert_array_equal(y, a)
        for name, a, y in ((n, to_numpy(getattr(st, n)), to_numpy(getattr(member(st_b, b), n)))
                           for n in st._fields):
            for p, q in zip(jax.tree.leaves(a), jax.tree.leaves(y)):
                np.testing.assert_array_equal(q, p, err_msg=name)
        for a, y in zip(dense, member(dense_b, b)):
            assert torch.equal(y, a)
        assert int(dense.cloud_count) > 0


@pytest.mark.parametrize("mono_depth", [False, True])
def test_only_branch_predicates_are_read_back(mono_depth):
    """On the card each read of a device value back to the host waits for
    the stream. A run's only reads are the branch predicates that
    `tracking._cond` counts; on the CPU every such read (`.item()`,
    `bool()`, indexing by a 0-dim tensor, a boolean mask) shows up as one
    of the ATen ops counted here. Also on the depth-assisted monocular
    path (no sensor depth, DepthNet, the essential-matrix chain)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    reads = []

    class CountReads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket.__name__ in ("_local_scalar_dense", "nonzero"):
                reads.append(func)
            return func(*args, **(kwargs or {}))

    cfg = tiny_test_config().replace(rgbd=not mono_depth)
    _, x = _inputs(cfg, N_FRAMES, CHUNK, num_landmarks=500, radius=2.0)
    if mono_depth:
        x["depth"] = np.zeros_like(x["depth"])
    model = t_w.load_superpoint(device="cpu")
    dn = t_w.load_depthnet(device="cpu") if mono_depth else None
    t_tr.reset_stats()
    with CountReads():
        _run_torch(cfg, x, model, depth_params=dn)
    assert t_tr.STATS["branch_reads"] > 0
    assert len(reads) == t_tr.STATS["branch_reads"]


def test_depth_params_fill_only_invalid_sensor_depth():
    """`depth_params` (a DepthNet) fills a keypoint's depth from the net
    only where the sensor depth is not above `camera.depth_min`: frames
    whose right half has no sensor depth keep the sensor's value on the
    left and take DepthNet's on the right. A run fuses into a dense map,
    which is required (None was the stand-in while fusion was missing)."""
    cfg = tiny_test_config()
    _, x = _inputs(cfg, 4, 4, num_landmarks=500, radius=2.0)
    model = t_w.load_superpoint(device="cpu")
    dn = t_w.load_depthnet(device="cpu")
    gray = torch.from_numpy(x["gray"][0])
    dep = torch.from_numpy(x["depth"][0].astype(np.int32))
    dep[:, :, cfg.camera.width // 2:] = 0
    args = (torch.from_numpy(x["ts"][0]), torch.from_numpy(x["fid"][0]),
            torch.from_numpy(x["stat"][0]), cfg)
    plain = t_fe.frontend_features(model, gray, dep, *args)
    filled = t_fe.frontend_features(model, gray, dep, *args, depth_model=dn)
    pred = t_fe.predicted_keypoint_depth(dn, gray, plain.xy)
    sensor = plain.depth > cfg.camera.depth_min
    assert sensor.any() and (~sensor & plain.valid).any()
    assert torch.equal(filled.depth[sensor], plain.depth[sensor])
    assert torch.equal(filled.depth[~sensor], pred[~sensor])
    assert (pred > 0.3).all() and (pred < 20.0).all()
    for a, b in zip(filled._replace(depth=plain.depth), plain):
        assert torch.equal(a, b)

    run_args = (torch.from_numpy(x["gray"]), torch.from_numpy(x["depth"].astype(np.int32)),
                None, torch.from_numpy(x["ts"]), torch.from_numpy(x["fid"]),
                torch.from_numpy(x["stat"]), cfg)
    st0 = t_init(cfg, device="cpu")
    with pytest.raises(TypeError):
        t_coupled.run_coupled(model, st0, None, *run_args, device="cpu")


def test_coupled_mono_depth_vs_jax():
    """Depth-assisted monocular, as the JAX bench's mono_depth stage runs
    it: `rgbd=False`, all-zero sensor depth and the committed DepthNet
    through both packages' `run_coupled(depth_params=...)`. Held as
    `test_coupled_vs_jax` holds the RGB-D run: equal decisions, counts
    within 15-25%, poses within 2 cm and the ATEs within 1 cm of each
    other (DepthNet's log depth agrees within 3e-3, `tests/
    test_torch_depthnet.py`)."""
    cfg_j, cfg_t = j_tiny().replace(rgbd=False), tiny_test_config().replace(rgbd=False)
    d, x = _inputs(cfg_t, N_FRAMES, CHUNK, num_landmarks=500, radius=2.0)
    x["depth"] = np.zeros_like(x["depth"])
    params = j_w.superpoint_params_from_npz(t_w.TRAINED_SP_NPZ)
    dense = gridhash.init_dense_map(cfg_j.dense.hash_capacity, cfg_j.dense.cloud_capacity)
    _, _, oj = j_coupled.run_coupled(
        params, j_init(cfg_j), dense, jnp.asarray(x["gray"]), jnp.asarray(x["depth"]), None,
        jnp.asarray(x["ts"]), jnp.asarray(x["fid"]), jnp.asarray(x["stat"]), cfg_j,
        depth_params=j_w.depthnet_params_from_npz(t_w.TRAINED_DN_NPZ))
    oj = jax.tree.map(np.asarray, oj)
    _, dense_t, ot = _run_torch(cfg_t, x, depth_params=t_w.load_depthnet(device="cpu"))
    ot = to_numpy(ot)
    _compare(oj, ot, d, inlier_rel=None, pose_atol=0.05)
    assert ot.num_depth_ok[1:].min() > 0 and int(dense_t.cloud_count) == 0
    assert (~ot.used_3d3d & ot.tracking_ok)[1:].all()


def test_mono_depth_tracking_on_jax_features():
    """The monocular tracker (essential matrix, scale chain, DepthNet
    depth) of both packages on the same features: JAX's SuperPoint
    keypoints and JAX's DepthNet keypoint depth for 8 tiny frames with no
    sensor depth, `rgbd=False`, tracked in chunks of 4. Every decision and
    count is equal (RANSAC samples from the same keys index the same match
    lists) and the poses agree within 1e-4 m / 1e-4."""
    from vslam_tpu.core import pipeline as j_pl
    from vslam_tpu.core.state import FrameFeatures as JFrames
    from vslam_tpu.models import depthnet as j_dn
    from vslam_tpu.models import superpoint as j_sp
    from vslam_tpu_torch.core.state import FrameFeatures

    cfg_j, cfg_t = j_tiny().replace(rgbd=False), tiny_test_config().replace(rgbd=False)
    d, x = _inputs(cfg_t, N_FRAMES, 8, num_landmarks=500, radius=2.0)
    params = j_w.superpoint_params_from_npz(t_w.TRAINED_SP_NPZ)
    gray = jnp.asarray(x["gray"][0])
    kps, desc = j_coupled._frontend_chunk(params, j_sp.SuperPoint(), gray, cfg_j)
    dn = j_w.depthnet_params_from_npz(t_w.TRAINED_DN_NPZ)
    kpd = j_dn.sample_log_depth_at_keypoints(j_dn.predict_log_depth(dn, gray), kps.xy)
    cols = (kps.xy, desc, kpd, kps.valid, x["ts"][0], x["stat"][0], x["fid"][0])
    oj = j_pl.run_tracking(JFrames(*(jnp.asarray(v) for v in cols)), cfg_j, chunk=4).outputs
    oj = jax.tree.map(np.asarray, oj)
    ot = t_pl.run_tracking(FrameFeatures(*(torch.from_numpy(np.array(v)) for v in cols)), cfg_t,
                           chunk=4, device="cpu").outputs
    ot = to_numpy(ot)
    for name in ("is_keyframe", "used_3d3d", "tracking_ok", "bridged", "recovered",
                 "num_matches", "num_inliers", "num_tracked", "num_depth_ok"):
        np.testing.assert_array_equal(getattr(ot, name), getattr(oj, name), err_msg=name)
    np.testing.assert_allclose(ot.t, oj.t, atol=1e-4)
    np.testing.assert_allclose(ot.R, oj.R, atol=1e-4)
    assert not ot.used_3d3d.any() and ot.tracking_ok.all() and ot.num_inliers[1:].min() > 8


def test_inrun_pgo_runs_after_an_accepted_loop(monkeypatch):
    """A chunk that accepts a loop constraint runs the in-run pose-graph
    correction (`pipeline.inrun_pgo_correct`) once, behind one counted
    branch read per chunk; a chunk that accepts none does not run it.
    Two chunks of 4 frames; the step accepts every loop slot from the
    first frame on, so only the first chunk adds constraints. Against the
    same run with `opt.inrun_pgo` off, the reads differ by the two chunk
    reads and the correction's significance read (the constraints point
    at no stored keyframe, so the solve is skipped and nothing moves)."""
    cfg = tiny_test_config()
    assert cfg.opt.inrun_pgo
    _, x = _inputs(cfg, 8, 4, num_landmarks=500, radius=2.0)
    step = t_tr.tracking_step

    def step_accepting_a_loop(state, frame, config, key):
        st, out = step(state, frame, config, key)
        return st._replace(loops=st.loops._replace(valid=torch.ones_like(st.loops.valid))), out

    calls = []
    fold = t_pl.inrun_pgo_correct

    def counted_fold(st, config):
        calls.append(int(st.frame_idx))
        return fold(st, config)

    monkeypatch.setattr(t_tr, "tracking_step", step_accepting_a_loop)
    monkeypatch.setattr(t_pl, "inrun_pgo_correct", counted_fold)
    model = t_w.load_superpoint(device="cpu")
    t_tr.reset_stats()
    st_on, _, out_on = _run_torch(cfg, x, model)
    reads_on = t_tr.STATS["branch_reads"]
    assert calls == [4]
    cfg_off = dataclasses.replace(cfg, opt=dataclasses.replace(cfg.opt, inrun_pgo=False))
    t_tr.reset_stats()
    st_off, _, out_off = _run_torch(cfg_off, x, model)
    assert calls == [4] and reads_on - t_tr.STATS["branch_reads"] == 3
    for a, b in zip(jax.tree.leaves(to_numpy(st_on)), jax.tree.leaves(to_numpy(st_off))):
        np.testing.assert_array_equal(a, b)


def test_entry_points_default_to_the_card():
    """Entry points run on CUDA unless told otherwise; without a card they
    raise rather than move to the CPU on their own."""
    cfg = tiny_test_config()
    makers = (lambda: t_init(cfg).t, lambda: next(t_w.load_superpoint().parameters()),
              lambda: t_gh.init_dense_map(64, 16).table_winner,
              lambda: replicate_state(cfg, 2).t)
    for make in makers:
        if torch.cuda.is_available():
            assert make().is_cuda
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                make()


@pytest.mark.slow
def test_coupled_full_size_vs_jax():
    """Default SlamConfig (640x480, K 400, D 256, map 16384), 128 frames of
    the seed-0 6000-landmark world, chunks of 32: the JAX run's raw ATE is
    0.0102 m with 13 keyframes. The decisions and counts are held as in
    the small run; over 128 frames the small keypoint differences add up
    to a few cm of drift between the two trajectories (measured: 5.4 cm
    at most), so the poses are held through their raw ATE against the
    ground truth (within 1 cm of the JAX run's, and at most 0.02 m)."""
    from vslam_tpu.config import SlamConfig as JSlamConfig

    cfg_j, cfg_t = JSlamConfig(), SlamConfig()
    d, x = _inputs(cfg_t, 128, 32, num_landmarks=6000, radius=3.0)
    oj = _run_jax(cfg_j, x)
    ot = to_numpy(_run_torch(cfg_t, x)[2])
    assert np.isfinite(ot.t).all()
    ate_j, ate_t = _compare(oj, ot, d, per_frame_poses=False)
    print(f"raw ATE: jax {ate_j:.6f} m, port {ate_t:.6f} m; keyframes: jax "
          f"{int(oj.is_keyframe.sum())}, port {int(ot.is_keyframe.sum())}; max |dt| "
          f"{float(np.abs(ot.t - oj.t).max()):.6f} m")
    assert ate_t <= 0.02


@pytest.mark.slow
def test_coupled_batched_full_size_vs_jax():
    """The smoke's multi-sequence phase on the CPU: default SlamConfig, the
    worlds of seeds 0-3 (6000 landmarks, radius 3.0), 128 frames each.
    JAX's `run_coupled` of each world alone gives the raw ATE that the
    smoke's per-member ATE limits come from (printed): 0.02 m, or twice
    the JAX value where that is above 0.01 m. JAX's `run_coupled_batched`
    must take the same decisions as those single runs, and the port's
    `run_coupled_batched` is held to it as `test_coupled_full_size_vs_jax`
    holds the single run (equal decisions, counts within 15-25%), with its
    raw ATE under the smoke's limit for that world. The two ATEs are not
    held within 1 cm of each other here: the bf16 keypoint differences
    add up to different drift, and on seed 2 the port's 0.0066 m and
    JAX's 0.0174 m are 1.08 cm apart with every decision equal. Cut to
    bound the CPU's memory: chunks of 8 frames per member, so that each
    frontend batch holds 32 frames, as the single run's does (the smoke
    runs chunks of 32 per member)."""
    from vslam_tpu.config import SlamConfig as JSlamConfig

    cfg_j, cfg_t = JSlamConfig(), SlamConfig()
    seeds = (0, 1, 2, 3)
    ds, xs, _ = _batched_inputs(cfg_t, seeds, 128, 32, num_landmarks=6000, radius=3.0)
    _, _, xb = _batched_inputs(cfg_t, seeds, 128, 8, num_landmarks=6000, radius=3.0)
    params = j_w.superpoint_params_from_npz(t_w.TRAINED_SP_NPZ)
    B = len(seeds)
    dense = gridhash.init_dense_map(cfg_j.dense.hash_capacity, cfg_j.dense.cloud_capacity)
    _, _, ojb = j_coupled.run_coupled_batched(
        params, jax.tree.map(lambda v: jnp.broadcast_to(v, (B,) + v.shape), j_init(cfg_j)),
        jax.tree.map(lambda v: jnp.broadcast_to(v, (B,) + v.shape), dense),
        *(jnp.asarray(xb[k]) for k in ("gray", "depth", "ts", "fid", "stat")), cfg_j)
    ojb = jax.tree.map(np.asarray, ojb)
    _, _, otb = _run_torch_batched(cfg_t, xb, t_w.load_superpoint(device="cpu"))
    otb = to_numpy(otb)
    decisions = ("is_keyframe", "used_3d3d", "tracking_ok", "bridged", "recovered")
    rows = []
    for b, (d, x) in enumerate(zip(ds, xs)):
        oj = _run_jax(cfg_j, x)
        mj = type(ojb)(*(f[:, b] for f in ojb))
        mt = type(otb)(*(f[:, b] for f in otb))
        rows.append((seeds[b], d, oj, mj, mt))
        print(f"seed {seeds[b]}: raw ATE jax run_coupled {_ate(d, oj.t):.6f} m, jax batched "
              f"{_ate(d, mj.t):.6f} m, port batched {_ate(d, mt.t):.6f} m; keyframes jax "
              f"{int(oj.is_keyframe.sum())}, port {int(mt.is_keyframe.sum())}; decisions equal "
              f"{all(np.array_equal(getattr(mt, k), getattr(mj, k)) for k in decisions)}")
    for seed, d, oj, mj, mt in rows:
        for name in decisions:
            np.testing.assert_array_equal(getattr(mj, name), getattr(oj, name), err_msg=name)
            np.testing.assert_array_equal(getattr(mt, name), getattr(mj, name), err_msg=name)
        for name, rel in (("num_matches", 0.15), ("num_tracked", 0.15), ("num_depth_ok", 0.15),
                          ("num_inliers", 0.25)):
            a, c = getattr(mj, name).astype(int), getattr(mt, name).astype(int)
            assert (np.abs(a - c) <= rel * a + 1).all(), (seed, name, a, c)
        limit = 0.02 if _ate(d, oj.t) <= 0.01 else 2 * _ate(d, oj.t)
        assert np.isfinite(mt.t).all() and _ate(d, mt.t) <= limit, (seed, _ate(d, mt.t), limit)


@pytest.mark.slow
def test_coupled_stress_loop_vs_jax():
    """The smoke's loop phase on the CPU: the JAX bench's stress world
    s101_l1 (896 frames at 640x480, 6000 landmarks, a stationary pause, a
    texture dropout, one revolution, rendered by the port), the default
    SlamConfig, stationarity and gravity from its accelerometer, tracking
    in chunks of 128 with the in-run correction between chunks, RTS and
    `run_backend`. Cut to bound the CPU's memory: each package's frontend
    runs in batches of 8 frames and the trackers run on the stacked
    features (`pipeline.run_tracking(chunk=128)`, the chunk loop
    `run_coupled` runs), not through `run_coupled`'s 128-frame frontend
    batches. JAX's figures (printed) set the smoke's limits
    (`chip_smoke.JAX_STRESS`).

    Held on JAX's own features, where only the trackers differ: every
    decision equal (keyframes, tracking, 3D-3D, bridges, recoveries), the
    loop constraints equal, and each ATE (raw, smoothed, after the
    backend) under the smoke's limit, twice JAX's or 0.02 m. The in-run
    correction is held on the port's own states: at each call, JAX's
    `inrun_pgo_correct` and the port's take the same fold decision and fold
    the ring within 1e-4 m. The fold count itself may differ from JAX's
    run: the two trajectories drift apart by centimetres through the
    dropout, and the fold's floor (0.08 m at the newest keyframe) lies
    between the corrections that the two states ask for.

    With its own frontend the port is printed, not held: bf16 SuperPoint
    moves a few keypoints per frame (`tests/test_torch_frontend.py`), and
    on this world that changes the matches of one periodic PnP (frame
    340), where RANSAC-PnP accepts a pose 1.36 m off inside the 1.5 m jump
    gate and the blend moves the keyframe 0.68 m; JAX's `ransac_pnp`
    returns the same pose on those inputs."""
    from vslam_tpu.config import SlamConfig as JSlamConfig
    from vslam_tpu.core import pipeline as j_pl
    from vslam_tpu.core.state import FrameFeatures as JFrames
    from vslam_tpu.models import superpoint as j_sp
    from vslam_tpu_torch.core.state import FrameFeatures, from_numpy

    cfg_j, cfg_t = JSlamConfig(), SlamConfig()
    c = cfg_t.camera
    n, B = 896, 8
    d = t_syn.make_stress_image_sequence(n, width=c.width, height=c.height, fx=c.fx, fy=c.fy,
                                         cx=c.cx, cy=c.cy, num_landmarks=6000, seed=101,
                                         loops=1.0)
    stat = t_pl.detect_stationary(d["accel"], d["timestamps"],
                                  window=cfg_t.ekf.stationary_window_s,
                                  threshold=cfg_t.ekf.stationary_accel_std)
    gravity, h0 = t_pl.compute_gravity_direction(d["accel"], np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(
        stat, j_pl.detect_stationary(d["accel"], d["timestamps"]))
    ts32 = d["timestamps"].astype(np.float32)

    params = j_w.superpoint_params_from_npz(t_w.TRAINED_SP_NPZ)
    sp = j_sp.SuperPoint()

    @jax.jit
    def frontend_j(gray, dep):
        kps, desc = j_coupled._frontend_chunk(params, sp, gray, cfg_j)
        kpd = j_coupled._kp_depth(dep.astype(jnp.float32) / c.depth_scale, kps.xy, cfg_j)
        return kps.xy, desc, kpd, kps.valid

    parts = [jax.device_get(frontend_j(jnp.asarray(d["gray"][i:i + B]),
                                       jnp.asarray(d["depth_u16"][i:i + B])))
             for i in range(0, n, B)]
    xy, desc, depth, valid = (np.concatenate(p) for p in zip(*parts))
    frames_j = JFrames(xy=jnp.asarray(xy), desc=jnp.asarray(desc), depth=jnp.asarray(depth),
                       valid=jnp.asarray(valid), timestamp=jnp.asarray(ts32),
                       stationary=jnp.asarray(stat), frame_id=jnp.arange(n, dtype=jnp.int32))
    res_j = j_pl.run_tracking(frames_j, cfg_j, gravity=gravity, initial_height=h0, chunk=128)
    rb_j = j_pl.run_backend(res_j, cfg_j)
    oj = jax.tree.map(np.asarray, res_j.outputs)

    def ate(t_est):
        return _ate(d, t_est)

    def summary(res, rb, outs):
        tok = outs.tracking_ok
        return dict(ate_raw_m=ate(res.t), ate_smoothed_m=ate(res.t_smoothed),
                    ate_backend_m=ate(rb.t_smoothed),
                    backend_identity=bool(np.array_equal(rb.t_smoothed, res.t_smoothed)),
                    keyframes=int(outs.is_keyframe.sum()), lost=int((~tok).sum()),
                    bridged=int(outs.bridged.sum()), recovered=int(outs.recovered.sum()),
                    loops=int(np.asarray(res.final_state.loops.valid).sum()),
                    inrun_corrections=int(np.asarray(res.final_state.inrun_corrections)),
                    tracked_frac=round(float(tok[1:].mean()), 4))

    fig_j = summary(res_j, rb_j, oj)
    print(f"JAX (CPU): {fig_j}")

    # The port on JAX's features, each in-run call's state kept.
    pre_fold = []
    fold = t_pl.inrun_pgo_correct

    def keep(st, config):
        pre_fold.append(to_numpy(st))
        return fold(st, config)

    frames_t = FrameFeatures(*(torch.from_numpy(np.asarray(v)) for v in (
        xy, desc, depth, valid, ts32, stat, np.arange(n, dtype=np.int32))))
    t_pl.reset_stats()
    t_pl.inrun_pgo_correct = keep
    try:
        res_t = t_pl.run_tracking(frames_t, cfg_t, gravity=gravity, initial_height=h0,
                                  chunk=128, device="cpu")
    finally:
        t_pl.inrun_pgo_correct = fold
    solves = t_pl.STATS["pgo_solves"]
    rb_t = t_pl.run_backend(res_t, cfg_t)
    ot = to_numpy(res_t.outputs)
    fig_t = summary(res_t, rb_t, ot)
    print(f"port on JAX's features (CPU): {fig_t}, in-run calls {len(pre_fold)}, "
          f"solves {solves}")

    # The port with its own frontend.
    model = t_w.load_superpoint(device="cpu")
    parts = [t_fe.frontend_features(
        model, torch.from_numpy(d["gray"][i:i + B]),
        torch.from_numpy(d["depth_u16"][i:i + B].astype(np.int32)),
        torch.from_numpy(ts32[i:i + B]), torch.arange(i, i + B, dtype=torch.int32),
        torch.from_numpy(stat[i:i + B]), cfg_t) for i in range(0, n, B)]
    res_o = t_pl.run_tracking(FrameFeatures(*(torch.cat(f) for f in zip(*parts))), cfg_t,
                              gravity=gravity, initial_height=h0, chunk=128, device="cpu")
    oo = to_numpy(res_o.outputs)
    fig_o = summary(res_o, t_pl.run_backend(res_o, cfg_t), oo)
    decisions = ("is_keyframe", "tracking_ok", "used_3d3d", "bridged", "recovered")
    diffs = {k: int((getattr(oo, k) != getattr(oj, k)).sum()) for k in decisions}
    print(f"port with its own frontend (CPU): {fig_o}, decision differences {diffs}")

    for name in decisions:
        np.testing.assert_array_equal(getattr(ot, name), getattr(oj, name), err_msg=name)
    assert fig_t["loops"] == fig_j["loops"] >= 1 and 1 <= len(pre_fold) <= fig_j["loops"]
    for k in ("ate_raw_m", "ate_smoothed_m", "ate_backend_m"):
        assert fig_t[k] <= max(2 * fig_j[k], 0.02), (k, fig_t[k], fig_j[k])
    j_fold = jax.jit(lambda s: j_pl.inrun_pgo_correct(s, cfg_j))
    for st in pre_fold:
        a = jax.tree.map(np.asarray, j_fold(jax.tree.map(jnp.asarray, st)))
        b = to_numpy(fold(from_numpy(st, "cpu"), cfg_t))
        assert int(a.inrun_corrections) == int(b.inrun_corrections)
        np.testing.assert_allclose(b.keyframes.t, a.keyframes.t, atol=1e-4)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(chip_smoke.SIDE_WORLDS))
def test_side_worlds_full_size_vs_jax(name):
    """The smoke's mono, mono_depth, noise and holdout phases on the CPU:
    the default SlamConfig (`rgbd=False` for mono_depth, as the JAX bench
    runs it), 128 frames of the 6000-landmark world (radius 3.0) in chunks
    of 32: the seed-0 world with all-zero depth (mono), the same with the
    committed DepthNet filling keypoint depth (mono_depth), the seed-0
    world under `apply_sensor_noise(seed=0)` (noise), and the held-out v2
    worlds of seeds 40 and 41. JAX's `run_coupled` gives the ATE that the
    smoke's limit comes from (printed; `chip_smoke.SIDE_JAX`): sim(3) ATE
    of the raw trajectory for the mono worlds, raw ATE otherwise. The
    port's own run is held to that limit (twice JAX's, and at least
    0.02 m on the RGB-D worlds) and to JAX's tracked fraction less 0.05
    (`chip_smoke.side_tracked_floor`); its decisions are
    printed, not held: over 128 monocular frames the essential-matrix
    chain turns the bf16 keypoint differences into other decisions."""
    from vslam_tpu.config import SlamConfig as JSlamConfig

    spec = chip_smoke.SIDE_WORLDS[name]
    seed, family, noisy = spec["seed"], spec["family"], spec["noise"]
    zero_depth, use_dn, sim3 = spec["zero_depth"], spec["depthnet"], spec["sim3"]
    cfg_j, cfg_t = JSlamConfig(), SlamConfig()
    if use_dn:
        cfg_j, cfg_t = cfg_j.replace(rgbd=False), cfg_t.replace(rgbd=False)
    c = cfg_t.camera
    d = t_syn.make_image_sequence(128, width=c.width, height=c.height, fx=c.fx, fy=c.fy,
                                  cx=c.cx, cy=c.cy, seed=seed, num_landmarks=6000, radius=3.0,
                                  with_rgb=False, family=family)
    if noisy:
        d = t_syn.apply_sensor_noise(d, seed=0)
    S, H, W = 4, c.height, c.width
    dep = np.zeros_like(d["depth_u16"]) if zero_depth else d["depth_u16"]
    x = dict(gray=d["gray"].reshape(S, 32, H, W), depth=dep.reshape(S, 32, H, W),
             ts=d["timestamps"].astype(np.float32).reshape(S, 32),
             fid=np.arange(128, dtype=np.int32).reshape(S, 32), stat=np.zeros((S, 32), bool))
    params = j_w.superpoint_params_from_npz(t_w.TRAINED_SP_NPZ)
    dn_j = j_w.depthnet_params_from_npz(t_w.TRAINED_DN_NPZ) if use_dn else None
    dense = gridhash.init_dense_map(cfg_j.dense.hash_capacity, cfg_j.dense.cloud_capacity)
    _, _, oj = j_coupled.run_coupled(
        params, j_init(cfg_j), dense, *(jnp.asarray(x[k]) for k in ("gray", "depth")), None,
        *(jnp.asarray(x[k]) for k in ("ts", "fid", "stat")), cfg_j, depth_params=dn_j)
    oj = jax.tree.map(np.asarray, oj)
    dn_t = t_w.load_depthnet(device="cpu") if use_dn else None
    _, _, ot = t_coupled.run_coupled(
        t_w.load_superpoint(device="cpu"), t_init(cfg_t, device="cpu"), _dense0(cfg_t),
        torch.from_numpy(x["gray"]), torch.from_numpy(x["depth"].astype(np.int32)), None,
        torch.from_numpy(x["ts"]), torch.from_numpy(x["fid"]), torch.from_numpy(x["stat"]),
        cfg_t, depth_params=dn_t, device="cpu")
    ot = to_numpy(ot)

    def fig(o):
        tok = o.tracking_ok
        ate = t_ate.compute_ate(d["timestamps"], o.t, d["timestamps"], d["t"],
                                with_scale=sim3).rmse
        return dict(ate_m=round(float(ate), 6), tracked_frac=round(float(tok[1:].mean()), 4),
                    keyframes=int(o.is_keyframe.sum()),
                    essential_frames=int((~o.used_3d3d & tok).sum()),
                    mean_matches=round(float(o.num_matches[1:].mean()), 1))

    fj, ft = fig(oj), fig(ot)
    decisions = ("is_keyframe", "used_3d3d", "tracking_ok", "bridged", "recovered")
    print(f"{name}: JAX (CPU) {fj}; port (CPU) {ft}; decisions equal "
          f"{all(np.array_equal(getattr(ot, k), getattr(oj, k)) for k in decisions)}")
    assert np.isfinite(ot.t).all()
    limit = chip_smoke.side_ate_limit(fj["ate_m"], rgbd=not zero_depth)
    assert ft["ate_m"] <= limit, (ft, limit)
    assert ft["tracked_frac"] >= chip_smoke.side_tracked_floor(fj["tracked_frac"]), (ft, fj)
