"""`vslam_tpu_torch.parallel.mesh` and the scan-step builders against the
JAX package, on the CPU at the tiny configuration.

The mesh runs one worker process per rank (spawned, joined in a gloo
group); the tests use 2 CPU ranks. Sharded runs are held equal to the
solo runs to the last digit (the same code on the same inputs, in another
process); the within-device forms against JAX's `batched_tracking_scan`
within 1e-5 (the port's batched step follows the JAX package's rounding
as closely as the single-sequence step does: `tests/test_torch_tracking_batched.py`);
the diagnostics equal JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vslam_tpu.config import tiny_test_config as j_tiny
from vslam_tpu.core import state as j_state
from vslam_tpu.core import tracking as j_tr
from vslam_tpu.core import tracking_batched as j_tb
from vslam_tpu.parallel import mesh as j_mesh
from vslam_tpu_torch.config import tiny_test_config
from vslam_tpu_torch.core import pipeline, tracking, tracking_batched
from vslam_tpu_torch.core import state as t_state
from vslam_tpu_torch.data import synthetic
from vslam_tpu_torch.ops import gridhash
from vslam_tpu_torch.parallel import mesh as pm

torch.set_num_threads(2)

B, N = 2, 12


def _features(cfg, seed, n=N):
    c = cfg.camera
    seq = synthetic.make_sequence(
        num_frames=n, max_keypoints=cfg.frontend.max_keypoints,
        desc_dim=cfg.frontend.descriptor_dim, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
        width=c.width, height=c.height, seed=seed, num_landmarks=600)
    return pipeline.features_from_synthetic(seq, device="cpu")


def _solo(cfg, fr):
    return tracking.run_frames(t_state.init_state(cfg, device="cpu"), fr,
                               fr.frame_id.tolist(), cfg)


def _assert_trees_equal(got, want, what):
    if type(got) is tuple:  # a (state, outputs) pair
        for g, w in zip(got, want):
            _assert_trees_equal(g, w, what)
        return
    for i, (a, x) in enumerate(zip(jax.tree.leaves(t_state.to_numpy(got)),
                                   jax.tree.leaves(t_state.to_numpy(want)))):
        np.testing.assert_array_equal(a, x, err_msg=f"{what} leaf {i}")


def _jax_tree(cls, tree):
    """A port tree as the JAX package's NamedTuple of jnp arrays (bf16
    leaves widened back from their bit view)."""
    def leaf(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return cls(*(leaf(getattr(tree, f)) for f in cls._fields))


@pytest.fixture(scope="module")
def cfg():
    return tiny_test_config()


@pytest.fixture(scope="module")
def feats(cfg):
    return [_features(cfg, s) for s in range(B)]


@pytest.fixture(scope="module")
def solo(cfg, feats):
    return [_solo(cfg, f) for f in feats]


@pytest.fixture(scope="module")
def mesh():
    m = pm.make_mesh(B, device="cpu")
    yield m
    m.close()


def test_make_mesh(monkeypatch):
    m = pm.make_mesh(3, axis="x", device="cpu")
    assert m.size == 3 and m.axis == "x" and all(d.type == "cpu" for d in m.devices)
    assert pm.make_mesh(device="cpu").size == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.make_mesh(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 device"):
        pm.make_mesh(2)
    assert [str(d) for d in pm.make_mesh().devices] == ["cuda:0"]


def test_shard_batched_members_own_their_storage(cfg, feats):
    m = pm.make_mesh(B, device="cpu")
    states = pm.replicate_state(cfg, B, device="cpu")
    shards = pm.shard_batched(states, m)
    assert len(shards) == B and shards[0].kf_R.shape[0] == 1
    ptrs = {s.keyframes.desc.untyped_storage().data_ptr() for s in shards}
    assert len(ptrs) == B and states.keyframes.desc.untyped_storage().data_ptr() not in ptrs
    shards[0].keyframes.desc.fill_(1)  # a write to one member's ring ...
    assert not shards[1].keyframes.desc.any() and not states.keyframes.desc.any()
    frames = pm.shard_batched(t_state.stack_trees(feats), m)
    _assert_trees_equal(t_state.member(frames[1], 0), feats[1], "frames")
    with pytest.raises(ValueError, match="does not divide"):
        pm.shard_batched(pm.replicate_state(cfg, 3, device="cpu"), m)


def test_scan_steps_equal_jax_on_one_frame(cfg, feats):
    """`make_scan_step` / `make_batched_scan_step` against JAX's, each run
    over frames 0 (bootstrap) and 1 of each member, with and without the
    host frame id; the keying is `fold_in(PRNGKey(seed), frame_id)`."""
    cfg_j, seed = j_tiny(), 7
    step = tracking.make_scan_step(cfg, seed)
    jstep = jax.jit(j_tr.make_scan_step(cfg_j, seed))
    for f in feats:
        st = t_state.init_state(cfg, device="cpu")
        js = j_state.init_state(cfg_j)
        for i in range(2):
            fr = tracking.frame_at(f, i)
            again = step(t_state.clone_tree(st), fr, i)
            st, out = step(st, fr)
            _assert_trees_equal(again, (st, out), f"host frame id, frame {i}")
            js, jout = jstep(js, _jax_tree(j_state.FrameFeatures, fr))
        _close(out, jout)
    bstep = tracking_batched.make_batched_scan_step(cfg, seed)
    jb = jax.jit(j_tb.make_batched_scan_step(cfg_j, seed))
    sb, js = pm.replicate_state(cfg, B, device="cpu"), j_mesh.replicate_state(cfg_j, B)
    for i in range(2):
        fb = t_state.stack_trees([tracking.frame_at(f, i) for f in feats])
        again = bstep(t_state.clone_tree(sb), fb, [i] * B)
        sb, out = bstep(sb, fb)
        _assert_trees_equal(again, (sb, out), f"host frame ids, frame {i}")
        js, jout = jb(js, _jax_tree(j_state.FrameFeatures, fb))
    _close(out, jout)


def _close(got, want, atol=1e-5):
    """Step outputs against JAX's: counts and flags equal, floats within
    `atol`, the F-gate's epipolar errors within 1e-3 (its 8-point refit
    over the gated matches rounds apart; measured 3.5e-5 on the one-frame
    case)."""
    for f in type(got)._fields:
        a, x = np.asarray(getattr(want, f)), t_state.to_numpy(getattr(got, f))
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(x, a, err_msg=f)
        else:
            tol = 1e-3 if f.startswith("epi_") else atol
            np.testing.assert_allclose(x, a, atol=tol, rtol=tol, err_msg=f)


def _close_scan(got, want):
    """(B, N) scan outputs against JAX's: every count and flag equal,
    floats within 1e-5 (measured 3.7e-6, x_filt), the F-gate's epipolar
    errors within 5e-3 (measured 2.9e-3: its 8-point refit over all gated
    matches sums a long axis, which XLA's CPU code orders its own way)."""
    for f in type(got)._fields:
        a, x = np.asarray(getattr(want, f)), t_state.to_numpy(getattr(got, f))
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(x, a, err_msg=f)
        elif f.startswith("epi_"):
            np.testing.assert_allclose(x, a, atol=5e-3, rtol=0, err_msg=f)
        else:
            np.testing.assert_allclose(x, a, atol=1e-5, rtol=1e-5, err_msg=f)


def test_vmapped_equals_batched_and_jax(cfg, feats, solo):
    states = pm.replicate_state(cfg, B, device="cpu")
    frames = t_state.stack_trees(feats)
    vs, vo = pm.vmapped_tracking_scan(states, frames, cfg)
    assert not states.keyframes.valid.any()  # the inputs stay as they were
    bs, bo = pm.batched_tracking_scan(pm.replicate_state(cfg, B, device="cpu"), frames, cfg)
    _assert_trees_equal(vo, bo, "outputs")
    _assert_trees_equal(vs, bs, "states")
    for b in range(B):
        _assert_trees_equal(t_state.member(vo, b), solo[b][1], f"member {b} vs solo")
    cfg_j = j_tiny()
    js = j_mesh.replicate_state(cfg_j, B)
    _, jo = j_mesh.batched_tracking_scan(js, _jax_tree(j_state.FrameFeatures, frames), cfg_j)
    _close_scan(vo, jo)


def test_sharded_tracking_scan_equals_solo(cfg, feats, solo, mesh):
    states = pm.replicate_state(cfg, B, device="cpu")
    frames = t_state.stack_trees(feats)
    st, outs = pm.sharded_tracking_scan(states, frames, cfg, mesh)
    st2, outs2 = pm.sharded_tracking_scan(pm.shard_batched(states, mesh),
                                          pm.shard_batched(frames, mesh), cfg, mesh)
    for b in range(B):
        _assert_trees_equal(t_state.member(outs, b), solo[b][1], f"member {b} outputs")
        _assert_trees_equal(t_state.member(st, b), solo[b][0], f"member {b} state")
    _assert_trees_equal(outs2, outs, "sharded inputs")
    for r, s in enumerate(mesh.stats):
        assert s["tracking"]["track_frames"] == N - 1, (r, s)
        assert s["launches"] == {"radius_match": 0, "radius_match_batched": 0, "top2_match": 0}
    with pytest.raises(ValueError, match="batch == mesh size"):
        pm.sharded_tracking_scan(pm.replicate_state(cfg, 3, device="cpu"),
                                 t_state.stack_trees(feats + feats[:1]), cfg, mesh)


def test_sharded_coupled_run_equals_solo(cfg, mesh):
    from vslam_tpu_torch.core import coupled
    from vslam_tpu_torch.models import weights

    c = cfg.camera
    model = weights.load_superpoint(device="cpu")
    xs = []
    for seed in range(B):
        d = synthetic.make_image_sequence(8, width=c.width, height=c.height, fx=c.fx, fy=c.fy,
                                          cx=c.cx, cy=c.cy, seed=seed, num_landmarks=500,
                                          radius=2.0, with_rgb=True)
        xs.append(dict(gray=d["gray"].reshape(2, 4, c.height, c.width),
                       depth=d["depth_u16"].astype(np.int32).reshape(2, 4, c.height, c.width),
                       rgb=d["rgb"].reshape(2, 4, c.height, c.width, 3),
                       ts=d["timestamps"].astype(np.float32).reshape(2, 4),
                       fid=np.arange(8, dtype=np.int32).reshape(2, 4),
                       stat=np.zeros((2, 4), bool)))
    T = {k: torch.from_numpy(np.stack([x[k] for x in xs])) for k in xs[0]}
    dense0 = gridhash.init_dense_map(cfg.dense.hash_capacity, cfg.dense.cloud_capacity,
                                     device="cpu")
    st, dn, outs = pm.sharded_coupled_run(
        model, pm.replicate_state(cfg, B, device="cpu"), t_state.stack_trees([dense0] * B),
        T["gray"], T["depth"], T["rgb"], T["ts"], T["fid"], T["stat"], cfg, mesh)
    for b in range(B):
        want = coupled.run_coupled(model, t_state.init_state(cfg, device="cpu"), dense0,
                                   *(T[k][b] for k in ("gray", "depth", "rgb", "ts", "fid",
                                                       "stat")), cfg, device="cpu")
        _assert_trees_equal(t_state.member(st, b), want[0], f"member {b} state")
        _assert_trees_equal(t_state.member(dn, b), want[1], f"member {b} dense map")
        _assert_trees_equal(t_state.member(outs, b), want[2], f"member {b} outputs")
    with pytest.raises(ValueError, match="batch == mesh size"):
        pm.sharded_coupled_run(model, None, None, T["gray"][:1], None, None, None, None, None,
                               cfg, mesh)


def test_batched_diagnostics_equal_jax(cfg, solo, mesh):
    outs = t_state.stack_trees([s[1] for s in solo])
    got = pm.batched_diagnostics(outs, mesh)
    want = j_mesh.batched_diagnostics(_jax_tree(j_state.StepOutputs, outs), j_mesh.make_mesh(B))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert int(got["keyframes"]) == int(outs.is_keyframe.sum()) > 0
    with pytest.raises(ValueError, match="does not divide"):
        pm.batched_diagnostics(t_state.stack_trees([s[1] for s in solo] * 3),
                               pm.make_mesh(4, device="cpu"))


@pytest.mark.slow
def test_sharded_tracking_scan_vs_jax_on_two_devices(cfg, feats, mesh):
    """Against JAX's `sharded_tracking_scan` on 2 virtual CPU devices."""
    cfg_j = j_tiny()
    frames = t_state.stack_trees(feats)
    _, outs = pm.sharded_tracking_scan(pm.replicate_state(cfg, B, device="cpu"), frames, cfg,
                                       mesh)
    jm = j_mesh.make_mesh(B)
    js = j_mesh.shard_batched(j_mesh.replicate_state(cfg_j, B), jm)
    jf = j_mesh.shard_batched(_jax_tree(j_state.FrameFeatures, frames), jm)
    _, jo = j_mesh.sharded_tracking_scan(js, jf, cfg_j, jm)
    _close_scan(outs, jo)
