"""The port's tracking step (`vslam_tpu_torch.core.tracking`) against the
JAX package's `make_scan_step` in `lax.scan`, fed the SAME FrameFeatures
(taken from the JAX frontend) and the same threefry keys.

The 40-frame run of the tiny configuration is edited so that every branch
of the step runs at least once: bootstrap, proactive and stationary
keyframes, a frame whose descriptors are scrambled (bridge promotion,
then the recovery attempt against the whole map), a frame without depth
(the 3D-3D RANSAC fails, the essential fallback and its scale chain
run), F-gate, EKF, local-map radius match, PnP refine, reprojection
cull, map cull, periodic PnP and the loop-closure match stage. Loop
verification and a successful recovery need a revisit the short run
never reaches, so `_handle_loop_closure` and `_try_pnp_recovery` are also
called directly on a state whose keyframe ring holds a keyframe older
than `loop.min_frame_gap`.

Tolerance: integer and bool StepOutputs fields equal; R, t and the EKF
snapshots within 1e-4 (f32 rounding in another order through the RANSAC
refits, GN refinements and the filter); the final TrackState leaf by
leaf after the first 8 frames: integer/bool leaves equal, float leaves
within 1e-4 (map point positions, back-projected from poses, within
1e-3 m).

One exception, the F-gate: it refits F over all matches with the 8-point
algorithm, whose shift-and-invert null vector amplifies f32 rounding when
the baseline is small. On a frame or two of the run the two packages'
F differ enough (mean epipolar error 1.32 vs 0.82 px on one frame) that
a match near the 3 px threshold flips. So `num_matches` and
`num_depth_ok` (both counted after the gate) may differ by 1 on at most
2 frames, and `epi_before` / `epi_after` agree to 1e-2 px on all but 2
frames; the poses downstream still agree to 1e-4. Where such a frame is
a keyframe, the map slots differ after it (see `test_final_state`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vslam_tpu.config import tiny_test_config as j_tiny
from vslam_tpu.core import coupled as j_coupled
from vslam_tpu.core import frontend as j_fe
from vslam_tpu.core import tracking as j_tr
from vslam_tpu.core.state import FrameFeatures as JFrame
from vslam_tpu.core.state import init_state as j_init
from vslam_tpu.data import synthetic as j_syn
from vslam_tpu.models import superpoint as j_sp
from vslam_tpu.models import weights as j_w
from vslam_tpu_torch.config import tiny_test_config
from vslam_tpu_torch.core import state as t_state
from vslam_tpu_torch.core import tracking as t_tr
from vslam_tpu_torch.models import weights as t_w
from vslam_tpu_torch.ops import prng

N_FRAMES = 40
CHUNK = 8
STATIONARY = (12, 13, 14)
SCRAMBLED = 20
NO_DEPTH = 27


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def run():
    """Both trackers over the same 40 edited frames."""
    cfg_j, cfg_t = j_tiny(), tiny_test_config()
    c = cfg_j.camera
    d = j_syn.make_image_sequence(
        N_FRAMES, width=c.width, height=c.height, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
        seed=0, num_landmarks=500, radius=2.0, with_rgb=False,
    )
    params = j_w.superpoint_params_from_npz(t_w.TRAINED_SP_NPZ)
    model = j_sp.SuperPoint()

    @jax.jit
    def frontend(g, dep):
        kps, desc = j_coupled._frontend_chunk(params, model, g, cfg_j)
        kpd = j_fe.sample_depth_at_keypoints(dep.astype(jnp.float32) / c.depth_scale, kps.xy)
        return kps.xy, desc, kpd, kps.valid

    xy, desc, kpd, valid = (np.array(x) for x in frontend(jnp.asarray(d["gray"]),
                                                          jnp.asarray(d["depth_u16"])))
    rng = np.random.default_rng(3)
    scr = rng.normal(size=desc[SCRAMBLED].shape).astype(np.float32)
    desc[SCRAMBLED] = scr / np.linalg.norm(scr, axis=-1, keepdims=True)
    kpd[NO_DEPTH] = 0.0
    stationary = np.zeros(N_FRAMES, bool)
    stationary[list(STATIONARY)] = True
    frames = JFrame(xy=xy, desc=desc, depth=kpd, valid=valid,
                    timestamp=d["timestamps"].astype(np.float32), stationary=stationary,
                    frame_id=np.arange(N_FRAMES, dtype=np.int32))

    # Chunks of 8 frames (one compile of the JAX scan), keeping the state
    # after the first chunk, which no edit touches.
    scan = jax.jit(lambda s, f: jax.lax.scan(j_tr.make_scan_step(cfg_j), s, f))
    st_j = j_init(cfg_j)
    st_t = t_state.from_numpy(_np_tree(st_j), "cpu")
    outs_j, outs_t = [], []
    for c0 in range(0, N_FRAMES, CHUNK):
        chunk = JFrame(*(x[c0:c0 + CHUNK] for x in frames))
        st_j, o = scan(st_j, jax.tree.map(jnp.asarray, chunk))
        outs_j.append(_np_tree(o))
        st_t, o = t_tr.run_frames(st_t, t_state.from_numpy(chunk, "cpu"),
                                  list(range(c0, c0 + CHUNK)), cfg_t)
        outs_t.append(t_state.to_numpy(o))
        if c0 == 0:
            first = (_np_tree(st_j), t_state.to_numpy(st_t))
    cat = lambda outs: type(outs[0])(*(np.concatenate(f) for f in zip(*outs)))  # noqa: E731
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, frames=frames, first=first,
                st_j=st_j, out_j=cat(outs_j), st_t=st_t, out_t=cat(outs_t))


def test_step_outputs_equal(run):
    oj, ot = run["out_j"], run["out_t"]
    for name in oj._fields:
        a, b = getattr(oj, name), getattr(ot, name)
        assert a.shape == b.shape, name
        if name in ("num_matches", "num_depth_ok"):
            d = np.abs(a.astype(int) - b)
            assert d.max() <= 1 and (d > 0).sum() <= 2, (name, a, b)
        elif name in ("epi_before", "epi_after"):
            assert (np.abs(a - b) > 1e-2).sum() <= 2, (name, a, b)
        elif a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4, err_msg=name)


def test_every_branch_ran(run):
    o, st = run["out_t"], run["st_t"]
    assert o.is_keyframe[0] and o.is_keyframe.sum() >= 6  # periodic PnP at the 5th KF
    assert o.bridged[SCRAMBLED] and not o.tracking_ok[SCRAMBLED]
    assert not o.used_3d3d[NO_DEPTH] and o.num_depth_ok[NO_DEPTH] == 0
    assert o.used_3d3d.sum() >= N_FRAMES - 4
    assert (o.epi_before[1:] > 0).any()  # F-gate ran
    assert (o.t[list(STATIONARY)] == o.t[STATIONARY[0] - 1]).all()
    assert int(st.kf_count) >= 8  # loop check at the 8th keyframe
    assert (np.delete(o.num_tracked, [0, SCRAMBLED]) > 0).all()


def _state_leaves(st_j, st_t):
    sj = jax.tree_util.tree_flatten_with_path(st_j)[0]
    st = jax.tree.leaves(st_t)
    assert len(sj) == len(st)
    for (path, a), b in zip(sj, st):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        yield jax.tree_util.keystr(path), a, b


def _assert_leaf(name, a, b):
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(b, a, err_msg=name)
    else:
        atol = 1e-3 if name.startswith(".map.pos") else 1e-4
        np.testing.assert_allclose(b, a, atol=atol, rtol=1e-4, err_msg=name)


def test_state_after_first_chunk_leaf_by_leaf(run):
    """Frames 0-7: bootstrap, F-gate, 3D-3D, EKF, local map, PnP refine and
    the keyframe at frame 5, before any edited frame: every leaf agrees."""
    for name, a, b in _state_leaves(*run["first"]):
        _assert_leaf(name, a, b)


def test_final_state(run):
    """After all 40 frames. A flipped F-gate decision at a keyframe
    inserts one map point more or less, which shifts the slots of the
    points inserted after it, so the map store is held by its live count
    (within 2%); every other leaf agrees as after the first chunk."""
    for name, a, b in _state_leaves(_np_tree(run["st_j"]), t_state.to_numpy(run["st_t"])):
        if name == ".map.valid":
            assert abs(int(a.sum()) - int(b.sum())) <= 0.02 * a.sum()
        elif not name.startswith(".map."):
            _assert_leaf(name, a, b)


def _frame(frames, i, frame_id=None, to_torch=False):
    f = JFrame(*(np.asarray(x[i]) for x in frames))
    if frame_id is not None:
        f = f._replace(frame_id=np.int32(frame_id))
    if to_torch:
        f = t_state.from_numpy(f, "cpu")
        return f._replace(desc=f.desc.to(torch.bfloat16))
    f = jax.tree.map(jnp.asarray, f)
    return f._replace(desc=f.desc.astype(jnp.bfloat16))


def _keys(fid, which):
    kj = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(42), fid), 7)[which]
    kt = prng.split(prng.fold_in(prng.prng_key(42), fid), 7)[which]
    return kj, kt


def test_recovery_direct(run):
    """Recovery of a healthy frame against the whole map (the top-2
    matcher's plain version here, the CUDA kernel on the card)."""
    cfg_j, cfg_t = run["cfg_j"], run["cfg_t"]
    kj, kt = _keys(N_FRAMES - 1, 3)
    fj = _frame(run["frames"], N_FRAMES - 1)
    ft = _frame(run["frames"], N_FRAMES - 1, to_torch=True)
    Rj, tj, okj = jax.jit(lambda s, f: j_tr._try_pnp_recovery(s, f, cfg_j, kj))(run["st_j"], fj)
    Rt, tt, okt = t_tr._try_pnp_recovery(run["st_t"], ft, cfg_t, kt)
    assert bool(okt) == bool(okj)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)


def test_loop_closure_direct(run):
    """A revisit: frame 4 seen again as frame 4 + 300, after the first
    keyframe (frame 0) has aged past loop.min_frame_gap. Match stage,
    E-RANSAC verify, anchor PnP, tight polish and the constraint write."""
    cfg_j, cfg_t = run["cfg_j"], run["cfg_t"]
    fid = 4 + 300
    kj, kt = _keys(fid, 4)
    out = run["out_j"]
    R_new, t_new = out.R[4], out.t[4] + np.float32(0.03)
    fj = _frame(run["frames"], 4, fid)
    ft = _frame(run["frames"], 4, fid, to_torch=True)
    sj = jax.jit(lambda s, f, R, t: j_tr._handle_loop_closure(s, f, cfg_j, R, t, kj))(
        run["st_j"], fj, jnp.asarray(R_new), jnp.asarray(t_new))
    st = t_tr._handle_loop_closure(run["st_t"], ft, cfg_t, torch.from_numpy(R_new),
                                   torch.from_numpy(t_new), kt)
    lj, lt = _np_tree(sj.loops), t_state.to_numpy(st.loops)
    assert bool(lt.valid[0])  # the verify stage ran and accepted
    for name in lj._fields:
        a, b = getattr(lj, name), getattr(lt, name)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, atol=1e-4, err_msg=name)
