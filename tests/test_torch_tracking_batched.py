"""The port's multi-sequence step (`vslam_tpu_torch.core.tracking_batched`)
against the JAX package's per-sequence scan (`make_scan_step` in
`lax.scan`) and against the port's own single-sequence `run_frames`.

Three members track three synthetic worlds (seeds 0-2, tiny
configuration) through the JAX frontend's features, edited so that each
hoisted block of the batched step runs for one member while the others
skip it: member 0 gets a frame of scrambled descriptors (bridge, then a
recovery attempt), member 1 a frame without depth (essential fallback) and
three stationary frames, member 2 loses all its features for two frames
(the dropout case of `tests/test_tracking_batched.py`) and is restarted
with a fresh state partway (bootstrap for it alone, while the others
track). Keyframes, periodic PnP and the loop-closure check fall on other
frames for each world.

Tolerance. Against the port's solo run of the same member: decisions and
counts equal, poses within 1e-6 (measured: bit for bit; the batched plain
matcher is the single one applied member by member), and member 0's final
state, keyframe ring included, equal leaf by leaf. Against JAX: the
tolerances of `tests/test_torch_tracking.py` (integer and bool outputs
equal, poses and EKF snapshots within 1e-4), with its one exception: the
F-gate's 8-point refit may flip a match near the 3 px threshold, so
`num_matches` and `num_depth_ok` may differ by 1 on at most 2 frames of a
member and `epi_before` / `epi_after` by more than 1e-2 px on at most 2.
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
from vslam_tpu_torch.core import tracking_batched as t_tb
from vslam_tpu_torch.models import weights as t_w
from vslam_tpu_torch.parallel.mesh import replicate_state

B, N_STEPS, CHUNK = 3, 40, 8
SCRAMBLED = 20  # member 0
NO_DEPTH, STATIONARY = 27, (12, 13, 14)  # member 1
DROPOUT, RESTART = (7, 8), 24  # member 2: features lost; fresh state at step 24
BLOCKS = ("bootstrap", "bridge", "essential", "recover", "keyframe", "periodic_pnp", "loop")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _features(cfg_j, seed, n):
    """The JAX frontend's features of n frames of a tiny world, edited."""
    c = cfg_j.camera
    d = j_syn.make_image_sequence(
        n, width=c.width, height=c.height, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
        seed=seed, num_landmarks=500, radius=2.0, with_rgb=False,
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
    stationary = np.zeros(n, bool)
    if seed == 0:
        scr = np.random.default_rng(3).normal(size=desc[SCRAMBLED].shape).astype(np.float32)
        desc[SCRAMBLED] = scr / np.linalg.norm(scr, axis=-1, keepdims=True)
    elif seed == 1:
        kpd[NO_DEPTH] = 0.0
        stationary[list(STATIONARY)] = True
    else:
        valid[list(DROPOUT)] = False
    return JFrame(xy=xy, desc=desc, depth=kpd, valid=valid,
                  timestamp=d["timestamps"].astype(np.float32), stationary=stationary,
                  frame_id=np.arange(n, dtype=np.int32))


def _member_frames(feats):
    """Per member, the frame index it sees at each batch step."""
    idx = [list(range(N_STEPS)), list(range(N_STEPS)),
           list(range(RESTART)) + list(range(N_STEPS - RESTART))]
    return [JFrame(*(x[i] for x in f)) for f, i in zip(feats, idx)]


def _fresh_member(states, b, cfg):
    """A new sequence starts in slot b: its leaves become a fresh state's
    (in place, as a server would reuse the slot)."""
    fresh = t_state.init_state(cfg, device="cpu")
    for a, x in zip(jax.tree.leaves(states), jax.tree.leaves(fresh)):
        a[b].copy_(x)


@pytest.fixture(scope="module")
def run(monkeypatch_module):
    cfg_j, cfg_t = j_tiny(), tiny_test_config()
    feats = [_features(cfg_j, s, N_STEPS) for s in range(B)]
    per_step = _member_frames(feats)
    frames = JFrame(*(np.stack(f, axis=1) for f in zip(*per_step)))  # (N, B, ...)

    # Which members each hoisted block ran for, step by step.
    calls = []
    hoisted = t_tb._hoisted

    def record(block, records, attr):
        ran = hoisted(block, records, attr)
        calls.append((block, len(ran)))
        return ran

    monkeypatch_module.setattr(t_tb, "_hoisted", record)
    t_tb.reset_stats()
    states = replicate_state(cfg_t, B, device="cpu")
    outs = []
    for s0, s1 in ((0, RESTART), (RESTART, N_STEPS)):
        if s0 == RESTART:
            _fresh_member(states, 2, cfg_t)
        chunk = t_state.from_numpy(JFrame(*(x[s0:s1] for x in frames)), "cpu")
        states, o = t_tb.run_frames_batched(states, chunk, frames.frame_id[s0:s1].tolist(), cfg_t)
        outs.append(t_state.to_numpy(o))
    out_b = type(outs[0])(*(np.concatenate(f) for f in zip(*outs)))
    monkeypatch_module.undo()

    # Solo runs of each member's frames.
    solo = []
    for b, n in ((0, N_STEPS), (1, N_STEPS), (2, RESTART)):
        f = JFrame(*(x[:n] for x in feats[b]))
        st, o = t_tr.run_frames(t_state.init_state(cfg_t, device="cpu"),
                                t_state.from_numpy(f, "cpu"), list(range(n)), cfg_t)
        solo.append((st, t_state.to_numpy(o)))

    # JAX per-sequence scans, in chunks of 8 (one compile).
    scan = jax.jit(lambda s, f: jax.lax.scan(j_tr.make_scan_step(cfg_j), s, f))
    jax_out = []
    for b, n in ((0, N_STEPS), (1, N_STEPS), (2, RESTART)):
        st_j, os_ = j_init(cfg_j), []
        for c0 in range(0, n, CHUNK):
            chunk = JFrame(*(jnp.asarray(x[c0:c0 + CHUNK]) for x in feats[b]))
            st_j, o = scan(st_j, chunk)
            os_.append(_np_tree(o))
        jax_out.append(type(os_[0])(*(np.concatenate(f) for f in zip(*os_))))
    return dict(out_b=out_b, states=states, solo=solo, jax_out=jax_out, calls=calls,
                stats=dict(t_tb.STATS))


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _segments(out_b):
    """(member, batch-step slice, solo-run slice) for every stretch of a
    member's outputs."""
    return [(0, slice(0, N_STEPS), slice(0, N_STEPS)), (1, slice(0, N_STEPS), slice(0, N_STEPS)),
            (2, slice(0, RESTART), slice(0, RESTART)),
            (2, slice(RESTART, N_STEPS), slice(0, N_STEPS - RESTART))]


def test_members_equal_their_solo_runs(run):
    ob = run["out_b"]
    for b, sb, ss in _segments(ob):
        os_ = run["solo"][b][1]
        for name in ob._fields:
            a, x = getattr(ob, name)[sb, b], getattr(os_, name)[ss]
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(a, x, err_msg=f"member {b} {name}")
            else:
                np.testing.assert_allclose(a, x, atol=1e-6, rtol=0, err_msg=f"member {b} {name}")


def test_member0_final_state_equals_solo(run):
    """Member 0's whole final state, its keyframe ring included, after the
    other two made their keyframes (and member 2 restarted) in the same
    batched storage."""
    got = t_state.to_numpy(t_state.member(run["states"], 0))
    want = t_state.to_numpy(run["solo"][0][0])
    for (path, a), x in zip(jax.tree_util.tree_flatten_with_path(got)[0], jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, x, err_msg=jax.tree_util.keystr(path))


def test_members_vs_jax_scan(run):
    ob = run["out_b"]
    for b, sb, ss in _segments(ob):
        oj = run["jax_out"][b]
        for name in ob._fields:
            a, x = getattr(oj, name)[ss], getattr(ob, name)[sb, b]
            if name in ("num_matches", "num_depth_ok"):
                d = np.abs(a.astype(int) - x)
                assert d.max() <= 1 and (d > 0).sum() <= 2, (b, name, a, x)
            elif name in ("epi_before", "epi_after"):
                assert (np.abs(a - x) > 1e-2).sum() <= 2, (b, name, a, x)
            elif a.dtype.kind in "biu":
                np.testing.assert_array_equal(x, a, err_msg=f"member {b} {name}")
            else:
                np.testing.assert_allclose(x, a, atol=1e-4, rtol=1e-4, err_msg=f"member {b} {name}")


def test_each_hoisted_block_fires_for_one_member_alone(run):
    """Every hoisted block ran at some step for exactly one member; the
    edits land where they should."""
    ob, calls = run["out_b"], run["calls"]
    for block in BLOCKS:
        assert any(name == block and n == 1 for name, n in calls), block
    assert ob.bridged[SCRAMBLED, 0] and not ob.bridged[SCRAMBLED, 1:].any()
    assert not ob.used_3d3d[NO_DEPTH, 1] and ob.used_3d3d[NO_DEPTH, [0, 2]].all()
    assert not ob.tracking_ok[list(DROPOUT), 2].any() and ob.tracking_ok[list(DROPOUT), :2].all()
    assert ob.is_keyframe[RESTART, 2]  # member 2's bootstrap
    t1 = ob.t[:, 1]
    assert (t1[list(STATIONARY)] == t1[STATIONARY[0] - 1]).all()
    st = run["stats"]
    assert st["track_steps"] == N_STEPS - 1 and st["bootstrap"] == B + 1


def test_replicate_state_members_own_their_storage():
    """A keyframe push into member 0 leaves member 1's ring as it was."""
    cfg = tiny_test_config()
    states = replicate_state(cfg, 2, device="cpu")
    ring1 = t_state.to_numpy(t_state.member(states, 1).keyframes)
    m0 = t_state.member(states, 0)
    K, D = cfg.frontend.max_keypoints, cfg.frontend.descriptor_dim
    g = torch.Generator().manual_seed(0)
    frame = t_state.FrameFeatures(
        xy=torch.rand(K, 2, generator=g) * 100, desc=torch.randn(K, D, generator=g),
        depth=torch.full((K,), 2.0), valid=torch.ones(K, dtype=torch.bool),
        timestamp=torch.tensor(0.0), stationary=torch.tensor(False),
        frame_id=torch.tensor(0, dtype=torch.int32))
    t_tr._bootstrap(m0, frame._replace(desc=frame.desc.bfloat16()), cfg)
    assert bool(states.keyframes.valid[0, 0]) and states.keyframes.desc[0].abs().sum() > 0
    for a, x in zip(ring1, t_state.to_numpy(t_state.member(states, 1).keyframes)):
        np.testing.assert_array_equal(a, x)
    assert all(x.shape[0] == 2 for x in jax.tree.leaves(states))


def test_batched_scan_layout_and_reads():
    """`batched_tracking_scan` over (B, N, ...) frames equals
    `run_frames_batched` over (N, B, ...); the only values the step reads
    back are the branch predicates, each hoisted block's (B,) mask at
    once."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg = tiny_test_config()
    K, D, N = cfg.frontend.max_keypoints, cfg.frontend.descriptor_dim, 6
    rng = np.random.default_rng(0)
    base = rng.uniform(20, 140, (K, 2)).astype(np.float32)
    desc = rng.normal(size=(2, K, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    frames = t_state.FrameFeatures(
        xy=torch.from_numpy(np.broadcast_to(base + np.arange(N, dtype=np.float32)[:, None, None],
                                            (2, N, K, 2)).copy()),
        desc=torch.from_numpy(np.broadcast_to(desc[:, None], (2, N, K, D)).copy()),
        depth=torch.full((2, N, K), 2.0), valid=torch.ones(2, N, K, dtype=torch.bool),
        timestamp=torch.arange(N, dtype=torch.float32).repeat(2, 1) * 0.1,
        stationary=torch.zeros(2, N, dtype=torch.bool),
        frame_id=torch.arange(N, dtype=torch.int32).repeat(2, 1))

    reads, mask_reads = [], []

    class CountReads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket.__name__ in ("_local_scalar_dense", "nonzero"):
                reads.append(func)
            return func(*args, **(kwargs or {}))

    read = t_tb._read

    def counted(mask):
        mask_reads.append(mask.shape)
        return read(mask)

    t_tr.reset_stats()
    mp = pytest.MonkeyPatch()
    mp.setattr(t_tb, "_read", counted)
    try:
        with CountReads():
            st_a, out_a = t_tb.batched_tracking_scan(replicate_state(cfg, 2, "cpu"), frames, cfg)
    finally:
        mp.undo()
    assert mask_reads and all(s == (2,) or s == (1,) for s in mask_reads)
    # tolist() of a CPU tensor reaches no ATen op; every other read does.
    assert len(reads) + len(mask_reads) == t_tr.STATS["branch_reads"]
    st_b, out_b = t_tb.run_frames_batched(
        replicate_state(cfg, 2, "cpu"), t_state.FrameFeatures(*(x.transpose(0, 1) for x in frames)),
        [[i, i] for i in range(N)], cfg)
    for a, x in zip(out_a, out_b):
        assert torch.equal(a, x.transpose(0, 1))
    for a, x in zip(jax.tree.leaves(t_state.to_numpy(st_a)),
                    jax.tree.leaves(t_state.to_numpy(st_b))):
        np.testing.assert_array_equal(a, x)
