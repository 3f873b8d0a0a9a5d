"""The port's writers and readers (`vslam_tpu_torch.io`) against the JAX
package's `vslam_tpu.io`: PLY and TUM trajectory files byte for byte,
and state checkpoints loaded across the two packages in both directions.

Tolerance: none. The PLY writer formats the same f32/uint8 arrays; the
trajectory writer formats f32 quaternions from the same Shepperd
construction, printed to 6 decimals (the quaternions themselves agree
within 1e-6, `tests/test_torch_geometry.py`); checkpoint leaves are equal
bit for bit (bf16 leaves widen to f32 and narrow back exactly). A run
resumed from a checkpoint equals the uninterrupted run exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vslam_tpu.config import tiny_test_config as j_tiny
from vslam_tpu.io import checkpoint as j_ckpt
from vslam_tpu.io import ply as j_ply
from vslam_tpu.io import trajectory as j_traj
from vslam_tpu_torch.config import tiny_test_config
from vslam_tpu_torch.core import pipeline as t_pl
from vslam_tpu_torch.core import state as t_state
from vslam_tpu_torch.data import synthetic as t_syn
from vslam_tpu_torch.io import checkpoint as t_ckpt
from vslam_tpu_torch.io import ply as t_ply
from vslam_tpu_torch.io import trajectory as t_traj


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _cloud(rng, n=257):
    pts = rng.normal(0, 2, (n, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    nrm = rng.normal(0, 1, (n, 3)).astype(np.float32)
    return pts, cols, nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)


@pytest.mark.parametrize("ascii", [False, True])
@pytest.mark.parametrize("fields", ["points", "colors", "normals", "all", "float_colors"])
def test_ply_bytes_equal_jax(tmp_path, rng, ascii, fields):
    pts, cols, nrm = _cloud(rng)
    kw = dict(points=pts)
    if fields in ("colors", "all"):
        kw["colors"] = cols
    if fields == "float_colors":
        kw["colors"] = cols.astype(np.float32) / 255.0
    if fields in ("normals", "all"):
        kw["normals"] = nrm
    if fields == "all":
        kw["faces"] = [[0, 1, 2], [3, 4, 5, 6]]
    j_ply.save_ply(str(tmp_path / "j.ply"), ascii=ascii, **kw)
    t_ply.save_ply(str(tmp_path / "t.ply"), ascii=ascii,
                   **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                      for k, v in kw.items()})
    assert _bytes(tmp_path / "t.ply") == _bytes(tmp_path / "j.ply")
    back = t_ply.load_ply(str(tmp_path / "t.ply"))
    np.testing.assert_allclose(back["points"], pts, atol=0 if not ascii else 1e-6)
    if fields in ("colors", "all"):
        np.testing.assert_array_equal(back["colors"], cols)
    if fields == "all":
        assert back["faces"] == kw["faces"]
        np.testing.assert_allclose(back["normals"], nrm, atol=0 if not ascii else 1e-6)


def test_trajectory_bytes_equal_jax(tmp_path):
    d = t_syn.make_stress_image_sequence(40, width=64, height=48, fx=50.0, fy=50.0, cx=31.5,
                                         cy=23.5, num_landmarks=50, seed=3)
    ts, R, t = d["timestamps"], d["R"], d["t"]
    # rotations of every kind: the trajectory's, and the four Shepperd branches
    rng = np.random.default_rng(0)
    extra = np.stack([np.diag(s) for s in ([1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1])]
                     + [np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(8)])
    extra[4:] *= np.sign(np.linalg.det(extra[4:]))[:, None, None]
    R = np.concatenate([R, extra.astype(np.float32)])
    t = np.concatenate([t, rng.normal(0, 1, (12, 3)).astype(np.float32)])
    ts = np.concatenate([ts, ts[-1] + 0.1 * np.arange(1, 13)])
    j_traj.save_trajectory_full(str(tmp_path / "jf.txt"), ts, R, t)
    t_traj.save_trajectory_full(str(tmp_path / "tf.txt"), torch.from_numpy(ts),
                                torch.from_numpy(R), torch.from_numpy(t))
    assert _bytes(tmp_path / "tf.txt") == _bytes(tmp_path / "jf.txt")
    j_traj.save_trajectory(str(tmp_path / "jp.txt"), ts, t)
    t_traj.save_trajectory(str(tmp_path / "tp.txt"), ts, torch.from_numpy(t))
    assert _bytes(tmp_path / "tp.txt") == _bytes(tmp_path / "jp.txt")
    ts_b, pos_b, q_b = t_traj.load_trajectory(str(tmp_path / "tf.txt"))
    np.testing.assert_allclose(ts_b, ts, atol=1e-6)
    np.testing.assert_allclose(pos_b, t, atol=1e-6)
    assert q_b.shape == (len(ts), 4) and (q_b[:, 3] >= 0).all()
    assert t_traj.load_trajectory(str(tmp_path / "tp.txt"))[2][0].tolist() == [0, 0, 0, 1]


def _random_state(cfg, seed):
    """The port's initial state with every leaf filled from a seed."""
    rng = np.random.default_rng(seed)

    def fill(x):
        shape = tuple(x.shape)
        if x.dtype == torch.bool:
            return torch.from_numpy(np.asarray(rng.random(shape) > 0.5))
        if x.dtype == torch.int32:
            return torch.from_numpy(np.asarray(rng.integers(-5, 500, shape), np.int32))
        return torch.from_numpy(np.asarray(rng.normal(0, 1, shape), np.float32)).to(x.dtype)

    leaves = [fill(x) for x in t_ckpt._leaves(t_state.init_state(cfg, device="cpu"))]
    return t_ckpt._unflatten(t_state.init_state(cfg, device="cpu"), iter(leaves))


def _as_f32(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def test_checkpoint_port_to_jax_and_back(tmp_path):
    cfg_t, cfg_j = tiny_test_config(), j_tiny()
    st = _random_state(cfg_t, 1)
    t_ckpt.save_state(str(tmp_path / "t.npz"), st, metadata={"frame": 7})
    st_j, meta = j_ckpt.load_state(str(tmp_path / "t.npz"), cfg_j)
    assert meta == {"frame": 7}
    lt, lj = t_ckpt._leaves(st), jax.tree.leaves(st_j)
    assert len(lt) == len(lj) == 55
    for a, b in zip(lt, lj):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.float().numpy() if a.dtype == torch.bfloat16
                                      else a.numpy(), _as_f32(b))
    assert lj[next(i for i, x in enumerate(lt) if x is st.map.desc)].dtype == jnp.bfloat16

    j_ckpt.save_state(str(tmp_path / "j.npz"), st_j, metadata={"by": "jax"})
    back, meta = t_ckpt.load_state(str(tmp_path / "j.npz"), cfg_t, device="cpu")
    assert meta == {"by": "jax"}
    for a, b in zip(t_ckpt._leaves(back), lt):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_refuses_another_config(tmp_path):
    cfg = tiny_test_config()
    t_ckpt.save_state(str(tmp_path / "s.npz"), t_state.init_state(cfg, device="cpu"))
    bigger = cfg.replace(map=cfg.map.__class__(map_capacity=1024, keyframe_capacity=16))
    with pytest.raises(ValueError):
        t_ckpt.load_state(str(tmp_path / "s.npz"), bigger, device="cpu")


def test_resume_from_checkpoint_equals_the_uninterrupted_run(tmp_path):
    """Feature-level frames of `make_sequence`: 12 frames tracked in
    chunks of 4; a checkpoint after chunk 1, loaded and tracked through
    chunks 2-3, ends in the uninterrupted run's state and outputs."""
    cfg = tiny_test_config()
    c = cfg.camera
    seq = t_syn.make_sequence(12, max_keypoints=cfg.frontend.max_keypoints,
                              desc_dim=cfg.frontend.descriptor_dim, fx=c.fx, fy=c.fy, cx=c.cx,
                              cy=c.cy, width=c.width, height=c.height, num_landmarks=600,
                              seed=5)
    frames = t_state.FrameFeatures(
        xy=torch.from_numpy(seq.kp_xy), desc=torch.from_numpy(seq.kp_desc),
        depth=torch.from_numpy(seq.kp_depth), valid=torch.from_numpy(seq.kp_valid),
        timestamp=torch.from_numpy(seq.timestamps.astype(np.float32)),
        stationary=torch.zeros(12, dtype=torch.bool), frame_id=torch.arange(12, dtype=torch.int32))

    def chunk(k):
        return t_state.FrameFeatures(*(f[4 * k:4 * k + 4] for f in frames))

    st = t_state.init_state(cfg, device="cpu")
    outs = []
    for k in range(3):
        st, out = t_pl.track_chunk(st, chunk(k), list(range(4 * k, 4 * k + 4)), cfg, 42)
        outs.append(out)
        if k == 0:
            t_ckpt.save_state(str(tmp_path / "c.npz"), st)
    st_r, _ = t_ckpt.load_state(str(tmp_path / "c.npz"), cfg, device="cpu")
    for k in (1, 2):
        st_r, out = t_pl.track_chunk(st_r, chunk(k), list(range(4 * k, 4 * k + 4)), cfg, 42)
        for a, b in zip(out, outs[k]):
            assert torch.equal(a, b)
    for a, b in zip(t_ckpt._leaves(st_r), t_ckpt._leaves(st)):
        assert torch.equal(a, b)
    assert int(st.kf_count) >= 2
