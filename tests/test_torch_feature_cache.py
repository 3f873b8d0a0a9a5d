"""The port's feature-replay cache (`vslam_tpu_torch.io.feature_cache`)
against the JAX package's: the SPCF writer gives the same bytes for the
same arrays, each package reads the other's files, and the padded and
npz round trips return what went in (all equal, no tolerance)."""

import numpy as np
import pytest

from vslam_tpu.io import feature_cache as j_fc
from vslam_tpu_torch.io import feature_cache as t_fc


def _padded(rng, N=5, K=12, D=8):
    xy = rng.uniform(0, 100, (N, K, 2)).astype(np.float32)
    score = rng.uniform(0, 1, (N, K)).astype(np.float32)
    desc = rng.normal(size=(N, K, D)).astype(np.float32)
    # Valid rows are a prefix of each frame (as the frontend packs them);
    # frame 2 has none.
    n_valid = np.array([K, 7, 0, 3, K - 1])
    valid = np.arange(K)[None, :] < n_valid[:, None]
    return xy, score, desc, valid


def test_spcf_bytes_equal_jax(tmp_path, rng):
    xy, score, desc, valid = _padded(rng)
    ids = np.array([0, 3, 6, 9, 12])
    cj = j_fc.from_padded(xy, score, desc, valid, frame_ids=ids)
    ct = t_fc.from_padded(xy, score, desc, valid, frame_ids=ids)
    pj, pt = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    j_fc.save_spcf(pj, cj)
    t_fc.save_spcf(pt, ct)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        data = a.read()
        assert data == b.read()
    assert data[:4] == (0x53504346).to_bytes(4, "little")
    # Each package reads the other's file as it reads its own (a frame
    # with no keypoint comes back with a (0, 0) descriptor block).
    for path, loader, ref in ((pj, t_fc.load_spcf, j_fc.load_spcf(pt)),
                              (pt, j_fc.load_spcf, t_fc.load_spcf(pj))):
        back = loader(path)
        assert sorted(back) == sorted(ref) == ids.tolist()
        for fid in ids:
            for a, b, c in zip(back[fid], ref[fid], cj[fid]):
                np.testing.assert_array_equal(a, b)
                if len(c):
                    np.testing.assert_array_equal(a, c)


def test_spcf_padded_round_trip(tmp_path, rng):
    xy, score, desc, valid = _padded(rng)
    path = str(tmp_path / "c.bin")
    t_fc.save_spcf(path, t_fc.from_padded(xy, score, desc, valid))
    got = t_fc.to_padded(t_fc.load_spcf(path), xy.shape[1], desc.shape[2])
    want = j_fc.to_padded(j_fc.load_spcf(path), xy.shape[1], desc.shape[2])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][valid], xy[valid])
    np.testing.assert_array_equal(got[2][valid], desc[valid])
    np.testing.assert_array_equal(got[3], valid)
    np.testing.assert_array_equal(got[4], np.arange(5))


def test_to_padded_truncates_to_capacity(rng):
    xy, score, desc, valid = _padded(rng, K=12, D=8)
    cache = t_fc.from_padded(xy, score, desc, valid)
    for K, D in ((5, 4), (20, 8)):
        got, want = t_fc.to_padded(cache, K, D), j_fc.to_padded(cache, K, D)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("frame_ids", [None, np.array([4, 8, 12, 16, 20])])
def test_npz_round_trip(tmp_path, rng, frame_ids):
    xy, score, desc, valid = _padded(rng)
    path = str(tmp_path / "c.npz")
    t_fc.save_npz(path, xy, score, desc, valid, frame_ids=frame_ids)
    got_t, got_j = t_fc.load_npz(path), j_fc.load_npz(path)
    ids = np.arange(5) if frame_ids is None else frame_ids
    for g, j, w in zip(got_t, got_j, (xy, score, desc, valid, ids)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(j, w)


def test_bad_header_raises(tmp_path):
    path = tmp_path / "bad.bin"
    path.write_bytes(b"\x00" * 12)
    with pytest.raises(ValueError, match="bad SPCF header"):
        t_fc.load_spcf(str(path))
