"""The port's world cache (`vslam_tpu_torch.data.worldcache`) against the
JAX package's (`vslam_tpu.data.worldcache`), each in its own `tmp_path`
cache directory: the same tags and hashes, and for one small image world
and one small stress world (16 frames at 160x120) equal arrays, first
rendered and then read back from disk. A torn file is dropped and
rendered again; the writers leave no temporary file behind; the port's
default directory is not the JAX package's.
"""

import os

import numpy as np
import pytest

from vslam_tpu.data import worldcache as j_wc
from vslam_tpu_torch.data import synthetic as t_syn
from vslam_tpu_torch.data import worldcache as t_wc

CAM = dict(width=160, height=120, fx=120.0, fy=120.0, cx=79.5, cy=59.5)


@pytest.fixture()
def caches(tmp_path, monkeypatch):
    monkeypatch.setattr(j_wc, "CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(t_wc, "CACHE_DIR", str(tmp_path / "port"))
    return tmp_path


def test_tags_and_version_equal():
    from vslam_tpu.data import synthetic as j_syn

    assert t_syn.DATA_VERSION == j_syn.DATA_VERSION == 1
    kw = dict(seed=202, loops=2.5, pause=(0.3, 0.02), dropout=(0.6, 0.01))
    assert t_wc._kw_hash(kw) == j_wc._kw_hash(kw)
    args = (128, 640, 480, 3, 6000, 3.0, 525.0, 525.0, 319.5, 239.5)
    for fam in ("v1", "v2"):
        assert t_wc.image_world_tag(*args, family=fam) == j_wc.image_world_tag(*args, family=fam)
    assert (t_wc.stress_world_tag(896, 640, 480, 6000, "s101_l1", fx=525.0, seed=101)
            == j_wc.stress_world_tag(896, 640, 480, 6000, "s101_l1", fx=525.0, seed=101))
    assert t_wc.IMAGE_KEYS == j_wc.IMAGE_KEYS and t_wc.STRESS_KEYS == j_wc.STRESS_KEYS
    assert os.path.basename(t_wc.CACHE_DIR) == "vslam_worlds_torch"
    assert os.path.realpath(t_wc.CACHE_DIR) != os.path.realpath(j_wc.CACHE_DIR)


def _check(want, got, keys):
    assert sorted(got) == sorted(k for k in keys if k in want) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", ["image", "stress"])
def test_worlds_equal_and_cached(kind, caches):
    if kind == "image":
        kw = dict(seed=3, num_landmarks=300, radius=2.0, **CAM)
        want = j_wc.image_world(16, **kw)
        got = t_wc.image_world(16, **kw)
        again = t_wc.image_world(16, **kw)
        keys = t_wc.IMAGE_KEYS
        tag = t_wc.image_world_tag(16, 160, 120, 3, 300, 2.0, 120.0, 120.0, 79.5, 59.5)
    else:
        kw = dict(num_landmarks=300, seed=101, loops=1.0, **CAM)
        want = j_wc.stress_world("s101_l1", 16, **kw)
        got = t_wc.stress_world("s101_l1", 16, **kw)
        again = t_wc.stress_world("s101_l1", 16, **kw)
        keys = t_wc.STRESS_KEYS
        tag = t_wc.stress_world_tag(16, 160, 120, 300, "s101_l1", fx=120.0, fy=120.0,
                                    cx=79.5, cy=59.5, seed=101, loops=1.0)
    _check(want, got, keys)
    _check(want, again, keys)
    assert t_wc.is_cached(tag)
    assert os.listdir(t_wc.CACHE_DIR) == [f"v1_{tag}.npz"]  # no temporary file left


def test_torn_file_is_rendered_again(caches):
    kw = dict(seed=0, num_landmarks=200, radius=2.0, **CAM)
    tag = t_wc.image_world_tag(4, 160, 120, 0, 200, 2.0, 120.0, 120.0, 79.5, 59.5)
    os.makedirs(t_wc.CACHE_DIR)
    with open(t_wc._path(tag), "wb") as f:
        f.write(b"PK\x03\x04 torn")
    got = t_wc.image_world(4, **kw)
    want = t_syn.make_image_sequence(4, with_rgb=False, **kw)
    for k in t_wc.IMAGE_KEYS:
        np.testing.assert_array_equal(got[k], want[k])
    with np.load(t_wc._path(tag)) as z:
        np.testing.assert_array_equal(z["gray"], want["gray"])
