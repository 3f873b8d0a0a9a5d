"""The port's threefry keys and integer draws (`vslam_tpu_torch.ops.prng`)
against `jax.random`, bit for bit.

Tolerance: none. RANSAC in both packages samples its minimal sets from
these bits, so a single differing bit would send the two trackers down
different hypotheses.
"""

import numpy as np
import pytest

import jax

from vslam_tpu_torch.ops import prng

SEEDS = [0, 1, 42, 2**31 - 1, 123456789]
FRAME_IDS = [0, 1, 7, 127, 128, 4095, 2**20 + 3]


def _np(key):
    """A raw uint32 jax key as int64 words, the port's key layout."""
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_equal(seed):
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(), _np(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_split_equal(seed):
    for fid in FRAME_IDS:
        kj = jax.random.fold_in(jax.random.PRNGKey(seed), fid)
        kt = prng.fold_in(prng.prng_key(seed), fid)
        np.testing.assert_array_equal(kt.numpy(), _np(kj))
        for num in (2, 7):
            np.testing.assert_array_equal(
                prng.split(kt, num).numpy(), _np(jax.random.split(kj, num))
            )


@pytest.mark.parametrize("span", [3, 8, 50, 400, 1000, 16384])
def test_randint_equal(span):
    """`randint(key, (B, s), 0, n)` as `ops.ransac.sample_minimal_sets`
    draws it, over seeds x frame ids and the set sizes of the trackers."""
    for seed in SEEDS[:3]:
        for fid in FRAME_IDS[:4]:
            kj = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), fid), 7)[1]
            kt = prng.split(prng.fold_in(prng.prng_key(seed), fid), 7)[1]
            for shape in ((256, 3), (128, 8), (5,)):
                want = np.asarray(jax.random.randint(kj, shape, 0, span, dtype=np.int32))
                got = prng.randint(kt, shape, 0, span).numpy()
                np.testing.assert_array_equal(got, want)


def test_randint_nonzero_minval_equal():
    kj = jax.random.PRNGKey(5)
    kt = prng.prng_key(5)
    want = np.asarray(jax.random.randint(kj, (64,), 10, 37, dtype=np.int32))
    np.testing.assert_array_equal(prng.randint(kt, (64,), 10, 37).numpy(), want)
