"""The port's threefry keys and integer draws (`vslam_tpu_torch.ops.prng`)
against `jax.random`, bit for bit.

Tolerance: none. RANSAC in both packages samples its minimal sets from
these bits, so a single differing bit would send the two trackers down
different hypotheses.
"""

import numpy as np
import pytest

import jax
import torch

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


# ------------------------------------------------------------ float draws


@pytest.fixture()
def few_threads():
    """Few intra-op threads: PyTorch's CPU elementwise ops thrash when
    every test worker runs as many threads as there are cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

#
# The trainers' draws: `uniform` and `bernoulli` bit for bit; `normal`
# within 1e-6 (XLA's erfinv polynomial, whose log1p rounds apart from
# torch's on a few inputs; largest gap measured 4.8e-7 on 1e6 draws).

RANGES = [(0.0, 1.0), (-0.15, 0.15), (0.8, 1.2), (-0.08, 0.08), (-0.1, 0.1)]
SHAPES = [(7,), (4, 1, 1, 1), (2, 30, 40, 1), (30_000,)]


@pytest.mark.parametrize("lo,hi", RANGES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_uniform_equal(seed, lo, hi, few_threads):
    for shape in SHAPES:
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, minval=lo, maxval=hi))
        got = prng.uniform(prng.prng_key(seed), shape, lo, hi).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.5, 0.1, 0.9])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bernoulli_equal(seed, p, few_threads):
    for shape in SHAPES:
        want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), p, shape))
        got = prng.bernoulli(prng.prng_key(seed), p, shape).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_1e6(seed, few_threads):
    shape = (50_000,)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(prng.prng_key(seed), shape).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6


def test_epoch_batch_indices_equal():
    """`make_epoch`'s draw per step: fold_in(base, i) for a vector of step
    counters, split, randint over the staged dataset (the JAX epoch's
    `fold_in` / `split` / `randint` per scanned step)."""
    base_j, base_t = jax.random.PRNGKey(13), prng.prng_key(13)
    steps, batch, n = 50, 16, 384
    keys = prng.fold_in(base_t, torch.arange(steps))
    for i in range(steps):
        k1j, k2j = jax.random.split(jax.random.fold_in(base_j, i))
        k1t, k2t = prng.split(keys[:, i], 2)
        np.testing.assert_array_equal(k2t.numpy(), _np(k2j))
        np.testing.assert_array_equal(
            prng.randint(k1t, (batch,), 0, n).numpy(),
            np.asarray(jax.random.randint(k1j, (batch,), 0, n)))
