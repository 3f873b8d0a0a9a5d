"""The port's SuperPoint trainer (`vslam_tpu_torch.models.train_superpoint`)
against the JAX package's (`vslam_tpu.models.train_superpoint`), on the
CPU, at small sizes (64x80 or 120x160, batches of 2-4).

Both start from the same Flax parameters carried across
(`weights.superpoint_state_dict_from_flax`) and the same keys (the port's
`ops.prng` draws `jax.random`'s bits). Tolerances:
- the host generators (shapes, textured renders, both families): equal;
- `corners_to_cell_labels`: exact (masked corners, corners on the image
  border and sizes that are not multiples of 8 included);
- `random_homographies`, `warp_corners`: 1e-5 relative; `warp_images` and
  a step's augmented warped view: 1e-5 absolute (XLA contracts some
  products into FMAs);
- `detector_loss`, `descriptor_loss` in f32: 1e-5 relative;
- gradients of the whole step loss, f32 compute on both sides
  (`SuperPoint(compute_dtype=float32)` and `jax.grad`): 1e-4 relative L2
  per leaf.

The optimizer, whole steps, the training loops and the evaluation are in
`tests/test_torch_train_superpoint_step.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vslam_tpu.models import superpoint as j_sp
from vslam_tpu.models import train_superpoint as j_tsp
from vslam_tpu_torch.models import superpoint as t_sp
from vslam_tpu_torch.models import train_superpoint as t_tsp
from vslam_tpu_torch.models import weights as t_w
from vslam_tpu_torch.ops import prng


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Few intra-op threads: the small ops of a step thrash when every
    test worker runs as many threads as there are cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(scope="module")
def flax_params():
    return j_sp.init_params(jax.random.PRNGKey(0), height=64, width=80)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    return j_tsp.synthetic_shapes_batch(rng, 2, 64, 80)


def test_host_generators_equal():
    for fn, kw in ((t_tsp.synthetic_shapes_batch, {}), (t_tsp.textured_batch, {}),
                   (t_tsp.textured_batch, {"family": "v2"})):
        jfn = getattr(j_tsp, fn.__name__)
        want = jfn(np.random.default_rng(5), 2, 64, 80, **kw)
        got = fn(np.random.default_rng(5), 2, 64, 80, **kw)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(t_tsp._yaw_pitch_R(0.3, -0.1), j_tsp._yaw_pitch_R(0.3, -0.1))


@pytest.mark.parametrize("hw", [(64, 80), (68, 84)])
def test_corners_to_cell_labels_exact(hw):
    H, W = hw
    rng = np.random.default_rng(0)
    corners = rng.uniform(-5, [W + 5, H + 5], (3, 40, 2)).astype(np.float32)
    corners[:, :4] = [[0, 0], [W - 1, H - 1], [W - 0.5, 3], [7.9, 7.9]]
    corners[1, 10:14] = corners[1, 9]  # several corners in one cell
    cmask = rng.random((3, 40)) > 0.2
    want = np.asarray(j_tsp.corners_to_cell_labels(jnp.asarray(corners), jnp.asarray(cmask), H, W))
    got = t_tsp.corners_to_cell_labels(*_t(corners, cmask), H, W).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, H // 8, W // 8)


@pytest.mark.parametrize("seed", [0, 7])
def test_homographies_and_warps(seed, batch):
    imgs, corners, cmask = batch
    Hj = j_tsp.random_homographies(jax.random.PRNGKey(seed), 2, 64, 80)
    Ht = t_tsp.random_homographies(prng.prng_key(seed), 2, 64, 80)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-5, atol=1e-6)
    wj, ij = j_tsp.warp_images(jnp.asarray(imgs), Hj)
    wt, it = t_tsp.warp_images(torch.from_numpy(imgs), torch.from_numpy(np.asarray(Hj)))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-5, rtol=0)
    assert (it.numpy() != np.asarray(ij)).mean() < 1e-3  # pixels on the border
    cj, mj = j_tsp.warp_corners(jnp.asarray(corners), jnp.asarray(cmask), Hj, 64, 80)
    ct, mt = t_tsp.warp_corners(*_t(corners, cmask), torch.from_numpy(np.asarray(Hj)), 64, 80)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def _jax_prepare(imgs, corners, cmask, key, H, W):
    """`vslam_tpu/models/train_superpoint.py:269-301`, the step's inputs."""
    labels_a = j_tsp.corners_to_cell_labels(corners, cmask, H, W)
    k_h, k_p = jax.random.split(key)
    Hm = j_tsp.random_homographies(k_h, imgs.shape[0], H, W)
    warped, _ = j_tsp.warp_images(imgs, Hm)
    wc, wmask = j_tsp.warp_corners(corners, cmask, Hm, H, W)
    labels_b = j_tsp.corners_to_cell_labels(wc, wmask, H, W)
    kb, kg, ko, kn = jax.random.split(k_p, 4)
    B = imgs.shape[0]
    gain = jax.random.uniform(kg, (B, 1, 1, 1), minval=0.8, maxval=1.2)
    bias = jax.random.uniform(ko, (B, 1, 1, 1), minval=-0.08, maxval=0.08)
    blur_on = jax.random.bernoulli(kb, 0.5, (B, 1, 1, 1))
    xp = jnp.pad(warped, ((0, 0), (1, 1), (0, 0), (0, 0)), mode="edge")
    x = 0.25 * xp[:, :-2] + 0.5 * xp[:, 1:-1] + 0.25 * xp[:, 2:]
    xp = jnp.pad(x, ((0, 0), (0, 0), (1, 1), (0, 0)), mode="edge")
    blurred = 0.25 * xp[:, :, :-2] + 0.5 * xp[:, :, 1:-1] + 0.25 * xp[:, :, 2:]
    warped = jnp.where(blur_on, blurred, warped)
    warped = warped * gain + bias + 0.02 * jax.random.normal(kn, warped.shape)
    return warped, labels_a, labels_b, Hm


@pytest.fixture(scope="module")
def prepared(batch):
    imgs, corners, cmask = batch
    want = jax.jit(lambda *a: _jax_prepare(*a, 64, 80))(
        jnp.asarray(imgs), jnp.asarray(corners), jnp.asarray(cmask), jax.random.PRNGKey(11))
    got = t_tsp.prepare_step(*_t(imgs, corners, cmask), prng.prng_key(11), 64, 80)
    return [np.asarray(w) for w in want], got


def test_prepare_step_equals_jax(prepared):
    want, got = prepared
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_allclose(got[3].numpy(), want[3], rtol=1e-5, atol=1e-6)


def test_losses_f32():
    rng = np.random.default_rng(1)
    semi = rng.normal(size=(2, 8, 10, 65)).astype(np.float32) * 3
    labels = rng.integers(0, 65, (2, 8, 10))
    valid = (rng.random((2, 8, 10)) > 0.3).astype(np.float32)
    for v in (None, valid):
        want = float(j_tsp.detector_loss(jnp.asarray(semi), jnp.asarray(labels),
                                         None if v is None else jnp.asarray(v)))
        got = float(t_tsp.detector_loss(*_t(semi, labels), None if v is None else torch.from_numpy(v)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    da, db = (rng.normal(size=(2, 8, 10, 256)).astype(np.float32) for _ in range(2))
    db[:, 2:6] = da[:, 2:6] + 0.1 * db[:, 2:6]
    Hm = np.asarray(j_tsp.random_homographies(jax.random.PRNGKey(2), 2, 64, 80))
    with jax.default_matmul_precision("float32"):
        want = float(j_tsp.descriptor_loss(jnp.asarray(da), jnp.asarray(db), jnp.asarray(Hm)))
    got = float(t_tsp.descriptor_loss(*_t(da, db, Hm)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_gradients_per_leaf_f32(flax_params, batch, prepared):
    """The whole step loss's gradient, f32 compute on both sides."""
    imgs = batch[0]
    warped, la, lb, Hm = prepared[0]
    model_j = j_sp.SuperPoint(compute_dtype=jnp.float32)

    def loss_j(p):
        sa, da = model_j.apply(p, jnp.asarray(imgs))
        sb, db = model_j.apply(p, jnp.asarray(warped))
        return (j_tsp.detector_loss(sa, jnp.asarray(la)) + j_tsp.detector_loss(sb, jnp.asarray(lb))
                + j_tsp.descriptor_loss(da, db, jnp.asarray(Hm)))

    with jax.default_matmul_precision("float32"):
        lj, gj = jax.jit(jax.value_and_grad(loss_j))(flax_params)
    model_t = t_sp.SuperPoint(compute_dtype=torch.float32, device="cpu")
    model_t.load_state_dict(t_w.superpoint_state_dict_from_flax(flax_params["params"]))
    lt, _, _ = t_tsp.loss_fn(model_t, *_t(imgs, warped, la, lb, Hm))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    gt = {n: p.grad for n, p in model_t.named_parameters()}
    gsd = t_w.superpoint_state_dict_from_flax(jax.tree.map(np.asarray, gj["params"]))
    for name, want in gsd.items():
        got = gt[name].numpy()
        rel = np.linalg.norm(got - want.numpy()) / max(np.linalg.norm(want.numpy()), 1e-12)
        assert rel <= 1e-4, (name, rel)
