"""The port's SuperPoint trainer (`vslam_tpu_torch.models.train_superpoint`)
against the JAX package's, on the CPU: the optimizer, whole steps, the
training loops and the evaluation (the components are in
`tests/test_torch_train_superpoint.py`). Tolerances:
- one Adam update on equal gradients against `optax.adam`: 1e-6;
- one bf16 step through JAX's own `make_trainer` from the same Flax
  parameters and key: losses within 2e-2 relative (the frameworks round
  bf16 at other places), every parameter updated;
- the port's `train_synthetic(steps=12, batch=4, 64x80)`: the loss falls,
  by the criterion of `tests/test_training.py:33`;
- `make_epoch` on a dataset staged on the device: finite losses, one per
  step;
- `evaluate_detector` on the committed checkpoint (4 pairs): repeatability
  and match precision within 0.02 of JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from vslam_tpu.models import superpoint as j_sp
from vslam_tpu.models import train_superpoint as j_tsp
from vslam_tpu.models import weights as j_w
from vslam_tpu_torch.models import train_superpoint as t_tsp
from vslam_tpu_torch.models import weights as t_w
from vslam_tpu_torch.ops import prng


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(scope="module")
def flax_params():
    return j_sp.init_params(jax.random.PRNGKey(0), height=16, width=16)


@pytest.fixture(scope="module")
def batch():
    return j_tsp.synthetic_shapes_batch(np.random.default_rng(3), 2, 64, 80)


def test_adam_update_equals_optax():
    rng = np.random.default_rng(4)
    params = {"a": rng.normal(size=(64, 3, 3, 3)).astype(np.float32),
              "b": rng.normal(size=(17,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * s for k, v in params.items()}
             for s in (1.0, 1e-3)]
    tx = optax.adam(1e-3)
    pj = jax.tree.map(jnp.asarray, params)
    st = tx.init(pj)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = t_tsp.adam(list(tp.values()), 1e-3)
    for g in grads:
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, pj)
        pj = optax.apply_updates(pj, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(pj[k]), atol=1e-6, rtol=0)


def test_bf16_step_vs_jax_make_trainer(flax_params, batch):
    imgs, corners, cmask = batch
    init_j, step_j, _ = j_tsp.make_trainer(64, 80)
    state_j = j_tsp.TrainState(flax_params, optax.adam(1e-3).init(flax_params), jnp.asarray(0))
    _, mj = step_j(state_j, imgs, corners, cmask, jax.random.PRNGKey(5))
    init_t, step_t, _ = t_tsp.make_trainer(64, 80, device="cpu")
    state_t = init_t(params=t_w.superpoint_state_dict_from_flax(flax_params["params"]))
    before = {k: v.detach().clone() for k, v in state_t.model.state_dict().items()}
    state_t, mt = step_t(state_t, *_t(imgs, corners, cmask), prng.prng_key(5))
    for k in ("loss", "det", "desc"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=2e-2, err_msg=k)
    assert state_t.step == 1
    moved = [k for k, v in state_t.model.state_dict().items() if not torch.equal(v, before[k])]
    assert len(moved) == len(before)


def test_train_synthetic_loss_falls():
    _, hist = t_tsp.train_synthetic(steps=12, batch=4, height=64, width=80, seed=0,
                                    log_every=0, device="cpu")
    first = np.mean([h["loss"] for h in hist[:3]])
    last = np.mean([h["loss"] for h in hist[-3:]])
    assert np.isfinite(last)
    assert last < first, (first, last)
    assert hist[-1]["det"] < hist[0]["det"]


def test_make_epoch_runs_on_a_staged_dataset(batch):
    imgs, corners, cmask = (np.concatenate([a, a]) for a in batch)
    init, _, make_epoch = t_tsp.make_trainer(64, 80, device="cpu")
    state, ms = make_epoch(3, 2)(init(seed=1), *_t(imgs, corners, cmask), prng.prng_key(9))
    assert ms.shape == (3, 3) and torch.isfinite(ms).all() and state.step == 3


def test_evaluate_detector_vs_jax():
    """The committed checkpoint on 4 held-out pairs, bf16 in both."""
    params = j_w.superpoint_params_from_npz(t_w.TRAINED_SP_NPZ)
    want = j_tsp.evaluate_detector(params, n_pairs=4)
    got = t_tsp.evaluate_detector(t_w.load_superpoint(device="cpu"), n_pairs=4)
    for k in ("repeatability", "match_precision"):
        assert abs(got[k] - want[k]) <= 0.02, (k, got, want)
    assert got["repeatability"] > 0.5 and got["match_precision"] > 0.5
