"""The port's DepthNet trainer (`vslam_tpu_torch.models.train_depthnet`)
against the JAX package's (`vslam_tpu.models.train_depthnet`), on the CPU.

- `render_dataset` (host numpy, the port's renderer): equal arrays.
- The learning rate of every step against `optax.warmup_cosine_decay_
  schedule` as `optax.adam` applies it (at the count before the update):
  within 1e-7 over the first 300 steps of a 300-step and a 2000-step run;
  the first update has lr 0 and leaves every parameter as it was.
- A short `train` from random init: the loss falls.
- `evaluate` on the committed checkpoint (4 images, bf16 in both): abs_rel
  within 2e-3 of JAX's, delta_1.25 within 0.01, rmse_log within 5e-3.
"""

import numpy as np
import pytest
import torch

import optax

from vslam_tpu.models import train_depthnet as j_tdn
from vslam_tpu.models import weights as j_w
from vslam_tpu_torch.models import train_depthnet as t_tdn
from vslam_tpu_torch.models import weights as t_w
from vslam_tpu_torch.ops import prng


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_render_dataset_equal():
    for jitter in (True, False):
        want = j_tdn.render_dataset(np.random.default_rng(2), 1, jitter=jitter)
        got = t_tdn.render_dataset(np.random.default_rng(2), 1, jitter=jitter)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(t_tdn._pose(np.random.default_rng(1), 8.0)[0],
                                  j_tdn._pose(np.random.default_rng(1), 8.0)[0])


@pytest.mark.parametrize("total", [300, 2000])
def test_lr_schedule_matches_optax(total):
    lr = 2e-3
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup_steps=min(200, total // 10),
                                               decay_steps=total, end_value=lr * 1e-2)
    init, _, _ = t_tdn.make_trainer(lr=lr, total_steps=total, device="cpu")
    state = init(seed=0)
    got = []
    for _ in range(300):
        got.append(state.opt.param_groups[0]["lr"])
        state.opt.step()  # no gradients: moves nothing, counts the step
        state.sched.step()
    want = np.array([float(sched(i)) for i in range(300)])
    np.testing.assert_allclose(np.array(got), want, atol=1e-7, rtol=0)
    assert got[0] == 0.0


def test_first_update_changes_nothing():
    rng = np.random.default_rng(0)
    gray = torch.from_numpy(rng.random((2, 32, 48, 1)).astype(np.float32))
    logd = torch.from_numpy(rng.normal(1.0, 0.3, (2, 8, 12)).astype(np.float32))
    valid = torch.from_numpy(rng.random((2, 8, 12)) > 0.2)
    init, step, _ = t_tdn.make_trainer(total_steps=100, height=32, width=48, device="cpu")
    state = init(seed=0)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, loss = step(state, gray, logd, valid, prng.prng_key(1))
    assert torch.isfinite(loss) and state.step == 1
    assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())
    state, _ = step(state, gray, logd, valid, prng.prng_key(2))
    assert not all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())


def test_short_training_run_lowers_the_loss():
    data = t_tdn.render_dataset(np.random.default_rng(0), 2)
    _, hist = t_tdn.train(steps=12, batch=2, seed=0, steps_per_scan=4, log=None, device="cpu",
                          dataset=data)
    assert len(hist) == 12 and np.isfinite(hist).all()
    assert np.mean(hist[-3:]) < np.mean(hist[:3]), hist


def test_evaluate_vs_jax():
    want = j_tdn.evaluate(j_w.depthnet_params_from_npz(t_w.TRAINED_DN_NPZ), n_images=4)
    got = t_tdn.evaluate(t_w.load_depthnet(device="cpu"), n_images=4)
    assert got["n_cells"] == want["n_cells"]
    assert abs(got["abs_rel"] - want["abs_rel"]) <= 2e-3, (got, want)
    assert abs(got["delta_1.25"] - want["delta_1.25"]) <= 0.01, (got, want)
    assert abs(got["rmse_log"] - want["rmse_log"]) <= 5e-3, (got, want)
